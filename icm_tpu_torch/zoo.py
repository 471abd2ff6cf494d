"""Reference checkpoints: a reference CompressAI state dict -> the port's
state dict, and the coder tables the checkpoint stores.

Port of ``icm_tpu/zoo.py`` for the architectures the port builds (``cnn``,
``stf``, the zigzag family ``stf5``-``stf8``, the CRC family's
``stf9``, ``stf11``, ``stf12``, ``stf13`` and ``stf14``, the masked
family's ``stf2``, ``stf3`` and ``stf4``, ``czigzag``, and ``cnn2`` with its
RetinaNet student, whose torchvision ResNet and RetinaNet converters are
here too). ``load_pretrained`` does
the reference's key cleanup (``zoo/pretrained.py``: strip DataParallel's
``module.``, drop ``h_s.*``, rename the legacy bottleneck ParameterList
keys). The converters rename the reference's module paths into the flax
names the port's modules carry; the reference is NCHW PyTorch, as the
port is, so every tensor keeps its layout (the JAX package transposes conv
kernels to HWIO, flips transposed-conv kernels and transposes GDN gamma
and the dense kernels, and ``convert.from_jax_params`` undoes each of
those). The result is a float32 state dict that loads into the port's
model with ``load_state_dict(strict=True)``.

``import_reference_tables`` reads the CDF buffers a reference checkpoint
stores (``_quantized_cdf``, ``_offset``, ``_cdf_length``, filled by the
reference's ``update()``); given to ``CharmCodec(tables=..., ref_layout=
True)`` they make a one-image stream byte-identical to the reference
coder's (tables rebuilt from the learned density can differ by one CDF
step).

Nothing here imports the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from .entropy import EntropyTables, get_scale_table
from .models.base import CodecTables


def load_pretrained(state_dict: dict) -> dict:
    """Reference key cleanup: strip ``module.``, drop ``h_s.*``, rename
    ``_matrices.{i}`` -> ``_matrix{i}`` (and the biases and factors)."""
    out = {}
    for k, v in state_dict.items():
        k = k.removeprefix("module.")
        if k.startswith("h_s."):
            continue
        k = re.sub(r"_matrices\.(\d+)", r"_matrix\1", k)
        k = re.sub(r"_biases\.(\d+)", r"_bias\1", k)
        k = re.sub(r"_factors\.(\d+)", r"_factor\1", k)
        out[k] = v
    return out


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _leaves(sd, name: str) -> dict:
    """``{name}.weight`` and, where the reference has one, ``{name}.bias``
    (conv, transposed conv, dense and LayerNorm alike: the port keeps the
    reference's layouts)."""
    p = {"weight": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _gdn(sd, name):
    return {"beta": sd[f"{name}.beta"], "gamma": sd[f"{name}.gamma"]}


def _residual_unit(sd, prefix):
    return {f"Conv_{j}": _leaves(sd, f"{prefix}.conv.{2 * j}") for j in range(3)}


def _win_noshift(sd, prefix):
    p = {}
    for i in range(3):
        p[f"trunk{i}"] = _residual_unit(sd, f"{prefix}.conv_a.{i}")
        p[f"branch{i}"] = _residual_unit(sd, f"{prefix}.conv_b.{i + 1}")
    attn = f"{prefix}.conv_b.0.attn"
    p["win_attn"] = {"attn": {
        "qkv": _leaves(sd, f"{attn}.qkv"),
        "proj": _leaves(sd, f"{attn}.proj"),
        "relative_position_bias_table": sd[f"{attn}.relative_position_bias_table"],
    }}
    p["Conv_0"] = _leaves(sd, f"{prefix}.conv_b.4")
    return p


def _hyper_dec(sd, prefix):
    return {
        "Conv_0": _leaves(sd, f"{prefix}.0"),
        "SubpelConv_0": {"Conv_0": _leaves(sd, f"{prefix}.2.0")},
        "Conv_1": _leaves(sd, f"{prefix}.4"),
        "SubpelConv_1": {"Conv_0": _leaves(sd, f"{prefix}.6.0")},
        "Conv_2": _leaves(sd, f"{prefix}.8"),
    }


def _hyper(sd) -> dict:
    return {"h_a": {f"Conv_{i}": _leaves(sd, f"h_a.{2 * i}") for i in range(5)},
            "h_mean_s": _hyper_dec(sd, "h_mean_s"),
            "h_scale_s": _hyper_dec(sd, "h_scale_s")}


def _context(sd, n_slices: int, suffix: str = "", n_convs: int = 5) -> dict:
    """The per-slice conv stacks: reference ``cc_mean_transforms{suffix}.{i}``
    -> ``cc_mean_{i}`` (and the scale and LRP stacks)."""
    return {f"{ours}_{i}": {f"Conv_{j}": _leaves(sd, f"{tag}{suffix}.{i}.{2 * j}")
                            for j in range(n_convs)}
            for tag, ours in (("cc_mean_transforms", "cc_mean"),
                              ("cc_scale_transforms", "cc_scale"),
                              ("lrp_transforms", "lrp"))
            for i in range(n_slices)}


def _entropy_bottleneck(sd, prefix, n_filters=4):
    p = {"quantiles": sd[f"{prefix}.quantiles"]}
    for i in range(n_filters + 1):
        p[f"matrix{i}"] = sd[f"{prefix}._matrix{i}"]
        p[f"bias{i}"] = sd[f"{prefix}._bias{i}"]
        if i < n_filters:
            p[f"factor{i}"] = sd[f"{prefix}._factor{i}"]
    return p


def _swin_block(sd, prefix, cross: bool = False):
    """A Swin block; ``cross``: czigzag's (the reference's
    ``WindowAttention_context``: projections ``q`` and ``kv`` in place of
    ``qkv``)."""
    projections = ("q", "kv") if cross else ("qkv",)
    return {
        "LayerNorm_0": _leaves(sd, f"{prefix}.norm1"),
        "attn": {
            **{p: _leaves(sd, f"{prefix}.attn.{p}") for p in projections},
            "proj": _leaves(sd, f"{prefix}.attn.proj"),
            "relative_position_bias_table": sd[f"{prefix}.attn.relative_position_bias_table"],
        },
        "LayerNorm_1": _leaves(sd, f"{prefix}.norm2"),
        "mlp": {"Dense_0": _leaves(sd, f"{prefix}.mlp.fc1"),
                "Dense_1": _leaves(sd, f"{prefix}.mlp.fc2")},
    }


def _basic_layer(sd, prefix, depth, has_downsample, cross: bool = False):
    p = {f"block{j}": _swin_block(sd, f"{prefix}.blocks.{j}", cross) for j in range(depth)}
    if has_downsample:
        p["downsample"] = {
            "LayerNorm_0": _leaves(sd, f"{prefix}.downsample.norm"),
            "Dense_0": {"weight": sd[f"{prefix}.downsample.reduction.weight"]},
        }
    return p


def _swin_transforms(sd, depths) -> dict:
    """stf's analysis and synthesis (the reference's ``patch_embed``,
    ``layers``, ``syn_layers`` and ``end_conv``)."""
    n = len(depths)
    g_a = {"embed": {"Conv_0": _leaves(sd, "patch_embed.proj"),
                     "LayerNorm_0": _leaves(sd, "patch_embed.norm")}}
    for i in range(n):
        g_a[f"layer{i}"] = _basic_layer(sd, f"layers.{i}", depths[i], i < n - 1)
    rdepths = tuple(reversed(depths))
    g_s = {f"layer{i}": _basic_layer(sd, f"syn_layers.{i}", rdepths[i], i < n - 1)
           for i in range(n)}
    g_s["up"] = {"Conv_0": _leaves(sd, "end_conv.0")}
    g_s["to_rgb"] = _leaves(sd, "end_conv.2")
    return {"g_a": g_a, "g_s": g_s}


def _state_dict(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested port names -> flat ``a.b.weight`` keys, float32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_state_dict(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = torch.from_numpy(
                np.array(_np(value), dtype=np.float32, order="C"))
    return out


def convert_wacnn_checkpoint(state_dict: dict, num_slices: int = 10) -> Dict[str, torch.Tensor]:
    """Reference WACNN state dict -> the port's ``WACNN`` state dict."""
    return _state_dict(_wacnn_tree(load_pretrained(state_dict), num_slices))


def _wacnn_tree(sd: dict, num_slices: int = 10) -> dict:
    """WACNN's modules of a cleaned reference state dict, in port names."""
    return {
        # conv, GDN, conv, GDN, Win, conv, GDN, conv, Win
        "g_a": {
            "Conv_0": _leaves(sd, "g_a.0"), "GDN_0": _gdn(sd, "g_a.1"),
            "Conv_1": _leaves(sd, "g_a.2"), "GDN_1": _gdn(sd, "g_a.3"),
            "Win_noShift_Attention_0": _win_noshift(sd, "g_a.4"),
            "Conv_2": _leaves(sd, "g_a.5"), "GDN_2": _gdn(sd, "g_a.6"),
            "Conv_3": _leaves(sd, "g_a.7"),
            "Win_noShift_Attention_1": _win_noshift(sd, "g_a.8"),
        },
        # Win, deconv, GDN, deconv, GDN, Win, deconv, GDN, deconv
        "g_s": {
            "Win_noShift_Attention_0": _win_noshift(sd, "g_s.0"),
            "ConvTranspose_0": _leaves(sd, "g_s.1"), "GDN_0": _gdn(sd, "g_s.2"),
            "ConvTranspose_1": _leaves(sd, "g_s.3"), "GDN_1": _gdn(sd, "g_s.4"),
            "Win_noShift_Attention_1": _win_noshift(sd, "g_s.5"),
            "ConvTranspose_2": _leaves(sd, "g_s.6"), "GDN_2": _gdn(sd, "g_s.7"),
            "ConvTranspose_3": _leaves(sd, "g_s.8"),
        },
        **_hyper(sd),
        **_context(sd, num_slices),
        "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck"),
    }


# --- task networks (the reference's torchvision ResNet and RetinaNet) ---------


def _batchnorm(sd, name: str) -> dict:
    """torch BatchNorm2d -> the port's ``FrozenBatchNorm2d``: weight and
    bias, the running statistics as ``mean`` and ``var``
    (``num_batches_tracked`` is not read)."""
    return {"weight": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"],
            "mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]}


def _resnet_tree(sd, block: str = "bottleneck", layers=(3, 4, 6, 3)) -> dict:
    """torchvision ResNet names -> the port's ``ResNetBackbone``: stem
    ``conv1`` / ``bn1`` -> ``Conv_0`` / ``BatchNorm_0``; ``layer{L}.{i}.conv{k}``
    / ``bn{k}`` -> ``layer{L}_{i}.Conv_{k-1}`` / ``BatchNorm_{k-1}``;
    ``downsample.0`` / ``.1`` -> the block's last slot (``Conv_2`` for a
    basic block, ``Conv_3`` for a bottleneck)."""
    n_convs = 2 if block == "basic" else 3
    tree = {"Conv_0": {"weight": sd["conv1.weight"]}, "BatchNorm_0": _batchnorm(sd, "bn1")}
    for L, reps in enumerate(layers, start=1):
        for i in range(reps):
            ref = f"layer{L}.{i}"
            node = {}
            for k in range(n_convs):
                node[f"Conv_{k}"] = {"weight": sd[f"{ref}.conv{k + 1}.weight"]}
                node[f"BatchNorm_{k}"] = _batchnorm(sd, f"{ref}.bn{k + 1}")
            if f"{ref}.downsample.0.weight" in sd:
                node[f"Conv_{n_convs}"] = {"weight": sd[f"{ref}.downsample.0.weight"]}
                node[f"BatchNorm_{n_convs}"] = _batchnorm(sd, f"{ref}.downsample.1")
            tree[f"layer{L}_{i}"] = node
    return tree


def convert_torchvision_resnet(state_dict: dict, block: str = "bottleneck",
                               layers=(3, 4, 6, 3)) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> the port's ``ResNetBackbone``
    state dict (port of ``icm_tpu/utils/torch_weights.py::
    convert_torchvision_resnet``; ``fc`` is not read)."""
    return _state_dict(_resnet_tree(state_dict, block, layers))


def _retinanet_tree(sd, prefix: str = "") -> dict:
    """The reference RetinaNet (``retinanet/model.py``: a torchvision
    backbone, ``fpn.P3_1`` ... ``fpn.P7_2``, ``regressionModel`` and
    ``classificationModel`` with ``conv1``-``conv4`` and ``output``) ->
    the port's ``RetinaNet`` names."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def head(ref):
        return {name: _leaves(sd, f"{ref}.{name}")
                for name in ("conv1", "conv2", "conv3", "conv4", "output")}

    return {
        "backbone": _resnet_tree(sd),
        "fpn": {name: _leaves(sd, f"fpn.{name}")
                for name in ("P5_1", "P5_2", "P4_1", "P4_2", "P3_1", "P3_2", "P6", "P7_2")},
        "regression": head("regressionModel"),
        "classification": head("classificationModel"),
    }


def convert_retinanet_state(state_dict: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference RetinaNet's state dict (its keys under ``prefix``) ->
    the port's ``RetinaNet`` state dict (port of ``icm_tpu/utils/
    torch_weights.py::convert_retinanet_state``: ResNet-50 backbone)."""
    return _state_dict(_retinanet_tree(state_dict, prefix))


def convert_cnn2_checkpoint(state_dict: dict) -> Dict[str, torch.Tensor]:
    """Reference WACNN2 (``cnn2``) state dict -> the port's ``WACNN2``
    state dict (port of the JAX package's ``convert_cnn2_checkpoint``): the
    codec's keys as WACNN's, the trained RetinaNet student
    (``studentNet.*``) as :func:`convert_retinanet_state`'s. The frozen
    ``teacherNet.*`` (the reference's external pretrained detector) and
    BatchNorm's ``num_batches_tracked`` are dropped."""
    sd = load_pretrained(state_dict)
    tree = _wacnn_tree(sd)
    tree["studentNet"] = _retinanet_tree(sd, prefix="studentNet.")
    return _state_dict(tree)


def convert_stf_checkpoint(state_dict: dict, depths=(2, 2, 6, 2),
                           num_slices: int = 12) -> Dict[str, torch.Tensor]:
    """Reference SymmetricalTransFormer state dict -> the port's ``stf``."""
    sd = load_pretrained(state_dict)
    tree = {**_swin_transforms(sd, depths), **_hyper(sd), **_context(sd, num_slices),
            "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck")}
    return _state_dict(tree)


def convert_zigzag_checkpoint(state_dict: dict, *, depths=(2, 2, 6, 2), ctx_slices: int,
                              cc_suffix: str = "", refiners: Optional[dict] = None,
                              refiner_suffix: str = "",
                              num_cc_convs: int = 5) -> Dict[str, torch.Tensor]:
    """Reference stf5-stf8 state dict -> the port's ``ZigzagSwinCodec``.

    The transforms and hyper-codec map as stf's; the per-slice context
    stacks are ``cc_*_transforms{cc_suffix}``; the refiners
    ``mu_Swin{refiner_suffix}.{i}.{j}`` (and ``sigma_Swin``, ``LRP_Swin``),
    the j-th Swin layer of slice i, become ``mu_refine_{i}.stage{j}``.
    ``refiners`` maps each enabled refiner (``mu_refine``,
    ``sigma_refine``, ``lrp_refine``) to its depths; stf6 builds sigma and
    LRP refiners that its forward never runs, and their tensors are
    dropped."""
    sd = load_pretrained(state_dict)
    tree = {**_swin_transforms(sd, depths), **_hyper(sd),
            **_context(sd, ctx_slices, cc_suffix, num_cc_convs)}
    ref_tags = {"mu_refine": "mu_Swin", "sigma_refine": "sigma_Swin", "lrp_refine": "LRP_Swin"}
    for tag, rdepths in (refiners or {}).items():
        for i in range(ctx_slices):
            tree[f"{tag}_{i}"] = {
                f"stage{j}": _basic_layer(sd, f"{ref_tags[tag]}{refiner_suffix}.{i}.{j}", d,
                                          has_downsample=False)
                for j, d in enumerate(rdepths)}
    tree["entropy_bottleneck"] = _entropy_bottleneck(sd, "entropy_bottleneck")
    return _state_dict(tree)


ZIGZAG_CONVERT_CONFIGS = {
    # reference stf5.py: 12 slices, full refiners (2, 6, 2, 2)
    "stf5": dict(ctx_slices=12, refiners={"mu_refine": (2, 6, 2, 2),
                                          "sigma_refine": (2, 6, 2, 2),
                                          "lrp_refine": (2, 6, 2, 2)}),
    # reference stf6.py (cc_*_transforms2): only the mu refiner runs
    "stf6": dict(ctx_slices=24, cc_suffix="2", refiners={"mu_refine": (2, 6, 2, 2)}),
    # reference stf7.py: light refiners, 12 slices
    "stf7": dict(ctx_slices=12, refiners={"mu_refine": (2, 6), "sigma_refine": (2, 2),
                                          "lrp_refine": (2, 6)}),
    # reference stf8.py: *_Swin2 tags, 24 zigzag slices
    "stf8": dict(ctx_slices=24, cc_suffix="2", refiner_suffix="2",
                 refiners={"mu_refine": (2, 6), "sigma_refine": (2, 2),
                           "lrp_refine": (2, 6)}),
}
ZIGZAG_CONVERT_CONFIGS["stf6_2"] = ZIGZAG_CONVERT_CONFIGS["stf6"]

# --- the CRC family (stf9, stf11, stf12, stf13, stf14) ------------------------------
# The reference's module layouts (stf9.py, stf12.py, stf13.py, stf14.py); its dead
# groups are dropped: the Swin scaffolding pasted into these models (patch_embed,
# layers, syn_layers, end_conv), the LRP stacks whose output the forward
# discards (stf9.py:1094-1106; stf13 applies its LRP and keeps them), the
# commented-out LRP refiners, stf14's unused context decoder (stf14.py:1153)
# and stf13's unused split decoder g_s1 / g_s2 (stf13.py:539).

def _stack(sd, prefix: str, n: int, kind: str = "Conv") -> dict:
    """``n`` convs (``kind="ConvTranspose"``: transposed convs) at the
    reference's even indexes, activations between."""
    return {f"{kind}_{j}": _leaves(sd, f"{prefix}.{2 * j}") for j in range(n)}


def _main_cnn_decoder(sd, prefix: str, part: Optional[int] = None) -> dict:
    """The reference's mainCNNdecoder (Win, deconv, GDN, deconv, GDN, Win,
    deconv, GDN, deconv), or its first (``part=1``: through the second
    Win) or second half (``part=2``: deconv, GDN, deconv)."""
    first = {} if part == 2 else {
        "Win_noShift_Attention_0": _win_noshift(sd, f"{prefix}.0"),
        "ConvTranspose_0": _leaves(sd, f"{prefix}.1"), "GDN_0": _gdn(sd, f"{prefix}.2"),
        "ConvTranspose_1": _leaves(sd, f"{prefix}.3"), "GDN_1": _gdn(sd, f"{prefix}.4"),
        "Win_noShift_Attention_1": _win_noshift(sd, f"{prefix}.5"),
    }
    if part == 1:
        return first
    o, k = (0, 0) if part == 2 else (6, 2)
    return {**first, f"ConvTranspose_{k}": _leaves(sd, f"{prefix}.{o}"),
            f"GDN_{k}": _gdn(sd, f"{prefix}.{o + 1}"),
            f"ConvTranspose_{k + 1}": _leaves(sd, f"{prefix}.{o + 2}")}


def _main_cnn_encoder(sd, prefix: str) -> dict:
    """The reference's mainCNNencoder: WACNN's g_a."""
    return {
        "Conv_0": _leaves(sd, f"{prefix}.0"), "GDN_0": _gdn(sd, f"{prefix}.1"),
        "Conv_1": _leaves(sd, f"{prefix}.2"), "GDN_1": _gdn(sd, f"{prefix}.3"),
        "Win_noShift_Attention_0": _win_noshift(sd, f"{prefix}.4"),
        "Conv_2": _leaves(sd, f"{prefix}.5"), "GDN_2": _gdn(sd, f"{prefix}.6"),
        "Conv_3": _leaves(sd, f"{prefix}.7"),
        "Win_noShift_Attention_1": _win_noshift(sd, f"{prefix}.8"),
    }


def _context_scale2(sd, prefix: str) -> dict:
    """The reference's mainCNNcontextScale2: Win, 3x3 deconv, IGDN, 3x3
    deconv."""
    return {"Win_noShift_Attention_0": _win_noshift(sd, f"{prefix}.0"),
            "ConvTranspose_0": _leaves(sd, f"{prefix}.1"), "GDN_0": _gdn(sd, f"{prefix}.2"),
            "ConvTranspose_1": _leaves(sd, f"{prefix}.3")}


def _zigzag_coder(sd, prefix: str = "", eb_key: str = "entropy_bottleneck",
                  ctx_slices: int = 24, n_convs: int = 5, lrp: bool = False) -> dict:
    """An inline zigzag coder (``{prefix}h_a``, ``{prefix}h_mean_s``, ...,
    ``{prefix}cc_*_transforms2``, with ``lrp``: ``{prefix}lrp_transforms2``)
    -> the port's ``ZigzagCharmCoder`` tree."""
    coder = {"h_a": _stack(sd, f"{prefix}h_a", 5), "h_mean_s": _hyper_dec(sd, f"{prefix}h_mean_s"),
             "h_scale_s": _hyper_dec(sd, f"{prefix}h_scale_s"),
             "entropy_bottleneck": _entropy_bottleneck(sd, eb_key)}
    tags = (("cc_mean_transforms2", "cc_mean"), ("cc_scale_transforms2", "cc_scale"))
    for tag, ours in tags + ((("lrp_transforms2", "lrp"),) if lrp else ()):
        for i in range(ctx_slices):
            coder[f"{ours}_{i}"] = _stack(sd, f"{prefix}{tag}.{i}", n_convs)
    return coder


def _stf13_layers(sd) -> dict:
    """stf13's decoder, segmentation layer and human layer (stf13.py): the
    machine decoder ``g_s``; ``seg_g_enc2`` (a mainCNNdecoder) and
    ``seg_g_enc3`` (mainCNNcontextScale2), the ``seg_``-prefixed coder
    with its LRP, ``seg_g_a1`` / ``seg_g_a2`` and ``seg_g_s``; the four
    conditioning decoders ``human_g_enc2``-``5``, the hyperprior with its
    deconv-style decoders (``human_h_mean_s_2``, ``human_h_scale_s_2``),
    the 2-conv context decoders ``human_context_decoder`` / ``3``, the
    encoder ``human_g_a1_2`` / ``human_g_a2_2``, the mask nets
    ``generate_mask_scale1`` / ``2``, the deconv context decoders
    ``human_context_decoder2_2`` / ``4`` and the decoder ``human_g_s1_2``
    / ``human_g_s2_2``."""
    def deconv_context(prefix):
        return {"Conv_0": _leaves(sd, f"{prefix}.0"),
                "ConvTranspose_0": _leaves(sd, f"{prefix}.2"),
                "ConvTranspose_1": _leaves(sd, f"{prefix}.4")}

    tree = {
        "g_s": _main_cnn_decoder(sd, "g_s"),
        "seg_g_enc2": {"MainCNNDecoder_0": _main_cnn_decoder(sd, "seg_g_enc2")},
        "seg_g_enc3": _context_scale2(sd, "seg_g_enc3"),
        "seg_coder": _zigzag_coder(sd, "seg_", "entropy_bottleneck_seg", n_convs=3, lrp=True),
        "seg_g_s": _main_cnn_decoder(sd, "seg_g_s"),
        "human_hyper": {
            "h_a": _stack(sd, "human_h_a", 5),
            "h_mean_s": deconv_context("human_h_mean_s_2"),
            "h_scale_s": deconv_context("human_h_scale_s_2"),
            "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck_human"),
        },
        "seg_g_a1": _stack(sd, "seg_g_a1", 2),
        "seg_g_a2": {**_stack(sd, "seg_g_a2", 2),
                     "Win_noShift_Attention_0": _win_noshift(sd, "seg_g_a2.4")},
        "human_g_a1_2": _stack(sd, "human_g_a1_2", 2),
        "human_g_a2_2": _stack(sd, "human_g_a2_2", 2),
        "human_g_s1_2": _stack(sd, "human_g_s1_2", 2, kind="ConvTranspose"),
        "human_g_s2_2": {"ConvTranspose_0": _leaves(sd, "human_g_s2_2.0"),
                         "Conv_0": _leaves(sd, "human_g_s2_2.2"),
                         "ConvTranspose_1": _leaves(sd, "human_g_s2_2.4")},
    }
    for name in ("human_g_enc2", "human_g_enc4"):
        tree[name] = {"MainCNNDecoder_0": _main_cnn_decoder(sd, name)}
    for name in ("human_g_enc3", "human_g_enc5"):
        tree[name] = _context_scale2(sd, name)
    for name in ("human_context_decoder", "human_context_decoder3"):
        tree[name] = _stack(sd, name, 2)
    for name in ("generate_mask_scale1", "generate_mask_scale2"):
        tree[name] = _stack(sd, name, 3)
    for name in ("human_context_decoder2_2", "human_context_decoder4"):
        tree[name] = deconv_context(name)
    return tree


def _human_hyper_dec(sd, prefix: str, extra: int = 5) -> dict:
    """The hyper-decoder and its ``extra`` trailing convs (reference
    indexes 10, 12, ...)."""
    p = _hyper_dec(sd, prefix)
    for j in range(extra):
        p[f"Conv_{3 + j}"] = _leaves(sd, f"{prefix}.{10 + 2 * j}")
    return p


def convert_crc_checkpoint(state_dict: dict, arch: str = "stf9",
                           ctx_slices: int = 24) -> Dict[str, torch.Tensor]:
    """Reference stf9 / stf11 / stf12 / stf13 / stf14 state dict -> the
    port's ``ConditionalResidualCoding`` / ``ConditionalResidualCoding2`` /
    ``ConditionalResidualCoding3`` / ``ResidualCoding`` state dict: the
    machine layer's ``g_a`` and zigzag coder (``cc_*_transforms2``, 5
    convs a slice, no LRP; stf13: 3 convs and the ``lrp_transforms2`` its
    forward applies), the split decoder, the human layer's hyperprior
    (``human_h_*``, ``entropy_bottleneck_human``) and transforms: stf9's
    and stf14's, with stf9's (and stf11's) context decoder; or stf12's
    conditioning decoders (``human_g_enc2``, a whole mainCNNdecoder;
    ``human_g_enc3``, mainCNNcontextScale2), its two-stage encoder and
    decoder and its two context decoders (3 convs, and 2 convs with 2
    sub-pixel convs); or stf13's decoder and layers
    (:func:`_stf13_layers`)."""
    if arch not in CRC_ARCHS:
        raise ValueError(f"{arch!r} is not one of {CRC_ARCHS}")
    sd = load_pretrained(state_dict)
    stf13 = arch == "stf13"
    coder = _zigzag_coder(sd, ctx_slices=ctx_slices, n_convs=3 if stf13 else 5, lrp=stf13)
    machine = {"g_a": _main_cnn_encoder(sd, "g_a"), "coder": coder}
    if stf13:
        return _state_dict({"machine": machine, **_stf13_layers(sd)})
    tree = {
        "machine": machine,
        "g_s1": _main_cnn_decoder(sd, "g_s1", part=1),
        "g_s2": _main_cnn_decoder(sd, "g_s2", part=2),
        "human_hyper": {
            "h_a": _stack(sd, "human_h_a", 5),
            "h_mean_s": _human_hyper_dec(sd, "human_h_mean_s"),
            "h_scale_s": _human_hyper_dec(sd, "human_h_scale_s"),
            "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck_human"),
        },
    }
    if arch == "stf12":
        tree.update({
            "human_g_enc2": {"MainCNNDecoder_0": _main_cnn_decoder(sd, "human_g_enc2")},
            "human_g_enc3": _context_scale2(sd, "human_g_enc3"),
            "human_context_decoder": _stack(sd, "human_context_decoder", 3),
            "human_g_a1": _stack(sd, "human_g_a1", 2),
            "human_g_a2": {**_stack(sd, "human_g_a2", 2),
                           "Win_noShift_Attention_0": _win_noshift(sd, "human_g_a2.4")},
            "human_g_s1": {"Win_noShift_Attention_0": _win_noshift(sd, "human_g_s1.0"),
                           "ConvTranspose_0": _leaves(sd, "human_g_s1.2"),
                           "ConvTranspose_1": _leaves(sd, "human_g_s1.4")},
            "human_g_s2": {"ConvTranspose_0": _leaves(sd, "human_g_s2.0"),
                           "Conv_0": _leaves(sd, "human_g_s2.2"),
                           "ConvTranspose_1": _leaves(sd, "human_g_s2.4")},
            "human_context_decoder2": {
                **_stack(sd, "human_context_decoder2", 2),
                "SubpelConv_0": {"Conv_0": _leaves(sd, "human_context_decoder2.4.0")},
                "SubpelConv_1": {"Conv_0": _leaves(sd, "human_context_decoder2.6.0")}},
        })
        return _state_dict(tree)
    tree["human_g_s2"] = _main_cnn_decoder(sd, "human_g_s2")
    tree["human_g_a"] = _stack(sd, "human_g_a", 4)
    tree["human_g_s"] = _stack(sd, "human_g_s", 4, kind="ConvTranspose")
    if arch != "stf14":
        tree["human_context_decoder"] = _stack(sd, "human_context_decoder", 5)
    return _state_dict(tree)


CRC_ARCHS = ("stf9", "stf11", "stf12", "stf13", "stf14")

# --- the masked-transformer codecs (stf2, stf3, stf4) -------------------------------
# The reference's layouts (stf2.py, stf3.py, stf4.py): stf's Swin transforms
# and conv hyper-codec under their stf names; stf4's never-called
# maskedContextModel_sigma is dropped (its forward takes mu and scale from the
# mu context), and so are stf2's conv transforms g_a / g_s (its forward runs
# the Swin ones; the pair feeds only the reference's stale compress path).


def convert_masked_ctx_checkpoint(state_dict: dict, arch: str) -> Dict[str, torch.Tensor]:
    """Reference stf2 / stf3 / stf4 state dict -> the port's ``ClipEncoder``
    / ``ClipEncoder3`` / ``ClipEncoder4`` state dict (port of the JAX
    package's ``convert_masked_ctx_checkpoint`` with
    ``_stf_transforms_tree``): the transforms and hyper-codec as stf's;
    stf2's two attentions (``muContextModel.qkv``, ``sigmaContextModel.qkv``)
    and three conv heads (``cc_mean_transforms``, ``cc_scale_transforms``,
    ``lrp_transforms``, 4 convs each -> ``cc_mean_head``, ``cc_scale_head``,
    ``lrp_head``); stf3's two context stacks
    (``maskedContextModel_{mu,sigma}.context{i}.qkv``, ``.norm{i}``,
    ``.mlp{i}.fc1`` / ``fc2`` for blocks 1-5 -> ``attn{i-1}.qkv``,
    ``LayerNorm_{i-1}``, ``Dense_{2i-2}`` / ``Dense_{2i-1}``); stf4's one
    attention (``maskedContextModel_mu.0.qkv``) and its conv heads
    (``cc_mean_transforms``, ``cc_scale_transforms``, 4 convs); the LRP
    stack (``lrp_transforms``, 4 convs)."""
    if arch not in MASKED_ARCHS:
        raise ValueError(f"{arch!r} is not one of {MASKED_ARCHS}")
    sd = load_pretrained(state_dict)
    tree = {**_swin_transforms(sd, (2, 2, 6, 2)), **_hyper(sd),
            "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck")}
    if arch == "stf2":
        for tag in ("muContextModel", "sigmaContextModel"):
            tree[tag] = {"qkv": _leaves(sd, f"{tag}.qkv")}
        for ref_tag, ours in (("cc_mean_transforms", "cc_mean_head"),
                              ("cc_scale_transforms", "cc_scale_head"),
                              ("lrp_transforms", "lrp_head")):
            tree[ours] = _stack(sd, ref_tag, 4)
        return _state_dict(tree)
    if arch == "stf3":
        for tag in ("maskedContextModel_mu", "maskedContextModel_sigma"):
            ctx = {}
            for i in range(5):
                ctx[f"attn{i}"] = {"qkv": _leaves(sd, f"{tag}.context{i + 1}.qkv")}
                ctx[f"LayerNorm_{i}"] = _leaves(sd, f"{tag}.norm{i + 1}")
                ctx[f"Dense_{2 * i}"] = _leaves(sd, f"{tag}.mlp{i + 1}.fc1")
                ctx[f"Dense_{2 * i + 1}"] = _leaves(sd, f"{tag}.mlp{i + 1}.fc2")
            tree[tag] = ctx
    else:
        tree["maskedContextModel_mu"] = {"qkv": _leaves(sd, "maskedContextModel_mu.0.qkv")}
        tree["cc_mean_head"] = _stack(sd, "cc_mean_transforms", 4)
        tree["cc_scale_head"] = _stack(sd, "cc_scale_transforms", 4)
    tree["lrp"] = _stack(sd, "lrp_transforms", 4)
    return _state_dict(tree)


MASKED_ARCHS = ("stf2", "stf3", "stf4")


# --- czigzag, the cross-attention conditional codec ----------------------------------
# The reference's layout (czigzag.py:472-1360). Dropped as the JAX converter
# drops them, modules its forward never runs: ``patch_embed_up`` (up_x4 goes
# through the shared ``patch_embed``), ``decoder_context`` (the forward
# applies ``hyper_context`` to the decoder's pyramid too, so the port's
# ``decoder_context_{i}`` take ``hyper_context.{i}``'s weights), each
# pyramid's fourth conv (the loops run n - 1 stages), the commented-out
# refiners ``mu_Swin2`` / ``sigma_Swin2`` / ``LRP_Swin2`` and the conv
# hyper-codec ``h_a`` / ``h_mean_s`` / ``h_scale_s`` of the stale coder.


def convert_czigzag_checkpoint(state_dict: dict, depths=(2, 2, 6, 2), hyper_depths=(2, 6),
                               ctx_slices: int = 16) -> Dict[str, torch.Tensor]:
    """Reference conditionalZigzag state dict -> the port's
    ``conditionalZigzag`` state dict (port of the JAX package's
    ``convert_czigzag_checkpoint``): the shared patch embedding, the cross
    Swin stages (``layers``, ``syn_layers``; ``q``, ``kv``, ``proj``), the
    analysis and hyper pyramids (``encoder_context``, ``hyper_context``,
    whose weights serve ``decoder_context_{i}`` too), the hyper stacks
    (``hyper_encoder_layers``, ``hyper_decoder_{mean,scale}``) and their
    convolutions, ``end_conv``, the 16 slices' context stacks
    (``cc_*_transforms2``, ``lrp_transforms2``, 5 convs each) and the
    bottleneck."""
    sd = load_pretrained(state_dict)
    n = len(depths)
    rdepths = tuple(reversed(depths))
    tree = {"patch_embed": {"Conv_0": _leaves(sd, "patch_embed.proj"),
                            "LayerNorm_0": _leaves(sd, "patch_embed.norm")}}
    for i in range(n):
        tree[f"layer{i}"] = _basic_layer(sd, f"layers.{i}", depths[i], i < n - 1, cross=True)
        tree[f"syn_layer{i}"] = _basic_layer(sd, f"syn_layers.{i}", rdepths[i], i < n - 1,
                                             cross=True)
    for i in range(n - 1):
        tree[f"encoder_context_{i}"] = _leaves(sd, f"encoder_context.{i}")
        tree[f"hyper_context_{i}"] = _leaves(sd, f"hyper_context.{i}")
        tree[f"decoder_context_{i}"] = _leaves(sd, f"hyper_context.{i}")
    for k in range(2):
        tree[f"hyper_enc{k}"] = _basic_layer(sd, f"hyper_encoder_layers.{k}", hyper_depths[k],
                                             False, cross=True)
    for ours, ref in (("conv1", "Conv1"), ("conv1_2", "Conv1_2"), ("conv2", "Conv2")):
        tree[f"hyper_encoder_{ours}"] = _leaves(sd, f"hyper_encoder_{ref}")
    for tag in ("mean", "scale"):
        for k in range(2):
            tree[f"hyper_dec_{tag}{k}"] = _basic_layer(sd, f"hyper_decoder_{tag}.{k}",
                                                       hyper_depths[k], False, cross=True)
        tree[f"hyper_decoder_conv_{tag}1"] = {
            "Conv_0": _leaves(sd, f"hyper_decoder_conv_{tag}1.0")}
        tree[f"hyper_decoder_conv_{tag}2"] = _leaves(sd, f"hyper_decoder_conv_{tag}2")
    tree["end_up"] = {"Conv_0": _leaves(sd, "end_conv.0")}
    tree["end_to_rgb"] = _leaves(sd, "end_conv.2")
    tree.update(_context(sd, ctx_slices, "2"))
    tree["entropy_bottleneck"] = _entropy_bottleneck(sd, "entropy_bottleneck")
    return _state_dict(tree)


# the zoo's other architectures: the port does not build them yet
_NOT_PORTED = {a: "Queue 1 item 1 (ICM)" for a in ("stf10", "oj_ICM", "seg_oj_ICM")}


def convert_reference_state_dict(arch: str, sd: dict) -> Dict[str, torch.Tensor]:
    """Dispatch a reference state dict to the architecture's converter."""
    if arch == "cnn":
        return convert_wacnn_checkpoint(sd)
    if arch == "stf":
        return convert_stf_checkpoint(sd)
    if arch in ZIGZAG_CONVERT_CONFIGS:
        return convert_zigzag_checkpoint(sd, **ZIGZAG_CONVERT_CONFIGS[arch])
    if arch in CRC_ARCHS:
        return convert_crc_checkpoint(sd, arch)
    if arch in MASKED_ARCHS:
        return convert_masked_ctx_checkpoint(sd, arch)
    if arch == "czigzag":
        return convert_czigzag_checkpoint(sd)
    if arch == "cnn2":
        return convert_cnn2_checkpoint(sd)
    where = _NOT_PORTED.get(arch, "no item: not an architecture of the zoo")
    raise NotImplementedError(
        f"reference checkpoint conversion for {arch!r} is not ported yet (ROADMAP.md, {where})")


def load_reference_checkpoint(arch: str, path: str) -> Dict[str, torch.Tensor]:
    """A reference torch checkpoint (a state dict, or a dict holding one
    under ``state_dict``) -> the port's state dict for ``arch``. Pair with
    :func:`import_reference_tables` on the same dict for the stored CDFs."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_reference_state_dict(
        arch, {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


def import_reference_tables(state_dict: dict) -> Optional[CodecTables]:
    """Coder tables from the CDF buffers a reference checkpoint stores, or
    None when it has none (or only empty ones: a training checkpoint
    saved before ``update()``). The Gaussian's scale table is the stored
    one, else the default."""
    sd = load_pretrained(state_dict)

    def tables_for(prefix):
        q = sd.get(f"{prefix}._quantized_cdf")
        if q is None or _np(q).size == 0:
            return None
        return EntropyTables(
            quantized_cdf=_np(q).astype(np.int32),
            cdf_length=_np(sd[f"{prefix}._cdf_length"]).astype(np.int32),
            offset=_np(sd[f"{prefix}._offset"]).astype(np.int32),
        )

    bottlenecks = {}
    gaussian = scale_table = None
    for key in sd:
        if not key.endswith("._quantized_cdf"):
            continue
        prefix = key[: -len("._quantized_cdf")]
        t = tables_for(prefix)
        if t is None:
            continue
        if "gaussian" in prefix.rsplit(".", 1)[-1]:
            gaussian = t
            st = sd.get(f"{prefix}.scale_table")
            scale_table = (_np(st).astype(np.float32) if st is not None and _np(st).size
                           else get_scale_table())
        else:
            bottlenecks[prefix] = t
    if gaussian is None and not bottlenecks:
        return None
    return CodecTables(gaussian=gaussian, scale_table=scale_table, bottlenecks=bottlenecks)
