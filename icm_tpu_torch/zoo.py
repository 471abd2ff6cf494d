"""Reference checkpoints: a reference CompressAI state dict -> the port's
state dict, and the coder tables the checkpoint stores.

Port of ``icm_tpu/zoo.py`` for the architectures the port builds (``cnn``,
``stf``, the zigzag family ``stf5``-``stf8`` and the CRC family's
``stf9``, ``stf11`` and ``stf14``). ``load_pretrained`` does
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


def _swin_block(sd, prefix):
    return {
        "LayerNorm_0": _leaves(sd, f"{prefix}.norm1"),
        "attn": {
            "qkv": _leaves(sd, f"{prefix}.attn.qkv"),
            "proj": _leaves(sd, f"{prefix}.attn.proj"),
            "relative_position_bias_table": sd[f"{prefix}.attn.relative_position_bias_table"],
        },
        "LayerNorm_1": _leaves(sd, f"{prefix}.norm2"),
        "mlp": {"Dense_0": _leaves(sd, f"{prefix}.mlp.fc1"),
                "Dense_1": _leaves(sd, f"{prefix}.mlp.fc2")},
    }


def _basic_layer(sd, prefix, depth, has_downsample):
    p = {f"block{j}": _swin_block(sd, f"{prefix}.blocks.{j}") for j in range(depth)}
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
    sd = load_pretrained(state_dict)
    tree = {
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

# --- the CRC family (stf9, stf11, stf14) -------------------------------------------
# The reference's module layouts (stf9.py, stf14.py); its dead groups are
# dropped: the Swin scaffolding pasted into these models (patch_embed,
# layers, syn_layers, end_conv), the LRP stacks whose output the forward
# discards (stf9.py:1094-1106), the commented-out LRP refiners, and stf14's
# unused context decoder (stf14.py:1153).

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


def _human_hyper_dec(sd, prefix: str, extra: int = 5) -> dict:
    """The hyper-decoder and its ``extra`` trailing convs (reference
    indexes 10, 12, ...)."""
    p = _hyper_dec(sd, prefix)
    for j in range(extra):
        p[f"Conv_{3 + j}"] = _leaves(sd, f"{prefix}.{10 + 2 * j}")
    return p


def convert_crc_checkpoint(state_dict: dict, arch: str = "stf9",
                           ctx_slices: int = 24) -> Dict[str, torch.Tensor]:
    """Reference stf9 / stf11 / stf14 state dict -> the port's
    ``ConditionalResidualCoding`` / ``ResidualCoding`` state dict: the
    machine layer's ``g_a`` and zigzag coder (``cc_*_transforms2``, 5 convs
    a slice, no LRP), the split decoder, the human layer's transforms,
    hyperprior (``human_h_*``, ``entropy_bottleneck_human``) and, for
    stf9 and stf11, its context decoder."""
    if arch not in ("stf9", "stf11", "stf14"):
        raise ValueError(f"{arch!r} is not stf9, stf11 or stf14")
    sd = load_pretrained(state_dict)
    coder = {"h_a": _stack(sd, "h_a", 5), "h_mean_s": _hyper_dec(sd, "h_mean_s"),
             "h_scale_s": _hyper_dec(sd, "h_scale_s"),
             "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck")}
    for tag, ours in (("cc_mean_transforms2", "cc_mean"), ("cc_scale_transforms2", "cc_scale")):
        for i in range(ctx_slices):
            coder[f"{ours}_{i}"] = _stack(sd, f"{tag}.{i}", 5)
    tree = {
        "machine": {"g_a": _main_cnn_encoder(sd, "g_a"), "coder": coder},
        "g_s1": _main_cnn_decoder(sd, "g_s1", part=1),
        "g_s2": _main_cnn_decoder(sd, "g_s2", part=2),
        "human_g_s2": _main_cnn_decoder(sd, "human_g_s2"),
        "human_g_a": _stack(sd, "human_g_a", 4),
        "human_g_s": _stack(sd, "human_g_s", 4, kind="ConvTranspose"),
        "human_hyper": {
            "h_a": _stack(sd, "human_h_a", 5),
            "h_mean_s": _human_hyper_dec(sd, "human_h_mean_s"),
            "h_scale_s": _human_hyper_dec(sd, "human_h_scale_s"),
            "entropy_bottleneck": _entropy_bottleneck(sd, "entropy_bottleneck_human"),
        },
    }
    if arch != "stf14":
        tree["human_context_decoder"] = _stack(sd, "human_context_decoder", 5)
    return _state_dict(tree)


# the zoo's other architectures: the port does not build them yet
_NOT_PORTED = {
    "stf12": "Queue 1 item 5b (stf12)",
    "stf13": "Queue 1 item 5c (stf13)",
    **{a: "Queue 1 item 6 (the masked family)" for a in ("stf2", "stf3", "stf4")},
    "czigzag": "Queue 1 item 7 (czigzag)",
    **{a: "Queue 1 item 8 (ICM)" for a in ("cnn2", "stf10", "oj_ICM", "seg_oj_ICM")},
}


def convert_reference_state_dict(arch: str, sd: dict) -> Dict[str, torch.Tensor]:
    """Dispatch a reference state dict to the architecture's converter."""
    if arch == "cnn":
        return convert_wacnn_checkpoint(sd)
    if arch == "stf":
        return convert_stf_checkpoint(sd)
    if arch in ZIGZAG_CONVERT_CONFIGS:
        return convert_zigzag_checkpoint(sd, **ZIGZAG_CONVERT_CONFIGS[arch])
    if arch in ("stf9", "stf11", "stf14"):
        return convert_crc_checkpoint(sd, arch)
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
