"""The stf5-stf8 family: the Swin codec with zigzag or sliding context and
per-slice Swin refiners (registry "stf5", "stf6", "stf6_2", "stf7",
"stf8").

Port of ``icm_tpu/models/stf_family.py`` (the unrolled ChARM protocol the
coders drive, and the eval and training forwards through it). One class
covers four reference variants that differ only in their context:

- ``stf5``: 12 channel slices, sliding support of 6, the full latent's
  means as conditioning, mu / sigma / LRP refiners of Swin depths
  (2, 6, 2, 2) at window 4;
- ``stf6`` (and ``stf6_2``, the same model): 6 channel slices x 2x2
  spatial zigzag = 24 slices, sliding support of 16, the co-located
  zigzag mean block as conditioning (window 1), the mu refiner only;
- ``stf7``: 12 channel slices, prefix support of 6, full-latent means,
  light refiners mu (2, 6) / sigma (2, 2) / LRP (2, 6) at window 8;
- ``stf8``: zigzag 6 x 2x2 without the channel-shell constraint, sliding
  support of 12, a look-ahead window of all 24 zigzag mean blocks as
  conditioning (clamped at the tail), refiners as stf7's at window 8.

The transforms are ``stf``'s (``stf.py``), the hyper-codec and the
per-slice conv stacks WACNN's (``cnn.py``); a slice's conv stack sees the
conditioning (the hyper-decoder's output in "full" mode, ``mean_window``
zigzag blocks of it in "window" mode) and ``min(i, max_support)`` decoded
slices. A refiner adds a residual stack of Swin layers (``nn/swin.py``)
at the slice width, 4 heads: head width 8 at 32 channels (stf5, stf7),
16 at 64 (stf6, stf8); maps smaller than the window are padded, as the
Swin blocks pad.

The JAX package has two training forwards, and so does this class
(``scan_charm``, default False as in the JAX registry):

- the unrolled one (``scan_charm=False``, JAX's ``slice_context``): the
  refiners run without stochastic depth, in training too;
- ``scan_charm=True`` (JAX's ``_ZigzagScanStep`` under ``nn.scan``, the
  forward its full-size benches and ``tools/train.py`` build): in the
  training forward (a ``generator`` given) each refiner block drops its
  residual branches at its rate of ``linspace(0, drop_path_rate,
  sum(depths))``, drawn from that generator; without one it equals the
  unrolled forward. JAX runs it over stacked, zero-padded context
  weights, so that the context compiles once, with the unrolled
  convolutions' outputs (``tests/test_stf_family.py``); the port runs
  the per-slice convolutions.

Submodules carry the flax names (``cc_mean_{i}``, ``mu_refine_{i}.stage{j}``
...), so ``convert.from_jax_params`` maps a JAX tree one to one; a tree
of a ``scan_charm=True`` model carries its context as one ``zigzag_scan``
subtree, which :func:`unstack_zigzag_params` takes back to the per-slice
names. :func:`stack_zigzag_params` builds that subtree; its padded first
convolutions are what the family's scan wire
(``scan_codec.ZigzagSwinScanWire``) applies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn.swin import BasicLayer
from ..scan import zigzag_merge, zigzag_split
from .base import CompressionModel, nchw_to_nhwc, nhwc_to_nchw, prefix_support, sliding_support
from .cnn import _cc_transform, _hyper_decoder, _hyper_encoder, _in_axis
from .stf import _SwinAnalysis, _SwinSynthesis


class _Refiner(nn.Module):
    """Residual per-slice Swin refinement: ``x + stages(x)``, the stages
    ``BasicLayer`` stacks of ``depths``, NCHW in and out."""

    def __init__(self, dim: int, depths: Tuple[int, ...], num_heads: int, window_size: int,
                 drop_path_rate: float):
        super().__init__()
        self.n = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        for j in range(self.n):
            self.add_module(f"stage{j}", BasicLayer(
                dim, num_heads, window_size, dpr[sum(depths[:j]):sum(depths[:j + 1])]))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        r = nchw_to_nhwc(x)
        for j in range(self.n):
            r = getattr(self, f"stage{j}")(r, generator)
        return x + nhwc_to_nchw(r)


class ZigzagSwinCodec(CompressionModel):
    def __init__(
        self,
        embed_dim: int = 48,
        depths: Tuple[int, ...] = (2, 2, 6, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 4,
        patch_size: int = 2,
        drop_path_rate: float = 0.2,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 176, 128, 64),
        num_slices: int = 6,
        spatial_number: int = 2,
        zigzag_constrained: bool = True,
        support_mode: str = "sliding",
        max_support: int = 16,
        mean_mode: str = "window",
        mean_window: int = 1,
        mu_refine: Tuple[int, ...] = (2, 6, 2, 2),
        scale_refine: Tuple[int, ...] = (),
        lrp_refine: Tuple[int, ...] = (),
        refine_window: int = 4,
        refine_heads: int = 4,
        scan_charm: bool = False,
    ):
        super().__init__()
        if support_mode not in ("prefix", "sliding") or mean_mode not in ("full", "window"):
            raise ValueError(f"support_mode {support_mode!r}, mean_mode {mean_mode!r}")
        self.M = embed_dim * 2 ** (len(depths) - 1)
        if self.M % num_slices:
            raise ValueError(f"M={self.M} does not split into {num_slices} slices")
        self.num_slices = num_slices
        self.spatial_number = spatial_number
        self.zigzag_constrained = zigzag_constrained
        self.support_mode = support_mode
        self.max_support = max_support
        self.mean_mode = mean_mode
        self.mean_window = mean_window
        self.scan_charm = scan_charm
        self.slice_ch = self.M // num_slices
        self.refine_depths = {"mu": tuple(mu_refine), "sigma": tuple(scale_refine),
                              "lrp": tuple(lrp_refine)}

        self.g_a = _SwinAnalysis(embed_dim, tuple(depths), tuple(num_heads), window_size,
                                 patch_size, drop_path_rate)
        self.g_s = _SwinSynthesis(embed_dim, tuple(reversed(depths)),
                                  tuple(reversed(num_heads)), window_size, patch_size,
                                  drop_path_rate)
        self.h_a = _hyper_encoder(self.M, tuple(hyper_enc_widths))
        z_ch = hyper_enc_widths[-1]
        self.h_mean_s = _hyper_decoder(z_ch, tuple(hyper_dec_widths))
        self.h_scale_s = _hyper_decoder(z_ch, tuple(hyper_dec_widths))

        sc = self.slice_ch
        # the conditioning: the hyper-decoder's output, or mean_window of its
        # zigzag blocks
        cond = hyper_dec_widths[-1]
        if mean_mode == "window":
            cond = mean_window * (cond // num_slices)
        self.cond_width = cond
        for tag, extra in (("cc_mean", 0), ("cc_scale", 0), ("lrp", sc)):
            for i in range(self.ctx_slices):
                sup = sc * min(i, max_support)
                self.add_module(f"{tag}_{i}",
                                _cc_transform(cond + sup + extra, sc, tuple(cc_widths)))
        for tag, d in self.refine_depths.items():
            for i in range(self.ctx_slices if d else 0):
                self.add_module(f"{tag}_refine_{i}", _Refiner(
                    sc, d, refine_heads, refine_window, drop_path_rate))
        self.entropy_bottleneck = EntropyBottleneck(z_ch)
        self.gaussian_conditional = GaussianConditional()

    @property
    def ctx_slices(self) -> int:
        return self.num_slices * self.spatial_number ** 2

    # --- ChARM protocol (see base.CompressionModel) --------------------------
    def analyze(self, x):
        return self.forward_analyze(x)

    def synthesize(self, y_hat):
        return self.g_s(y_hat)

    def forward_analyze(self, x, generator: Optional[torch.Generator] = None):
        y = self.g_a(x, generator)
        return y, self.h_a(y)

    def forward_synthesize(self, y_hat, generator: Optional[torch.Generator] = None):
        return self.g_s(y_hat, generator)

    def _split(self, t):
        if self.spatial_number == 1:
            return list(torch.chunk(t, self.num_slices, dim=1))
        n = self.spatial_number
        zz = zigzag_split(t, self.num_slices, n, n, self.zigzag_constrained)
        return list(zz.unbind(1))

    def ctx_prepare(self, z_hat):
        means, scales = self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        if self.mean_mode == "full":
            return {"means": [means], "scales": [scales]}
        return {"means": self._split(means), "scales": self._split(scales)}

    def latent_slices(self, y):
        return self._split(y)

    def ctx_support(self, i: int, decoded: list) -> list:
        fn = sliding_support if self.support_mode == "sliding" else prefix_support
        return fn(self.max_support)(i, decoded)

    def _cond(self, blocks: list, i: int) -> list:
        """Slice i's mean or scale conditioning: the full latent's, or the
        window of zigzag blocks [i, i + w), clamped at the tail."""
        if self.mean_mode == "full":
            return blocks
        n, w = self.ctx_slices, self.mean_window
        return blocks[n - w:] if i + w > n else blocks[i:i + w]

    def refine(self, tag: str, i: int, x, generator: Optional[torch.Generator] = None):
        """Slice i's ``tag`` refiner ("mu", "sigma", "lrp") on x, or x where
        the preset has none; stochastic depth drawn from ``generator``."""
        if not self.refine_depths[tag]:
            return x
        return getattr(self, f"{tag}_refine_{i}")(x, generator)

    def slice_context(self, i, state, support):
        return self.forward_slice_context(i, state, support)

    def slice_lrp(self, i, mean_support, y_hat_slice):
        return self.forward_slice_lrp(i, mean_support, y_hat_slice)

    def forward_slice_context(self, i, state, support, generator=None):
        g = generator if self.scan_charm else None  # the unrolled forward: none
        mean_support = torch.cat(self._cond(state["means"], i) + support, dim=1)
        mu = self.refine("mu", i, getattr(self, f"cc_mean_{i}")(mean_support), g)
        scale_support = torch.cat(self._cond(state["scales"], i) + support, dim=1)
        scale = self.refine("sigma", i, getattr(self, f"cc_scale_{i}")(scale_support), g)
        return mu, scale, mean_support

    def forward_slice_lrp(self, i, mean_support, y_hat_slice, generator=None):
        g = generator if self.scan_charm else None
        lrp = getattr(self, f"lrp_{i}")(torch.cat([mean_support, y_hat_slice], dim=1))
        return 0.5 * torch.tanh(self.refine("lrp", i, lrp, g))

    def ctx_assemble(self, y_hat_slices):
        if self.spatial_number == 1:
            return torch.cat(y_hat_slices, dim=1)
        n = self.spatial_number
        return zigzag_merge(torch.stack(y_hat_slices, dim=1), self.num_slices, n, n,
                            self.zigzag_constrained)


# --- stacked context weights (JAX's ``zigzag_scan`` subtree, the scan wire's) --

_CONTEXT_TAGS = ("cc_mean", "cc_scale", "lrp")
_REFINER_TAGS = {"mu": "mu_refine", "sigma": "sigma_refine", "lrp": "lrp_refine"}


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def _per_slice(params) -> dict:
    """A family model, its state dict, or nested dicts in either layout ->
    nested dicts of the per-slice context groups (``cc_mean_{i}``,
    ``mu_refine_{i}`` ...), leaves as tensors."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    groups = _CONTEXT_TAGS + tuple(_REFINER_TAGS.values())
    out: dict = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            path = prefix + tuple(key.split("."))
            if isinstance(value, dict):
                walk(value, path)
            elif path[0].rsplit("_", 1)[0] in groups:
                node = out
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = _as_tensor(value)

    walk(params, ())
    return out


def _stack_trees(trees: list) -> dict:
    return {k: (_stack_trees([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else _as_tensor(v)[i].contiguous()
            for k, v in tree.items()}


def _support_slots(model, i: int):
    """(offset of slice i's support in the padded support block, its
    width): sliding supports right-align (newest last, zeros in the slots
    not decoded yet), prefix supports left-align."""
    sc, max_sup = model.slice_ch, model.max_support
    k = min(i, max_sup)
    return ((max_sup - k) * sc if model.support_mode == "sliding" else 0), k * sc


def _pad_first_conv(k: torch.Tensor, ax: int, lrp: bool, i: int, model) -> torch.Tensor:
    """Slice i's first-conv kernel, input channels on ``ax``: conditioning,
    its support, (LRP) its own slice -> conditioning, the padded support
    block of ``max_support`` slots, (LRP) its own slice."""
    sc, cond, sup_w = model.slice_ch, model.cond_width, model.max_support * model.slice_ch
    off, width = _support_slots(model, i)
    shape = list(k.shape)
    shape[ax] = cond + sup_w + (sc if lrp else 0)
    out = k.new_zeros(shape)
    out.narrow(ax, 0, cond).copy_(k.narrow(ax, 0, cond))
    out.narrow(ax, cond + off, width).copy_(k.narrow(ax, cond, width))
    if lrp:
        out.narrow(ax, cond + sup_w, sc).copy_(k.narrow(ax, cond + width, sc))
    return out


def _unpad_first_conv(k: torch.Tensor, ax: int, lrp: bool, i: int, model) -> torch.Tensor:
    sc, cond, sup_w = model.slice_ch, model.cond_width, model.max_support * model.slice_ch
    off, width = _support_slots(model, i)
    parts = [k.narrow(ax, 0, cond), k.narrow(ax, cond + off, width)]
    if lrp:
        parts.append(k.narrow(ax, cond + sup_w, sc))
    return torch.cat(parts, ax).contiguous()


def stack_zigzag_params(params, model: "ZigzagSwinCodec", refiners: bool = True) -> dict:
    """Per-slice context groups -> ``{"zigzag_scan": {group: stacked}}``,
    each leaf stacked over the slices on a new first axis. Port of
    ``icm_tpu/models/stf_family.py::stack_zigzag_params`` (with
    ``_stack_cc_group``): only ``Conv_0`` of ``cc_mean``, ``cc_scale`` and
    ``lrp`` changes shape, zero-padded to ``cond_width + max_support *
    slice_ch`` input channels (LRP: its own slice last), the support
    aligned as :func:`_support_slots` says; the other convolutions and the
    refiners (``refiners=False`` leaves them out: the scan wire applies
    the model's own) have one shape for every slice. ``params``: a family
    model, its state dict (port layout, ``weight``) or nested dicts in
    either layout (the JAX package's ``kernel``); ``model``: its
    configuration."""
    src = _per_slice(params)
    n = model.ctx_slices
    scan = {}
    for tag in _CONTEXT_TAGS:
        slices = []
        for i in range(n):
            tree = src[f"{tag}_{i}"]
            conv0 = {leaf: (v if leaf == "bias" else
                            _pad_first_conv(v, _in_axis(leaf), tag == "lrp", i, model))
                     for leaf, v in tree["Conv_0"].items()}
            slices.append({**tree, "Conv_0": conv0})
        scan[tag] = _stack_trees(slices)
    for short, tag in _REFINER_TAGS.items():
        if refiners and model.refine_depths[short]:
            scan[tag] = _stack_trees([src[f"{tag}_{i}"] for i in range(n)])
    return {"zigzag_scan": scan}


def unstack_zigzag_params(stacked: dict, model: "ZigzagSwinCodec") -> dict:
    """Inverse of :func:`stack_zigzag_params` (port of the JAX package's
    ``unstack_zigzag_params``): ``{"zigzag_scan": ...}`` -> nested
    per-slice dicts (``cc_mean_{i}``, ``mu_refine_{i}`` ...) with the
    padding cut away, in the layout it came in."""
    scan = stacked["zigzag_scan"]
    out = {}
    for tag in _CONTEXT_TAGS:
        for i in range(model.ctx_slices):
            tree = _index_tree(scan[tag], i)
            tree["Conv_0"] = {leaf: (v if leaf == "bias" else
                                     _unpad_first_conv(v, _in_axis(leaf), tag == "lrp", i, model))
                              for leaf, v in tree["Conv_0"].items()}
            out[f"{tag}_{i}"] = tree
    for tag in _REFINER_TAGS.values():
        if tag in scan:
            for i in range(model.ctx_slices):
                out[f"{tag}_{i}"] = _index_tree(scan[tag], i)
    return out


# --- the reference variants' presets -----------------------------------------

STF5_CONFIG = dict(
    num_slices=12, spatial_number=1, support_mode="sliding", max_support=6,
    mean_mode="full", mu_refine=(2, 6, 2, 2), scale_refine=(2, 6, 2, 2),
    lrp_refine=(2, 6, 2, 2), refine_window=4,
)
STF6_CONFIG = dict(
    num_slices=6, spatial_number=2, support_mode="sliding", max_support=16,
    mean_mode="window", mean_window=1, mu_refine=(2, 6, 2, 2),
    scale_refine=(), lrp_refine=(), refine_window=4,
)
STF7_CONFIG = dict(
    num_slices=12, spatial_number=1, support_mode="prefix", max_support=6,
    mean_mode="full", mu_refine=(2, 6), scale_refine=(2, 2),
    lrp_refine=(2, 6), refine_window=8,
)
STF8_CONFIG = dict(
    num_slices=6, spatial_number=2, support_mode="sliding", max_support=12,
    mean_mode="window", mean_window=24, mu_refine=(2, 6),
    scale_refine=(2, 2), lrp_refine=(2, 6), refine_window=8,
    # stf8's order drops the channel-shell constraint of stf6's
    zigzag_constrained=False,
)
