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
Swin blocks pad. The refiners run without stochastic depth in every
forward, as the JAX package's unrolled forward runs them.

Submodules carry the flax names (``cc_mean_{i}``, ``mu_refine_{i}.stage{j}``
...), so ``convert.from_jax_params`` maps a JAX tree one to one. Not
ported yet: the ``scan_charm`` forward and the family's scan wire with
their stacked weights (``ROADMAP.md``, Queue 1).
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
from .cnn import _cc_transform, _hyper_decoder, _hyper_encoder
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

    def forward(self, x):
        r = nchw_to_nhwc(x)
        for j in range(self.n):
            r = getattr(self, f"stage{j}")(r)
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

    def _refine(self, tag: str, i: int, x):
        return getattr(self, f"{tag}_refine_{i}")(x) if self.refine_depths[tag] else x

    def slice_context(self, i, state, support):
        mean_support = torch.cat(self._cond(state["means"], i) + support, dim=1)
        mu = self._refine("mu", i, getattr(self, f"cc_mean_{i}")(mean_support))
        scale_support = torch.cat(self._cond(state["scales"], i) + support, dim=1)
        scale = self._refine("sigma", i, getattr(self, f"cc_scale_{i}")(scale_support))
        return mu, scale, mean_support

    def slice_lrp(self, i, mean_support, y_hat_slice):
        lrp = getattr(self, f"lrp_{i}")(torch.cat([mean_support, y_hat_slice], dim=1))
        return 0.5 * torch.tanh(self._refine("lrp", i, lrp))

    def ctx_assemble(self, y_hat_slices):
        if self.spatial_number == 1:
            return torch.cat(y_hat_slices, dim=1)
        n = self.spatial_number
        return zigzag_merge(torch.stack(y_hat_slices, dim=1), self.num_slices, n, n,
                            self.zigzag_constrained)


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
