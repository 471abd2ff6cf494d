"""Compression model base: the ChARM coding protocol.

Port of ``icm_tpu/models/base.py``. The autoregressive loop

    y, z = analyze(x);  z_hat = STE(z)
    state = ctx_prepare(z_hat)
    for i in slices:
        mu, scale, mean_support = slice_context(i, state, support(i, decoded))
        code y_i, then refine it with slice_lrp
    x_hat = synthesize(ctx_assemble(decoded))

is written once: :meth:`CompressionModel.forward` for the training and
eval forwards and ``codec.CharmCodec`` for the real bitstream. Models
supply the protocol methods. Tensors inside are NCHW; ``forward`` takes
and returns the JAX package's NHWC layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyTables
from ..ops import ste_round


@dataclasses.dataclass(frozen=True)
class CodecTables:
    """Host-side coder state built by ``codec.build_codec_tables``."""

    gaussian: EntropyTables
    scale_table: np.ndarray
    bottlenecks: Dict[str, EntropyTables]


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CompressionModel(nn.Module):
    """Subclasses implement the ChARM protocol:

    - ``analyze(x) -> (y, z)``; ``synthesize(y_hat) -> x_hat``
    - ``ctx_prepare(z_hat) -> state``; ``latent_slices(y) -> [y_slice]``
    - ``ctx_slices`` (number of AR steps); ``ctx_support(i, decoded)``
    - ``slice_context(i, state, support) -> (mu, scale, mean_support)``
    - ``slice_lrp(i, mean_support, y_hat_slice) -> lrp``
    - ``ctx_assemble([y_hat_slice]) -> y_hat``

    plus ``entropy_bottleneck`` / ``gaussian_conditional`` submodules.
    """

    def forward(self, x: torch.Tensor, generator=None) -> dict:
        """x: (B, H, W, 3) -> {"x_hat": (B, H, W, 3), "likelihoods":
        {"y": (B, h, w, M), "z": (B, h', w', C)}}.

        With ``generator`` (the training forward) the likelihoods are those
        of the latents plus uniform noise drawn from it; without (the eval
        forward), of the latents rounded. z_hat and the y_hat slices are
        STE-rounded in both."""
        y, z = self.forward_analyze(nhwc_to_nchw(x), generator)
        _, z_likelihoods = self.entropy_bottleneck(z, generator)
        z_offset = self.eb_medians().reshape(1, -1, 1, 1)
        z_hat = ste_round(z - z_offset) + z_offset

        state = self.ctx_prepare(z_hat)
        y_slices = self.latent_slices(y)
        y_hat_slices: List[torch.Tensor] = []
        y_likelihood = []
        for i in range(self.ctx_slices):
            support = self.ctx_support(i, y_hat_slices)
            mu, scale, mean_support = self.forward_slice_context(i, state, support, generator)
            _, lik = self.gaussian_conditional(y_slices[i], scale, mu, generator)
            y_likelihood.append(lik)
            y_hat_slice = ste_round(y_slices[i] - mu) + mu
            y_hat_slice = y_hat_slice + self.forward_slice_lrp(i, mean_support, y_hat_slice,
                                                               generator)
            y_hat_slices.append(y_hat_slice)

        y_hat = self.ctx_assemble(y_hat_slices)
        x_hat = self.forward_synthesize(y_hat, generator)
        return {
            "x_hat": nchw_to_nhwc(x_hat),
            "likelihoods": {
                "y": nchw_to_nhwc(torch.cat(y_likelihood, dim=1)),
                "z": nchw_to_nhwc(z_likelihoods),
            },
        }

    def forward_analyze(self, x: torch.Tensor, generator=None):
        """``analyze`` as :meth:`forward` runs it. A model with stochastic
        layers (stf's stochastic depth) overrides it to draw them from
        ``generator``; the coders call ``analyze`` itself."""
        return self.analyze(x)

    def forward_synthesize(self, y_hat: torch.Tensor, generator=None):
        """``synthesize`` as :meth:`forward` runs it (see
        :meth:`forward_analyze`)."""
        return self.synthesize(y_hat)

    def forward_slice_context(self, i: int, state, support, generator=None):
        """``slice_context`` as :meth:`forward` runs it (see
        :meth:`forward_analyze`)."""
        return self.slice_context(i, state, support)

    def forward_slice_lrp(self, i: int, mean_support, y_hat_slice, generator=None):
        """``slice_lrp`` as :meth:`forward` runs it (see
        :meth:`forward_analyze`)."""
        return self.slice_lrp(i, mean_support, y_hat_slice)

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()[:, 0, 0]

    def eb_dict(self) -> dict:
        """name -> EntropyBottleneck submodule."""
        return {"entropy_bottleneck": self.entropy_bottleneck}


def prefix_support(max_support: int):
    """First-K support (``decoded[:K]``; K < 0 means all)."""

    def fn(i: int, decoded: list) -> list:
        return decoded if max_support < 0 else decoded[:max_support]

    return fn


def sliding_support(max_support: int):
    """Last-K sliding window (``decoded if K > i else decoded[i-K:]``)."""

    def fn(i: int, decoded: list) -> list:
        return decoded if max_support > i else decoded[i - max_support:]

    return fn
