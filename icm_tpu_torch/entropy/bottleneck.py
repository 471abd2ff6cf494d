"""Fully-factorized entropy bottleneck (the hyperprior's z channel).

Port of ``icm_tpu/entropy/bottleneck.py``: a per-channel monotone MLP
density ``_logits_cumulative``, learned quantiles with the aux loss that
pulls them to the tail-mass targets, the noise forward (training) and the
round-to-median forward (eval), and the table build (``pmf_meta`` ->
``pmf_rows`` -> :func:`eb_tables_from_pmf_data`). Parameter names and shapes are the JAX
package's (``matrix{i}`` (C, out, in), ``bias{i}``, ``factor{i}``,
``quantiles`` (C, 1, 3)). Inputs are NCHW.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lower_bound
from .base import EntropyTables, pmf_to_cdf_rows, quantize


class EntropyBottleneck(nn.Module):
    def __init__(
        self,
        channels: int,
        tail_mass: float = 1e-9,
        init_scale: float = 10.0,
        filters: Tuple[int, ...] = (3, 3, 3, 3),
        likelihood_bound: float = 1e-9,
    ):
        super().__init__()
        self.channels = channels
        self.tail_mass = tail_mass
        self.init_scale = init_scale
        self.filters = tuple(filters)
        self.likelihood_bound = likelihood_bound
        dims = (1,) + self.filters + (1,)
        C = channels
        for i in range(len(self.filters) + 1):
            self.register_parameter(
                f"matrix{i}", nn.Parameter(torch.empty(C, dims[i + 1], dims[i]))
            )
            self.register_parameter(
                f"bias{i}", nn.Parameter(torch.empty(C, dims[i + 1], 1))
            )
            if i < len(self.filters):
                self.register_parameter(
                    f"factor{i}", nn.Parameter(torch.empty(C, dims[i + 1], 1))
                )
        self.quantiles = nn.Parameter(torch.empty(C, 1, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The JAX package's init: constant matrices, biases uniform in
        [-0.5, 0.5) drawn from ``generator`` (on the CPU), zero factors,
        quantiles (-init_scale, 0, init_scale)."""
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            init = float(np.log(np.expm1(1.0 / scale / dims[i + 1])))
            getattr(self, f"matrix{i}").fill_(init)
            bias = getattr(self, f"bias{i}")
            bias.copy_(torch.rand(bias.shape, generator=generator) - 0.5)
            if i < len(self.filters):
                getattr(self, f"factor{i}").zero_()
        q = torch.tensor([-self.init_scale, 0.0, self.init_scale])
        self.quantiles.copy_(q.repeat(self.channels, 1, 1))

    def _logits_cumulative(self, inputs: torch.Tensor, stop_gradient: bool):
        """inputs: (C, 1, N) -> logits of the cumulative density."""
        logits = inputs
        for i in range(len(self.filters) + 1):
            matrix = getattr(self, f"matrix{i}")
            bias = getattr(self, f"bias{i}")
            if stop_gradient:
                matrix, bias = matrix.detach(), bias.detach()
            logits = torch.matmul(F.softplus(matrix), logits) + bias
            if i < len(self.filters):
                factor = getattr(self, f"factor{i}")
                if stop_gradient:
                    factor = factor.detach()
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def _likelihood(self, values: torch.Tensor) -> torch.Tensor:
        lower = self._logits_cumulative(values - 0.5, stop_gradient=False)
        upper = self._logits_cumulative(values + 0.5, stop_gradient=False)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, :, 1:2]

    def forward(self, x: torch.Tensor, generator=None):
        """x: (B, C, H, W) -> (outputs, likelihoods), both of x's shape.
        With ``generator`` (training): x plus uniform noise drawn from it;
        without (eval): x rounded around the medians."""
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        B, C, H, W = x.shape
        if C != self.channels:
            raise ValueError(f"{C} channels, bottleneck has {self.channels}")
        values = x.permute(1, 0, 2, 3).reshape(C, 1, -1)
        if generator is not None:
            outputs = quantize(values, "noise", generator=generator)
        else:
            outputs = quantize(values, "dequantize", self.medians())
        likelihood = self._likelihood(outputs)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)

        def back(t):
            return t.reshape(C, B, H, W).permute(1, 0, 2, 3)

        return back(outputs), back(likelihood)

    def aux_loss(self) -> torch.Tensor:
        """Quantile loss: the density's cumulative logits at the quantiles
        against (-t, 0, t), t = log(2 / tail_mass - 1), with the density
        parameters held fixed, so only the quantiles learn from it."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = float(np.log(2.0 / self.tail_mass - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype,
                              device=logits.device)
        return torch.abs(logits - target).sum()

    # --- table building ------------------------------------------------------
    @torch.no_grad()
    def pmf_meta(self):
        """Quantile-derived ranges: (pmf_start, pmf_length, offset)."""
        q = self.quantiles
        medians = q[:, 0, 1]
        minima = torch.clamp_min(torch.ceil(medians - q[:, 0, 0]).to(torch.int32), 0)
        maxima = torch.clamp_min(torch.ceil(q[:, 0, 2] - medians).to(torch.int32), 0)
        offset = -minima
        pmf_start = medians - minima.to(medians.dtype)
        pmf_length = maxima + minima + 1
        return pmf_start, pmf_length, offset

    @torch.no_grad()
    def pmf_rows(self, pmf_start: torch.Tensor, max_length: int):
        """Sample the density: (pmf (C, max_length), tail_mass (C,))."""
        samples = torch.arange(max_length, dtype=torch.float32,
                               device=pmf_start.device)
        samples = samples[None, None, :] + pmf_start[:, None, None]
        lower = self._logits_cumulative(samples - 0.5, stop_gradient=True)
        upper = self._logits_cumulative(samples + 0.5, stop_gradient=True)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        tail_mass = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
        return pmf[:, 0, :], tail_mass

    def pmf_data(self):
        """(pmf, tail_mass, pmf_length, offset) as numpy arrays."""
        pmf_start, pmf_length, offset = self.pmf_meta()
        max_length = int(pmf_length.max())
        pmf, tail = self.pmf_rows(pmf_start, max_length)
        return tuple(t.cpu().numpy() for t in (pmf, tail, pmf_length, offset))


def eb_tables_from_pmf_data(pmf, tail_mass, pmf_length, offset, precision=16):
    """Quantize sampled pmf rows into host CDF tables."""
    pmf = np.asarray(pmf, np.float32)
    tail_mass = np.asarray(tail_mass, np.float32)
    pmf_length = np.asarray(pmf_length, np.int32)
    offset = np.asarray(offset, np.int32)
    cdf = pmf_to_cdf_rows(pmf, tail_mass, pmf_length, precision)
    return EntropyTables(
        quantized_cdf=cdf, cdf_length=pmf_length + 2, offset=offset
    )
