"""Conditional Gaussian entropy model (mean/scale hyperprior).

Port of ``icm_tpu/entropy/gaussian.py``: erfc-based standardized
cumulative, scale lower bound 0.11, the log-spaced 64-level scale table,
scale-bucketed indexes and the per-level CDF tables.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special
import scipy.stats
import torch
from torch import nn

from ..ops import lower_bound
from .base import EntropyTables, pmf_to_cdf_rows, quantize

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(
    min_scale: float = SCALES_MIN,
    max_scale: float = SCALES_MAX,
    levels: int = SCALES_LEVELS,
) -> np.ndarray:
    return np.exp(
        np.linspace(math.log(min_scale), math.log(max_scale), levels)
    ).astype(np.float32)


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    # 0.5 * erfc(-x / sqrt(2)); erfc keeps precision in the tails
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


class GaussianConditional(nn.Module):
    def __init__(self, scale_bound: float = 0.11, likelihood_bound: float = 1e-9):
        super().__init__()
        self.scale_bound = scale_bound
        self.likelihood_bound = likelihood_bound

    def _likelihood(self, inputs, scales, means=None):
        values = inputs - means if means is not None else inputs
        scales = lower_bound(scales, self.scale_bound)
        values = torch.abs(values)
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def forward(self, inputs, scales, means=None, generator=None):
        """(outputs, likelihoods). With ``generator`` (training): inputs
        plus uniform noise drawn from it; without (eval): inputs rounded
        around ``means``."""
        dt = torch.promote_types(inputs.dtype, torch.float32)
        inputs, scales = inputs.to(dt), scales.to(dt)
        if means is not None:
            means = means.to(dt)
        if generator is not None:
            outputs = quantize(inputs, "noise", generator=generator)
        else:
            outputs = quantize(inputs, "dequantize", means)
        likelihood = self._likelihood(outputs, scales, means)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)
        return outputs, likelihood


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor,
                  scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """Index = number of table entries (all but the last) strictly below
    the bounded scale (the reference's per-level loop, vectorized)."""
    # compared in the table's float32 (a bfloat16 scale converts exactly)
    scales = torch.clamp_min(scales, scale_bound).to(scale_table.dtype)
    return torch.searchsorted(
        scale_table[:-1].contiguous(), scales.contiguous(), right=False
    ).to(torch.int32)


def gc_build_tables(
    scale_table: np.ndarray, tail_mass: float = 1e-9, precision: int = 16
) -> EntropyTables:
    """Host-side: per-scale-level CDF tables."""
    scale_table = np.asarray(scale_table, np.float64)
    multiplier = -scipy.stats.norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(
        np.arange(max_length, dtype=np.int32)[None, :] - pmf_center[:, None]
    ).astype(np.float32)
    samples_scale = scale_table.astype(np.float32)[:, None]

    def std_cum(x):
        return 0.5 * scipy.special.erfc(-(2 ** -0.5) * x)

    upper = std_cum((0.5 - samples) / samples_scale)
    lower = std_cum((-0.5 - samples) / samples_scale)
    pmf = (upper - lower).astype(np.float32)
    tail = (2 * lower[:, 0]).astype(np.float32)

    cdf = pmf_to_cdf_rows(pmf, tail, pmf_length, precision)
    return EntropyTables(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-pmf_center).astype(np.int32),
    )
