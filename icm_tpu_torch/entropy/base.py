"""Shared entropy-model utilities.

Port of ``icm_tpu/entropy/base.py``: quantization (uniform noise for
training, rounding to the mean or to integer symbols for coding) and the
quantized CDF tables that feed the host rANS coder. Table building is
numpy on the host; ``pmf_to_cdf_rows`` goes through the native builder
in ``csrc/rans.cpp``, and :func:`pmf_to_quantized_cdf_np` is the same
algorithm in numpy (the two agree byte for byte).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EntropyTables:
    """Host-side quantized CDF tables consumed by the rANS coder."""

    quantized_cdf: np.ndarray  # int32 (n, max_length + 2)
    cdf_length: np.ndarray  # int32 (n,)
    offset: np.ndarray  # int32 (n,)

    @property
    def num_distributions(self) -> int:
        return int(self.quantized_cdf.shape[0])

    def symbol_lut(self) -> np.ndarray:
        """(n, 256) uint16 bucket table for fast rANS decode: entry b holds
        the largest symbol s with cdf[s] <= (b << 8); the decoder finishes
        with a short linear scan inside the CDF row. 256 buckets is the
        width ``csrc/rans.cpp`` reads (kBucketBits). Built once and cached."""
        cached = getattr(self, "_lut_cache", None)
        if cached is not None:
            return cached
        n = self.num_distributions
        bucket_bits = 8
        starts = np.arange(1 << bucket_bits, dtype=np.int64) << (16 - bucket_bits)
        lut = np.empty((n, 1 << bucket_bits), np.uint16)
        for i in range(n):
            L = int(self.cdf_length[i])
            row = self.quantized_cdf[i, :L].astype(np.int64)
            s = np.searchsorted(row, starts, side="right") - 1
            lut[i] = np.clip(s, 0, L - 2).astype(np.uint16)
        object.__setattr__(self, "_lut_cache", lut)
        return lut


def quantize(
    inputs: torch.Tensor,
    mode: str,
    means: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize latents. ``mode`` in {"noise", "dequantize", "symbols"}.

    "noise" adds uniform noise in [-0.5, 0.5) drawn from ``generator`` on
    the generator's own device (then moved to the inputs'), so one seeded
    CPU generator gives the same noise to a CPU and a CUDA run."""
    if mode == "noise":
        if generator is None:
            raise ValueError("noise mode needs a torch.Generator")
        noise = torch.rand(inputs.shape, generator=generator,
                           device=generator.device, dtype=inputs.dtype)
        return inputs + (noise.to(inputs.device) - 0.5)
    outputs = inputs if means is None else inputs - means
    outputs = torch.round(outputs)
    if mode == "dequantize":
        return outputs if means is None else outputs + means
    if mode != "symbols":
        raise ValueError(f"unknown quantize mode {mode!r}")
    return outputs.to(torch.int32)


def dequantize(inputs, means=None, dtype=torch.float32):
    if means is not None:
        return inputs.to(means.dtype) + means
    return inputs.to(dtype)


def pmf_to_quantized_cdf_np(pmf: np.ndarray, precision: int = 16) -> np.ndarray:
    """Quantize a float PMF into an integer CDF summing to ``1 << precision``;
    every interval gets non-zero width by stealing mass from the smallest
    stealable interval (the CompressAI C++ semantics)."""
    pmf = np.asarray(pmf, dtype=np.float32)
    if pmf.ndim != 1:
        raise ValueError("pmf must be 1-D")
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("Invalid pmf: negative or non-finite values")

    n = pmf.shape[0]
    cdf = np.zeros(n + 1, dtype=np.uint32)
    # round-half-away (C++ lround semantics; np.round would round half-even)
    freqs = np.floor(pmf.astype(np.float64) * (1 << precision) + 0.5).astype(
        np.uint32
    )
    cdf[1:] = freqs
    total = int(cdf.sum())
    if total == 0:
        raise ValueError("Invalid pmf: zero total mass")
    # renormalize to exactly 2**precision
    cdf = (
        (np.uint64(1 << precision) * cdf.astype(np.uint64)) // np.uint64(total)
    ).astype(np.uint32)
    cdf = np.cumsum(cdf, dtype=np.uint32)
    cdf[-1] = 1 << precision

    # fix zero-width intervals by stealing from the smallest freq > 1
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs_now = cdf[1:].astype(np.int64) - cdf[:-1].astype(np.int64)
            stealable = np.where(freqs_now > 1)[0]
            if stealable.size == 0:
                raise ValueError("Cannot normalize pmf: no stealable mass")
            best_steal = stealable[np.argmin(freqs_now[stealable])]
            if best_steal < i:
                cdf[best_steal + 1 : i + 1] -= 1
            else:
                cdf[i + 1 : best_steal + 1] += 1

    if cdf[0] != 0 or cdf[-1] != (1 << precision):
        raise ValueError("pmf quantization did not reach the full range")
    return cdf.astype(np.int32)


def pmf_to_cdf_rows(
    pmf: np.ndarray,
    tail_mass: np.ndarray,
    pmf_length: np.ndarray,
    precision: int = 16,
) -> np.ndarray:
    """(n, max_length + 2) CDF table: row i quantizes ``pmf[i, :len_i]``
    plus its tail mass as the final (bypass) symbol."""
    from ..coding import pmf_to_quantized_cdf_rows

    return pmf_to_quantized_cdf_rows(pmf, tail_mass, pmf_length, precision)
