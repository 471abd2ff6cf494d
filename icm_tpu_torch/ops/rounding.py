"""Straight-through rounding: forward ``round(x)`` (half to even, as
``jnp.round``), backward the identity. Port of ``icm_tpu/ops/rounding.py``."""

import torch


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)
