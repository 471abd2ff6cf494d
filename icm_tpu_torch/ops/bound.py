"""Lower-bound op with pass-through gradient.

Port of ``icm_tpu/ops/bound.py``: forward is ``max(x, bound)``; the
gradient passes where ``x >= bound`` or where it would move ``x`` up off
the bound (``grad < 0`` under descent), and is zero otherwise. ``bound``
takes no gradient.
"""

import torch


class _LowerBoundFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBoundFn.apply(x, float(bound))
