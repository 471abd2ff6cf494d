"""Train and eval steps.

Port of ``icm_tpu/train/steps.py``: one train step is the training
forward (noise quantization), ``rd_loss + aux_weight * aux_loss`` in one
backward, and one step of both optimizers (``optim.DualOptimizer``).
"""

from __future__ import annotations

import torch

from ..eval.metrics import psnr
from .losses import RateDistortionLoss


def make_train_step(model, criterion: RateDistortionLoss, aux_weight: float = 1.0):
    """Returns ``step(state, batch, generator) -> metrics``: the model's
    parameters, the optimizer and ``state.step`` are updated in place; the
    noise is drawn from ``generator``; metrics are 0-d tensors on the
    model's device (read them only where the host needs them)."""

    def step(state, batch: torch.Tensor, generator: torch.Generator) -> dict:
        model.train()
        out = model(batch, generator=generator)
        rd = criterion(out, batch)
        aux = model.aux_loss()
        state.optimizer.zero_grad()
        (rd["loss"] + aux_weight * aux).backward()
        state.optimizer.step()
        state.step += 1
        return {**{k: v.detach() for k, v in rd.items()}, "aux_loss": aux.detach()}

    return step


def make_eval_step(model, criterion: RateDistortionLoss):
    """Returns ``step(batch) -> metrics``: the eval forward (rounding), the
    RD terms and the PSNR of the whole batch."""

    @torch.no_grad()
    def step(batch: torch.Tensor) -> dict:
        model.eval()
        out = model(batch)
        rd = criterion(out, batch)
        return {**rd, "psnr": psnr(out["x_hat"], batch)}

    return step
