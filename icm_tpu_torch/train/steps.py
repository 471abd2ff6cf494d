"""Train and eval steps.

Port of ``icm_tpu/train/steps.py``: one train step is the training
forward (noise quantization), ``rd_loss + aux_weight * aux_loss`` in one
backward, and one step of both optimizers (``optim.DualOptimizer``).
"""

from __future__ import annotations

import torch

from ..eval.metrics import psnr
from .losses import RateDistortionLoss


def model_inputs(model, batch) -> tuple:
    """A batch -> the model's positional inputs: x, then as many
    conditioning images as the model takes (``conditioning_inputs``:
    czigzag's up_x4, from an ``(x, up_x4)`` batch). A tuple's first element
    is x; a model without conditioning takes it alone."""
    parts = batch if isinstance(batch, tuple) else (batch,)
    n = 1 + getattr(model, "conditioning_inputs", 0)
    if len(parts) < n:
        raise ValueError(f"{type(model).__name__} takes {n} images a batch, got {len(parts)}")
    return parts[:n]


def make_train_step(model, criterion: RateDistortionLoss, aux_weight: float = 1.0):
    """Returns ``step(state, batch, generator) -> metrics``: the model's
    parameters, the optimizer and ``state.step`` are updated in place; the
    noise is drawn from ``generator``; metrics are 0-d tensors on the
    model's device (read them only where the host needs them). ``batch``:
    the images x, or ``(x, up_x4)`` for a conditional model
    (:func:`model_inputs`); the loss is x's."""

    def step(state, batch, generator: torch.Generator) -> dict:
        model.train()
        inputs = model_inputs(model, batch)
        out = model(*inputs, generator=generator)
        rd = criterion(out, inputs[0])
        aux = model.aux_loss()
        state.optimizer.zero_grad()
        (rd["loss"] + aux_weight * aux).backward()
        state.optimizer.step()
        state.step += 1
        return {**{k: v.detach() for k, v in rd.items()}, "aux_loss": aux.detach()}

    return step


def make_eval_step(model, criterion: RateDistortionLoss):
    """Returns ``step(batch) -> metrics``: the eval forward (rounding), the
    RD terms and the PSNR of the whole batch (a batch as
    :func:`make_train_step` takes it)."""

    @torch.no_grad()
    def step(batch) -> dict:
        model.eval()
        inputs = model_inputs(model, batch)
        out = model(*inputs)
        rd = criterion(out, inputs[0])
        return {**rd, "psnr": psnr(out["x_hat"], inputs[0])}

    return step
