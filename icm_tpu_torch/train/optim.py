"""Dual optimizer: a main Adam for everything but the entropy bottleneck's
quantiles, an aux Adam for the quantiles.

Port of ``icm_tpu/train/optim.py``. Parameters are labelled "main", "aux"
or "frozen" by their names (``label_params``); the main group's gradients
are clipped to a global norm computed over the main group only, then
Adam; the aux group takes Adam at its own rate; frozen parameters are in
neither optimizer and never move. ``torch.optim.Adam``'s defaults
(betas 0.9/0.999, eps 1e-8 added to the bias-corrected ``sqrt(v)``) are
``optax.adam``'s.

In the training forward the RD loss has zero gradient with respect to the
quantiles (the STE z offset cancels, noise quantization ignores the
medians) and the aux loss holds the density parameters fixed, so one
backward of ``rd_loss + aux_loss`` gives both optimizers their gradients.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def label_params(model: nn.Module, freeze_patterns=(), train_patterns=None
                 ) -> Dict[str, str]:
    """name -> "aux" for the quantiles, "frozen" for names that contain one
    of ``freeze_patterns`` or, when ``train_patterns`` is given, none of
    them, "main" otherwise. Names are matched with "/" between their parts,
    as the JAX package's parameter paths are."""
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        joined = "/".join(parts)
        if any(pat in joined for pat in freeze_patterns):
            labels[name] = "frozen"
        elif train_patterns is not None and not any(
            pat in joined for pat in train_patterns
        ):
            labels[name] = "frozen"
        else:
            labels[name] = "aux" if "quantiles" in parts else "main"
    return labels


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``, the norm
    taken over all of them together (``optax.clip_by_global_norm``), with
    no host synchronisation."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))


def _adam(params, lr):
    """Adam over ``params``, or None for an empty group (a selective run
    can freeze all of one group)."""
    return torch.optim.Adam(params, lr=lr) if params else None


class DualOptimizer:
    """The main and aux Adams and the main group's clip, stepped together."""

    def __init__(self, model: nn.Module, learning_rate: float = 1e-4,
                 aux_learning_rate: float = 1e-3, clip_max_norm: float = 1.0,
                 freeze_patterns=(), train_patterns=None):
        self.labels = label_params(model, tuple(freeze_patterns), train_patterns)
        params = dict(model.named_parameters())
        self.main_params = [p for n, p in params.items() if self.labels[n] == "main"]
        aux_params = [p for n, p in params.items() if self.labels[n] == "aux"]
        self.clip_max_norm = clip_max_norm
        self.groups = {"main": _adam(self.main_params, learning_rate),
                       "aux": _adam(aux_params, aux_learning_rate)}

    def _optimizers(self):
        return [opt for opt in self.groups.values() if opt is not None]

    def zero_grad(self) -> None:
        for opt in self._optimizers():
            opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_max_norm:
            grads = [p.grad for p in self.main_params if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_max_norm)
        for opt in self._optimizers():
            opt.step()

    def set_learning_rate(self, lr: float) -> None:
        """The main group's rate (the plateau scheduler's); the aux rate
        stays."""
        if self.groups["main"] is not None:
            for group in self.groups["main"].param_groups:
                group["lr"] = lr

    def state_dict(self) -> dict:
        return {k: opt.state_dict() for k, opt in self.groups.items() if opt is not None}

    def load_state_dict(self, state: dict) -> None:
        """Adam's moments and step counts from ``state``; each group keeps
        the rate it has now. ``torch.optim.Adam.load_state_dict`` would
        bring back the saved rates, a decayed one included, whereas the
        JAX package rebuilds ``tx`` from its arguments on a resume."""
        for k, opt in self.groups.items():
            if opt is not None:
                rates = [group["lr"] for group in opt.param_groups]
                opt.load_state_dict(state[k])
                for group, lr in zip(opt.param_groups, rates):
                    group["lr"] = lr


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4,
                   aux_learning_rate: float = 1e-3, clip_max_norm: float = 1.0,
                   freeze_patterns=(), train_patterns=None) -> DualOptimizer:
    return DualOptimizer(model, learning_rate, aux_learning_rate,
                         clip_max_norm, freeze_patterns, train_patterns)


class TrainState:
    """The model, its optimizer and the count of steps taken."""

    def __init__(self, model: nn.Module, optimizer: DualOptimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step
