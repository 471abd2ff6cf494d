"""Training engine: the epoch loop behind the training entry points.

Port of ``icm_tpu/train/engine.py`` for one card: dual optimizer -> epoch
loop with logging -> eval epoch -> ReduceLROnPlateau on the main group's
rate -> best-loss checkpoint -> resume, and a retry wrapper that resumes
from the last checkpoint after a failure. The model comes in built on its
device (``models.create_model``); batches are moved there. The JAX
package's data-parallel mesh path is not ported (DDP, past one card, is a
later slice).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .checkpoint import load_checkpoint, save_checkpoint
from .optim import TrainState, make_optimizer
from .schedule import ReduceLROnPlateau
from .steps import make_eval_step


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(1, self.count)


def _step_seed(seed: int, step: int) -> int:
    """Seed of step ``step``'s noise: a function of (seed, step) alone, so
    a resumed run draws the noise the uninterrupted run would have."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def run_training_with_recovery(max_retries: int = 2, **kwargs):
    """``run_training`` that, on an exception, resumes from the last best
    checkpoint (when a save path was given), up to ``max_retries`` times."""
    save_path = kwargs.get("save_path")
    retries = 0
    while True:
        try:
            return run_training(**kwargs)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 -- any failure of a run is retried
            retries += 1
            if retries > max_retries or not save_path:
                raise
            if os.path.exists(save_path):
                kwargs["checkpoint"] = save_path
            print(
                f"[recovery] training failed ({type(e).__name__}: "
                f"{str(e)[:120]}); resuming from "
                f"{kwargs.get('checkpoint')} (retry {retries}/{max_retries})",
                flush=True,
            )


def _to_device(batch, device):
    if isinstance(batch, tuple):
        batch = batch[0]
    return torch.as_tensor(batch).to(device, non_blocking=True)


def run_training(
    *,
    model,
    criterion,
    make_step: Callable,
    train_batches: Callable[[int], "iter"],
    eval_batches: Callable[[], "iter"],
    epochs: int,
    learning_rate: float = 1e-4,
    aux_learning_rate: float = 1e-3,
    clip_max_norm: float = 1.0,
    freeze_patterns=(),
    train_patterns=None,
    seed: int = 0,
    save_path: Optional[str] = None,
    checkpoint: Optional[str] = None,
    lr_patience: int = 10,
    log_every: int = 10,
):
    """Train ``model`` (built on its device) for ``epochs`` epochs.
    ``make_step(model, criterion)`` returns ``step(state, batch, generator)
    -> metrics``; ``train_batches(epoch)`` and ``eval_batches()`` yield
    (B, H, W, 3) batches (numpy arrays or tensors). Returns (state,
    per-epoch test losses)."""
    device = next(model.parameters()).device
    optimizer = make_optimizer(model, learning_rate, aux_learning_rate,
                               clip_max_norm, freeze_patterns, train_patterns)
    state = TrainState(model, optimizer)
    start_epoch = 0
    sched = ReduceLROnPlateau(learning_rate, patience=lr_patience)
    best_loss = float("inf")

    if checkpoint:
        state, meta = load_checkpoint(checkpoint, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_loss = float(meta.get("best_loss", best_loss))
        print(f"resumed from {checkpoint} at epoch {start_epoch}")

    step = make_step(model, criterion)
    eval_fn = make_eval_step(model, criterion)
    noise = torch.Generator(device=device)
    history = []
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        meter = AverageMeter()
        for i, batch in enumerate(train_batches(epoch)):
            noise.manual_seed(_step_seed(seed, state.step))
            metrics = step(state, _to_device(batch, device), noise)
            if i % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                meter.update(metrics["loss"])
                parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
                print(f"epoch {epoch} step {i}: {parts}", flush=True)

        eval_meter = AverageMeter()
        for batch in eval_batches():
            eval_meter.update(float(eval_fn(_to_device(batch, device))["loss"]))
        test_loss = eval_meter.avg if eval_meter.count else meter.avg
        new_lr = sched.step(test_loss)
        if new_lr != learning_rate:
            print(f"lr -> {new_lr}")
            learning_rate = new_lr
            optimizer.set_learning_rate(new_lr)

        history.append(test_loss)
        is_best = test_loss < best_loss
        best_loss = min(test_loss, best_loss)
        print(
            f"epoch {epoch}: test_loss={test_loss:.4f} "
            f"best={best_loss:.4f} ({time.time() - t0:.1f}s)",
            flush=True,
        )
        if save_path and is_best:
            save_checkpoint(save_path, state, {"epoch": epoch, "best_loss": best_loss})
    return state, history
