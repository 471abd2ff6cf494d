"""Checkpoint save and load with ``torch.save``/``torch.load``.

Port of ``icm_tpu/train/checkpoint.py``: the payload holds the model's
state dict, both optimizers' states, the step count and a metadata dict
(epoch, best loss), as the JAX package's orbax payload holds its
``TrainState`` and metadata.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .optim import TrainState


def save_checkpoint(path: str, state: TrainState, metadata: Optional[dict] = None):
    """Write ``state`` and ``metadata`` to the file ``path`` (through a
    temporary name renamed into place, so a crash never leaves half a
    checkpoint)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "metadata": dict(metadata or {}),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState):
    """Load the model, optimizer and step of the file ``path`` into
    ``state`` (tensors onto the model's device). The optimizer keeps the
    rates it was built with (``DualOptimizer.load_state_dict``), so a
    resumed run steps at its own arguments. -> (state, metadata)."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, payload.get("metadata", {})
