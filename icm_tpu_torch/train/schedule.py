"""Learning-rate schedules, plain Python on the host.

Port of ``icm_tpu/train/schedule.py``.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """Plateau scheduler with torch's semantics (mode 'min', relative
    threshold): an epoch improves only if ``metric < best * (1 -
    threshold)``; after ``patience`` epochs in a row without improvement
    the lr is multiplied by ``factor`` and ``cooldown`` epochs follow in
    which bad epochs are not counted."""

    def __init__(
        self,
        lr: float,
        factor: float = 0.1,
        patience: int = 10,
        min_lr: float = 0.0,
        threshold: float = 1e-4,
        cooldown: int = 0,
    ):
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.cooldown = cooldown
        self.best = float("inf")
        self.bad_epochs = 0
        self.cooldown_counter = 0

    def step(self, metric: float) -> float:
        """Update with the latest validation metric; returns the lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs > self.patience:
            self.lr = max(self.min_lr, self.lr * self.factor)
            self.bad_epochs = 0
            self.cooldown_counter = self.cooldown
        return self.lr


class PolyLR:
    """Polynomial decay: ``lr = base * (1 - step / max_steps) ** power``."""

    def __init__(self, base_lr: float, max_steps: int, power: float = 0.9,
                 min_lr: float = 0.0):
        self.base_lr = base_lr
        self.max_steps = max_steps
        self.power = power
        self.min_lr = min_lr

    def __call__(self, step: int) -> float:
        frac = min(step, self.max_steps) / self.max_steps
        return max(self.min_lr, self.base_lr * (1 - frac) ** self.power)
