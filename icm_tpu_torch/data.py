"""Test images made from a seed, for runs that read no files."""

from __future__ import annotations

import numpy as np


def make_images(seed: int, B: int, size: int) -> np.ndarray:
    """Smooth random images with texture, (B, size, size, 3) in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    imgs = np.zeros((B, size, size, 3), np.float32)
    for b in range(B):
        for c in range(3):
            f = rng.uniform(1, 8, size=(4, 2))
            ph = rng.uniform(0, 2 * np.pi, size=4)
            wave = sum(np.sin(2 * np.pi * (f[i, 0] * xx + f[i, 1] * yy) + ph[i])
                       for i in range(4)) / 8 + 0.5
            imgs[b, :, :, c] = wave
    imgs += 0.05 * rng.standard_normal(imgs.shape).astype(np.float32)
    return np.clip(imgs, 0.0, 1.0)
