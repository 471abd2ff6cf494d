"""Evaluation metrics. Port of ``icm_tpu/eval/metrics.py::psnr``; MS-SSIM
and the task metrics come with the eval slice."""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB of the mean squared error over all of a and b."""
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / mse)
