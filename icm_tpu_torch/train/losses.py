"""Rate-distortion and feature-distillation losses.

Port of ``icm_tpu/train/losses.py`` (``compute_bpp``, ``RateDistortionLoss``,
``DetectionICMLoss``): ``loss = lambda * 255^2 * MSE(x, x_hat) + bpp`` with
``bpp = sum(-log2 likelihoods) / num_pixels`` over all likelihood tensors;
the detection ICM loss of ``oj_ICM`` and ``seg_oj_ICM``. The segmentation
ICM loss comes with ``stf10``.
"""

from __future__ import annotations

import math

import torch


def compute_bpp(likelihoods: dict, num_pixels: int) -> torch.Tensor:
    """bpp from a dict of likelihood tensors."""
    total = sum(torch.sum(torch.log(lik)) for lik in likelihoods.values())
    return -total / (math.log(2) * num_pixels)


class RateDistortionLoss:
    def __init__(self, lmbda: float = 1e-2, likelihood_keys=("likelihoods",)):
        self.lmbda = float(lmbda)
        self.likelihood_keys = tuple(likelihood_keys)

    def _bpp(self, output: dict, num_pixels: int):
        bpp = 0.0
        for k in self.likelihood_keys:
            if output.get(k) is not None:
                bpp = bpp + compute_bpp(output[k], num_pixels)
        return bpp

    def __call__(self, output: dict, target: torch.Tensor) -> dict:
        """output: the model's dict (NHWC ``x_hat``); target (B, H, W, 3)."""
        B, H, W, _ = target.shape
        bpp_loss = self._bpp(output, B * H * W)
        mse_loss = torch.mean((output["x_hat"].float() - target) ** 2)
        loss = self.lmbda * 255 ** 2 * mse_loss + bpp_loss
        return {"loss": loss, "bpp_loss": bpp_loss, "mse_loss": mse_loss}


class DetectionICMLoss(RateDistortionLoss):
    """Feature-distillation ICM loss (the reference's ``train_oj.py``):
    ``1000 * MSE(x, decompressedImage) + 100 * sum_{p2..p6} MSE(student,
    teacher) + lambda * bpp``, the teacher's features held fixed; the rate
    of ``likelihood_keys`` only (``seg_oj_ICM``'s segmentation layer at the
    default, as ``tools/train_seg_oj.py`` trains it)."""

    def __call__(self, output: dict, target: torch.Tensor) -> dict:
        B, H, W, _ = target.shape
        bpp_loss = self._bpp(output, B * H * W)
        mse_loss = torch.mean((output["decompressedImage"].float() - target) ** 2)
        t, s = output["Teacher_output_features"], output["Student_output_features"]
        feature_loss = sum(torch.mean((s[k] - t[k].detach()) ** 2) for k in t)
        loss = 1000.0 * mse_loss + 100.0 * feature_loss + self.lmbda * bpp_loss
        return {"loss": loss, "bpp_loss": bpp_loss, "mse_loss": mse_loss,
                "feature_loss": feature_loss}
