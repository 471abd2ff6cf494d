"""Rate-distortion loss.

Port of ``icm_tpu/train/losses.py`` (``compute_bpp``, ``RateDistortionLoss``):
``loss = lambda * 255^2 * MSE(x, x_hat) + bpp`` with ``bpp = sum(-log2
likelihoods) / num_pixels`` over all likelihood tensors. The task-network
(ICM) losses come with the ICM slice.
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
