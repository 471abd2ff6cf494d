"""Non-negative reparametrization used by GDN.

Port of ``icm_tpu/ops/parametrizers.py``: parameters are stored as
``v = sqrt(max(x + pedestal, pedestal))`` and read as
``lower_bound(v, bound)**2 - pedestal``, with ``pedestal =
reparam_offset**2`` and ``reparam_offset = 2**-18``.
"""

import torch

from .bound import lower_bound


class NonNegativeParametrizer:
    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2 ** -18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset ** 2
        self._bound = (self.minimum + self.reparam_offset ** 2) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        """Map an initial value into the reparametrized domain."""
        return torch.sqrt(torch.clamp_min(x + self.pedestal, self.pedestal))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = lower_bound(x, self._bound)
        return out * out - self.pedestal
