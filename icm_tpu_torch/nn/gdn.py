"""Generalized Divisive Normalization: ``y = x / sqrt(beta + gamma x^2)``
(inverse: times the sqrt), beta and gamma kept positive by the
non-negative reparametrization.

Port of ``icm_tpu/nn/gdn.py``. The reparametrization (with the lower
bound's gradient) stays in autograd; the normalization itself goes
through :func:`gdn_fused.gdn` on every device, in serving and in
training: the fused CUDA kernels for a CUDA tensor, their plain versions
for a CPU tensor, as the JAX module goes through ``gdn_fused`` on every
TPU run. ``gamma`` is stored as (C_out, C_in), the conv-weight
orientation; the JAX package stores its transpose
(``convert.from_jax_params`` transposes). As the JAX module does
(``icm_tpu/nn/gdn.py:57``, ``gdn_pallas.py:205``), gamma is rounded to
x's dtype (bfloat16 under the activation policy) and beta stays float32.
"""

import torch
from torch import nn

from ..ops import NonNegativeParametrizer
from .gdn_fused import gdn


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.channels = channels
        self.inverse = inverse
        self.gamma_init = gamma_init
        self.beta_reparam = NonNegativeParametrizer(minimum=beta_min)
        self.gamma_reparam = NonNegativeParametrizer()
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        C = self.channels
        dev = self.beta.device
        self.beta.copy_(self.beta_reparam.init(torch.ones(C, device=dev)))
        self.gamma.copy_(self.gamma_reparam.init(
            self.gamma_init * torch.eye(C, device=dev)))

    def forward(self, x):
        beta = self.beta_reparam(self.beta)
        gamma = self.gamma_reparam(self.gamma)
        return gdn(x, gamma.to(x.dtype), beta, self.inverse)
