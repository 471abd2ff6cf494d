"""Model registry and construction.

``create_model(name, device=None, seed=0)`` builds a model on the card
(``device=None`` means ``cuda``; it raises when CUDA is absent, and a CPU
model is had only by asking for ``device="cpu"``). Parameters are made
directly on the device (the module tree is built on the meta device, then
materialized) and drawn from a ``torch.Generator`` seeded with ``seed``,
with the JAX package's initializers: truncated-normal fan-in scaling for
conv kernels, truncated normal (0.02) for dense layers (fan-in scaled
for those marked ``fan_in_init``, flax's default ``nn.Dense``) and the
relative-position tables, zero biases, LayerNorm scales of one, the GDN
and bottleneck inits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import WindowAttention
from .base import CodecTables, CompressionModel
from .cnn import WACNN
from .codec import CharmCodec, build_codec_tables, cuda_numerics, enc_round
from .crc import (ConditionalResidualCoding, ConditionalResidualCoding2,
                  ConditionalResidualCoding3, ResidualCoding)
from .crc_codec import CRCCodec, CzigzagCodec
from .czigzag import conditionalZigzag
from .device_codec import DeviceWireCodec, DeviceWireKit
from .icm import WACNN2, decompress_detect
from .masked_codec import Stf3Codec, Stf4Codec
from .masked_ctx import ClipEncoder, ClipEncoder3, ClipEncoder4
from .stf import SymmetricalTransFormer
from .stf_family import STF5_CONFIG, STF6_CONFIG, STF7_CONFIG, STF8_CONFIG, ZigzagSwinCodec

models = {
    "cnn": (WACNN, {}),
    "stf": (SymmetricalTransFormer, {}),
    "stf5": (ZigzagSwinCodec, STF5_CONFIG),
    "stf6": (ZigzagSwinCodec, STF6_CONFIG),
    "stf6_2": (ZigzagSwinCodec, STF6_CONFIG),  # the reference's stf6_2 is stf6
    "stf7": (ZigzagSwinCodec, STF7_CONFIG),
    "stf8": (ZigzagSwinCodec, STF8_CONFIG),
    "stf9": (ConditionalResidualCoding, {}),
    "stf11": (ConditionalResidualCoding, {}),  # the reference's stf11 is stf9
    "stf12": (ConditionalResidualCoding2, {}),
    "stf13": (ConditionalResidualCoding3, {}),
    "stf14": (ResidualCoding, {}),
    "stf2": (ClipEncoder, {}),
    "stf3": (ClipEncoder3, {}),
    "stf4": (ClipEncoder4, {}),
    "czigzag": (conditionalZigzag, {}),
    "cnn2": (WACNN2, {}),
}


def resolve_device(device=None) -> torch.device:
    """None -> cuda. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "icm_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
    return dev


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (redrawn), on the CPU. Each round
    redraws the values still out of range, in index order, from
    ``generator``; only the positions redrawn last can be out of range, so
    a round looks at those alone."""
    x = torch.randn(shape, generator=generator)
    flat = x.view(-1)
    idx = (flat.abs() > 2).nonzero().squeeze(1)
    while idx.numel():
        redrawn = torch.randn(idx.numel(), generator=generator)
        flat[idx] = redrawn
        idx = idx[redrawn.abs() > 2]
    return x * std


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from ``generator``."""
    # std of a unit normal truncated at +-2, as flax's variance scaling uses
    trunc_std = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            k = w.shape[2] * w.shape[3]
            # fan_in of the flax kernel (kH, kW, I, O): torch's Conv2d keeps
            # I at dim 1, ConvTranspose2d at dim 0
            fan_in = k * (w.shape[1] if isinstance(mod, nn.Conv2d) else w.shape[0])
            std = math.sqrt(1.0 / fan_in) / trunc_std
            w.copy_(_trunc_normal(w.shape, std, generator))
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, "bias_init", 0.0))
        elif isinstance(mod, nn.Linear):
            # flax's default (lecun_normal) where the JAX model keeps it, else
            # the Swin layers' 0.02
            std = (math.sqrt(1.0 / mod.in_features) / trunc_std
                   if getattr(mod, "fan_in_init", False) else 0.02)
            mod.weight.copy_(_trunc_normal(mod.weight.shape, std, generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, WindowAttention):
            t = mod.relative_position_bias_table
            t.copy_(_trunc_normal(t.shape, 0.02, generator))
        elif hasattr(mod, "reset_parameters") and mod is not model:
            mod.reset_parameters(generator)


def create_model(name: str, device=None, seed: int = 0, **overrides) -> CompressionModel:
    """Build ``name`` on ``device`` (default: the CUDA card) in eval mode,
    with weights drawn from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    cls, kwargs = models[name]
    with torch.device("meta"):
        model = cls(**{**kwargs, **overrides})
    model = model.to_empty(device=dev)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()


__all__ = [
    "CompressionModel",
    "CodecTables",
    "WACNN",
    "WACNN2",
    "SymmetricalTransFormer",
    "ZigzagSwinCodec",
    "CharmCodec",
    "ClipEncoder",
    "ClipEncoder3",
    "ClipEncoder4",
    "ConditionalResidualCoding",
    "ConditionalResidualCoding2",
    "ConditionalResidualCoding3",
    "CRCCodec",
    "CzigzagCodec",
    "conditionalZigzag",
    "DeviceWireCodec",
    "DeviceWireKit",
    "build_codec_tables",
    "create_model",
    "cuda_numerics",
    "decompress_detect",
    "enc_round",
    "init_parameters",
    "models",
    "resolve_device",
    "ResidualCoding",
    "Stf3Codec",
    "Stf4Codec",
]
