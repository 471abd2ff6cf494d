"""Parameters of the JAX package's models -> the port's state dict.

``from_jax_params(params)`` takes a flax parameter tree as nested dicts of
numpy arrays (``jax.device_get(variables["params"])``; the outer
``{"params": ...}`` wrapper is accepted too) and returns the state dict of
the port's model of the same configuration. The port's module tree
carries the flax names, so a path ``a/b/kernel`` becomes the key
``a.b.weight``; the values are re-laid:

- conv ``(kH, kW, I, O)`` -> ``(O, I, kH, kW)``;
- conv-transpose ``(kH, kW, I, O)``: flax correlates with the kernel
  spatially flipped relative to PyTorch, so the flip is undone, then
  ``(I, O, kH, kW)``;
- dense ``(I, O)`` -> ``(O, I)``;
- GDN ``gamma`` (C_in, C_out) -> (C_out, C_in), still in the
  reparametrized form, and ``beta`` as it is;
- LayerNorm ``scale`` -> ``weight`` (``bias`` keeps its name);
- everything else (bottleneck, relative-position tables) as it is.

Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _walk(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _convert(path, value: np.ndarray):
    parent, leaf = path[-2] if len(path) > 1 else "", path[-1]
    if leaf == "kernel":
        if value.ndim == 4 and parent.startswith("ConvTranspose"):
            return "weight", np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:
            return "weight", np.transpose(value, (1, 0))
        raise ValueError(f"kernel of rank {value.ndim} at {'/'.join(path)}")
    if leaf == "gamma" and parent.startswith("GDN"):
        return leaf, np.transpose(value, (1, 0))
    if leaf == "scale" and parent.startswith("LayerNorm"):
        return "weight", value
    return leaf, value


def from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params):
        leaf, arr = _convert(path, np.asarray(value))
        key = ".".join(path[:-1] + (leaf,))
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out
