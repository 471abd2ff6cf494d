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

A tree of a JAX ``scan_charm=True`` model carries its context stacks as
one ``charm_scan`` subtree, stacked over the slices; it is unstacked
first (``models.cnn.unstack_charm_params``) into the per-slice
``cc_mean_{i}``, ``cc_scale_{i}`` and ``lrp_{i}`` the port's models have.
The slice width is the last conv's output width, the conditioning width
``h_mean_s``'s output width, and the prefix support what is left of the
first conv's input. A tree of a JAX ``ZigzagSwinCodec(scan_charm=True)``
carries its context (convolutions and refiners) as one ``zigzag_scan``
subtree; where its support sits in the padded first conv depends on the
model's support mode and conditioning, which the tree does not show, so
``from_jax_params(params, model=...)`` takes the port's model of that
configuration and unstacks it (``models.stf_family.unstack_zigzag_params``).

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


def _last_kernel(layers: dict) -> np.ndarray:
    """The kernel of the highest-numbered ``Conv_k`` of a flax subtree."""
    convs = [n for n in layers if n.startswith("Conv_")]
    return np.asarray(layers[max(convs, key=lambda n: int(n.split("_")[1]))]["kernel"])


def _unstack_charm_scan(params: dict) -> dict:
    """A tree with a ``charm_scan`` subtree -> the same tree with per-slice
    context stacks in its place."""
    from .models.cnn import unstack_charm_params

    scan = params["charm_scan"]
    first = np.asarray(scan["cc_mean"]["Conv_0"]["kernel"])  # (S, kH, kW, I, O)
    num_slices = first.shape[0]
    slice_ch = _last_kernel(scan["cc_mean"]).shape[-1]
    cond_width = _last_kernel(params["h_mean_s"]).shape[-1]
    max_support = (first.shape[3] - cond_width) // slice_ch
    slices = unstack_charm_params({"charm_scan": scan}, num_slices, slice_ch, max_support,
                                  cond_width)
    rest = {k: v for k, v in params.items() if k != "charm_scan"}
    return {**rest, **{k: {ln: {leaf: t.numpy() for leaf, t in p.items()}
                          for ln, p in layers.items()} for k, layers in slices.items()}}


def _unstack_zigzag_scan(params: dict, model) -> dict:
    """A tree with a ``zigzag_scan`` subtree -> the same tree with the
    per-slice context groups in its place."""
    from .models.stf_family import unstack_zigzag_params

    if model is None:
        raise ValueError("a zigzag_scan tree unstacks only with the model it belongs to "
                         "(from_jax_params(params, model=...)): its support mode and "
                         "conditioning width place the padding")
    slices = unstack_zigzag_params({"zigzag_scan": params["zigzag_scan"]}, model)
    return {**{k: v for k, v in params.items() if k != "zigzag_scan"}, **slices}


def from_jax_params(params: dict, model=None) -> Dict[str, torch.Tensor]:
    """``model``: the port's model of the tree's configuration, needed only
    for a ``zigzag_scan`` tree (see the module docstring)."""
    if set(params) == {"params"}:
        params = params["params"]
    if "charm_scan" in params:
        params = _unstack_charm_scan(params)
    if "zigzag_scan" in params:
        params = _unstack_zigzag_scan(params, model)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(params):
        leaf, arr = _convert(path, np.asarray(value))
        key = ".".join(path[:-1] + (leaf,))
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out
