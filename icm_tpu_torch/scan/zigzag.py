"""Zigzag scan orders over (channel-slice, H-block, W-block) lattices.

Port of ``icm_tpu/scan/zigzag.py``. The traversal of the lattice's
diagonal shells runs once in numpy (:func:`zigzag_order`) and becomes a
static permutation; :func:`zigzag_split` and :func:`zigzag_merge` are one
reshape/permute and one index on torch tensors.

Block semantics are the reference's view ``(B, nS, C', nH, H', nW, W')``:
the slice is the coarse factor of C and a block the coarse factor of H
and W, so blocks are contiguous image quadrants (for nH = nW = 2). The
port's tensors are NCHW, so that view is direct. Split gives
(B, N, C', H', W') with N = nS * nH * nW in zigzag order.

The windowed token variant (:func:`zigzag_split_tokens`, the masked
family's) pads H and W to window multiples and flattens each block to a
token. Its tokens are channel-major (C', H', W'), the reference's order
and the one every converted dense weight of the family indexes; the JAX
package's function flattens its NHWC blocks (H', W', C').
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _advance(c, h, w, i, nC, nH, nW, constrained):
    """One step of the reference's index state machine."""
    if (c + 2 > nC) or (constrained and c + 1 > i):
        c = 0
        if h + 2 > nH or h + 1 > i:
            w += 1
            h = 0
        else:
            h += 1
    else:
        c += 1
    return c, h, w


@functools.lru_cache(maxsize=128)
def zigzag_order(nC: int, nH: int, nW: int,
                 constrained: bool = True) -> Tuple[Tuple[int, int, int], ...]:
    """Ordered (c, h, w) lattice positions of the zigzag traversal:
    ``constrained=True`` bounds the channel index by the shell (stf6),
    ``False`` takes every channel at each spatial shell (stf8)."""
    order: List[Tuple[int, int, int]] = []
    shells = max(nC, nH, nW) if constrained else max(nH, nW)
    for i in range(shells):
        c = h = w = 0
        n_inner = ((min(i + 1, nC) if constrained else nC)
                   * min(i + 1, nH) * min(i + 1, nW))
        for _ in range(n_inner):
            on_shell = max(c, h, w) >= i if constrained else max(h, w) >= i
            if on_shell or i == 0:
                order.append((c, h, w))
            c, h, w = _advance(c, h, w, i, nC, nH, nW, constrained)
    assert len(order) == nC * nH * nW, (len(order), nC, nH, nW)
    assert len(set(order)) == len(order), "zigzag order is not a permutation"
    return tuple(order)


@functools.lru_cache(maxsize=128)
def _flat_order(nC: int, nH: int, nW: int, constrained: bool) -> np.ndarray:
    order = zigzag_order(nC, nH, nW, constrained)
    return np.array([c * nH * nW + h * nW + w for c, h, w in order], np.int32)


def inverse_order(order) -> np.ndarray:
    order = np.asarray(order)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=order.dtype)
    return inv


@functools.lru_cache(maxsize=128)
def _index(nC: int, nH: int, nW: int, constrained: bool, inverse: bool,
           device: torch.device) -> torch.Tensor:
    """The order (or its inverse) as an index on ``device``, made once: a
    copy to the card on every call would wait for it."""
    order = _flat_order(nC, nH, nW, constrained)
    order = inverse_order(order) if inverse else order
    return torch.from_numpy(order.astype(np.int64)).to(device)


def _to_blocks(x: torch.Tensor, num_slices: int, nH: int, nW: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, nS * nH * nW, C', H', W'), slice-major."""
    B, C, H, W = x.shape
    if H % nH or W % nW or C % num_slices:
        raise ValueError(f"({C}, {H}, {W}) does not split into {num_slices} x {nH} x {nW}")
    Cp, Hp, Wp = C // num_slices, H // nH, W // nW
    x = x.reshape(B, num_slices, Cp, nH, Hp, nW, Wp).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(B, num_slices * nH * nW, Cp, Hp, Wp)


def _from_blocks(blocks: torch.Tensor, num_slices: int, nH: int, nW: int) -> torch.Tensor:
    B, _, Cp, Hp, Wp = blocks.shape
    x = blocks.reshape(B, num_slices, nH, nW, Cp, Hp, Wp).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, num_slices * Cp, nH * Hp, nW * Wp)


def zigzag_split(x: torch.Tensor, num_slices: int, nH: int = 2, nW: int = 2,
                 constrained: bool = True) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, C/nS, H/nH, W/nW) in zigzag order (the
    reference's ``ZigzagSplits``)."""
    blocks = _to_blocks(x, num_slices, nH, nW)
    return blocks.index_select(1, _index(num_slices, nH, nW, constrained, False, x.device))


def zigzag_merge(zz: torch.Tensor, num_slices: int, nH: int = 2, nW: int = 2,
                 constrained: bool = True) -> torch.Tensor:
    """Inverse of :func:`zigzag_split` (the reference's ``ZigzagReverse``)."""
    blocks = zz.index_select(1, _index(num_slices, nH, nW, constrained, True, zz.device))
    return _from_blocks(blocks, num_slices, nH, nW)


def zigzag_split_tokens(x: torch.Tensor, num_slices: int, window_size: int = 8,
                        constrained: bool = True):
    """(B, C, H, W) -> ((B, N, C/nS * ws * ws) channel-major tokens in
    zigzag order, nH, nW): H and W zero-padded at the bottom and right to
    multiples of ``window_size`` ws, the lattice nH x nW windows of ws x
    ws (the reference's windowed ``ZigzagSplits``, stf2.py:804-866)."""
    ws = window_size
    H, W = x.shape[2:]
    pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, pad_r, 0, pad_b))
    nH, nW = (H + pad_b) // ws, (W + pad_r) // ws
    zz = zigzag_split(x, num_slices, nH, nW, constrained)
    return zz.reshape(zz.shape[0], zz.shape[1], -1), nH, nW
