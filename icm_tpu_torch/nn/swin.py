"""The Swin-transformer stack of the stf codecs, channel-last.

Port of ``icm_tpu/nn/swin.py`` (``Mlp``, ``DropPath``, ``SwinBlock``,
``PatchMerging``, ``PatchSplit``, ``BasicLayer``, ``PatchEmbed``, and
czigzag's cross-attention ``SwinBlockCross`` and ``BasicLayerCross``). Features
stay (B, H, W, C) through the stack, as in the JAX package; only
``PatchEmbed`` takes an NCHW image (its convolution is cuDNN's) and
returns NHWC. The attention runs in ``layers.WindowAttention``: the
relative-position bias and the shifted-window masks folded per window
class, then :func:`window_attention.window_attention` (the CUDA kernel on
the card). Submodules carry the flax names (``LayerNorm_0``, ``attn``,
``mlp.Dense_1``, ``downsample``, ``block3`` ...), so
``convert.from_jax_params`` maps every path one to one.

Stochastic depth draws from the ``generator`` the forward is given (the
training forward), never from ``self.training``: without one every
block is deterministic, as the JAX package's ``deterministic=True``.

Under the bfloat16 activation policy (``layers.set_activation_dtype``)
the dense layers and the patch embedding's convolution return bfloat16
and every LayerNorm float32, as in the JAX package: a stage's residual
stream stays float32 after the patch embedding (float32 shortcut plus
bfloat16 branch) and bfloat16 after a patch merge or split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, CrossWindowAttention, LayerNorm, Linear, ShiftedWindows,
                     WindowAttention, window_partition, window_reverse)

LN_EPS = 1e-5  # flax LayerNorm(epsilon=1e-5), as the JAX package builds it
MLP_RATIO = 4  # hidden width of a block's MLP over its width


class Mlp(nn.Module):
    """Dense -> GELU (exact) -> Dense."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = Linear(dim, hidden)
        self.Dense_1 = Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch: with ``generator``, each
    sample's branch is kept with probability 1 - rate and scaled by
    1 / (1 - rate), else zeroed; without, the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        # drawn on the generator's device, so one seeded CPU generator gives
        # a CPU and a CUDA run the same masks
        u = torch.rand((x.shape[0],), generator=generator, device=generator.device)
        mask = (u < keep).to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SwinBlock(ShiftedWindows):
    """LN -> pad to the window -> cyclic shift -> W-MSA -> unshift -> crop,
    residual; LN -> MLP, residual; stochastic depth on both branches (two
    independent draws)."""

    attention = WindowAttention

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int = 0,
                 drop_path: float = 0.0):
        super().__init__(window_size, shift_size)
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS)
        self.attn = self.attention(dim, (window_size, window_size), num_heads)
        self.LayerNorm_1 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim, dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self._block(x, None, generator)

    def _block(self, x, context, generator):
        """The block on x; ``context`` (cross attention's k and v) is padded,
        shifted and partitioned with x, the mask that of x's padded grid."""
        B, H, W, C = x.shape
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        x = self.LayerNorm_0(x)
        # the context enters k and v without a norm, in the norm's dtype
        maps = [x] if context is None else [x, context.to(x.dtype)]
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            maps = [F.pad(m, (0, 0, 0, pad_r, 0, pad_b)) for m in maps]
        Hp, Wp = H + pad_b, W + pad_r
        if ss > 0:
            maps = [torch.roll(m, shifts=(-ss, -ss), dims=(1, 2)) for m in maps]
        masks, cls_idx = self._classes(Hp, Wp, B, x.device)
        wins = [window_partition(m, ws).reshape(-1, ws * ws, C) for m in maps]
        x = window_reverse(self.attn(wins[0], masks, cls_idx, *wins[1:]).reshape(-1, ws, ws, C),
                           ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W, :]
        x = shortcut + self.drop_path(x, generator)
        return x + self.drop_path(self.mlp(self.LayerNorm_1(x)), generator)


class SwinBlockCross(SwinBlock):
    """:class:`SwinBlock` with cross window attention (port of the JAX
    package's ``SwinBlockCross``): q from x, k and v from ``context``, a
    map of x's grid and width that enters without a LayerNorm and is
    padded, shifted and partitioned together with x."""

    attention = CrossWindowAttention

    def forward(self, x, context, generator: Optional[torch.Generator] = None):
        return self._block(x, context, generator)


class PatchMerging(nn.Module):
    """2x downsample: the 2x2 neighbours concatenated in the order
    (0, 0), (1, 0), (0, 1), (1, 1) of (row, column) -> LN(4C) -> Linear
    4C -> 2C, no bias. Odd sizes are padded with a zero row or column."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * dim, eps=LN_EPS)
        self.Dense_0 = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1], x.shape[2]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.Dense_0(self.LayerNorm_0(x))


class PatchSplit(nn.Module):
    """2x upsample: LN(C) -> Linear C -> 2C, no bias -> depth-to-space
    (PixelShuffle's channel order) to C / 2."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = Linear(dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.Dense_0(self.LayerNorm_0(x))
        x = x.reshape(B, H, W, C // 2, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, 2 * H, 2 * W, C // 2)


class BasicLayer(nn.Module):
    """A Swin block for each stochastic-depth rate in ``drop_path``, the
    shifts alternating 0 and window // 2, then an optional ``"merge"`` or
    ``"split"``."""

    block = SwinBlock

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 drop_path: Sequence[float], downsample: Optional[str] = None):
        super().__init__()
        self.depth = len(drop_path)
        for i, rate in enumerate(drop_path):
            self.add_module(f"block{i}", self.block(
                dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, rate))
        if downsample == "merge":
            self.downsample = PatchMerging(dim)
        elif downsample == "split":
            self.downsample = PatchSplit(dim)
        elif downsample is not None:
            raise ValueError(f"downsample {downsample!r}: None, 'merge' or 'split'")
        else:
            self.downsample = None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, generator)
        return x if self.downsample is None else self.downsample(x)


class BasicLayerCross(BasicLayer):
    """:class:`BasicLayer` of :class:`SwinBlockCross` blocks: every block
    attends to the same ``context``, at the stack's input resolution; only
    x is merged or split after them."""

    block = SwinBlockCross

    def forward(self, x, context, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, context, generator)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    """patch x patch conv with stride patch (the image padded up to a
    multiple of it), then LN: an NCHW image -> NHWC features."""

    def __init__(self, in_ch: int, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.Conv_0 = Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.LayerNorm_0 = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x):
        p = self.patch_size
        H, W = x.shape[2], x.shape[3]
        if H % p or W % p:
            x = F.pad(x, (0, (p - W % p) % p, 0, (p - H % p) % p))
        return self.LayerNorm_0(self.Conv_0(x).permute(0, 2, 3, 1))
