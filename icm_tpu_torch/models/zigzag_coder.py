"""The zigzag ChARM coding layer of the CRC family.

Port of ``icm_tpu/models/zigzag_coder.py``: one self-contained
entropy-coding layer, a hyper-encoder, mean and scale hyper-decoders,
per-slice zigzag context stacks, a bottleneck for z and a conditional
Gaussian for y, as the machine layer of ``stf9``, ``stf11``, ``stf12`` and
``stf14`` and the machine and segmentation layers of ``stf13`` use it
(``crc.py``). Its protocol (``ctx_prepare``, ``latent_slices``,
``ctx_support``, ``slice_context``, ``reconstruct``, ``ctx_assemble``,
``eb_medians``) is what the CRC codecs drive slice by slice, and
:meth:`ZigzagCharmCoder.code` is the whole training and eval loop of this
latent.

Context, as in the JAX layer: y and the hyper-decoders' outputs split
into ``num_slices`` x 2x2 zigzag blocks (``scan/zigzag.py``, the
channel-unconstrained order; the JAX layer's ``spatial_number`` and
``zigzag_constrained`` options keep their defaults in every model the
port builds, so they are constants here); slice i sees the last
``max_support`` decoded blocks (``base.sliding_support``) and a window
of ``support_num`` mean (scale) blocks starting at i, clamped at the
tail. LRP (latent residual prediction, ``apply_lrp=True``): after slice
i is reconstructed, ``y_hat += 0.5 * tanh(lrp_i(cat(mean_support,
y_hat)))``, where the mean support is slice i's conditioning window of
mean blocks and its support; the corrected slice is what later slices'
support holds. Only stf13 applies it (both of its coders). stf9, stf11,
stf12 and stf14 build the layer with ``apply_lrp=False`` (their
reference computes LRP and drops it), and flax creates no parameters
for modules never called, so those layers have no ``lrp_`` stacks.

The JAX layer's ``scan=True`` forward (``code_scan``: its AR loop as one
``lax.scan`` over stacked per-slice weights, ``_ZigzagScanStep``) keeps a
sliding buffer of the last ``max_support`` decoded blocks, oldest to
newest, zeros where a slice has fewer, and zero-pads each slice's first
convolution to that fixed width, which computes the unrolled
convolutions' function up to the order of the sums. So :meth:`code`
serves both JAX forwards: it runs the per-slice convolutions on the same
support, and a JAX tree of a scanned coder carries its context as a
``zz_scan`` subtree, which ``convert.from_jax_params(tree, model=...)``
unstacks.

:func:`stack_zigzag_params` and :func:`unstack_zigzag_params` give the
JAX ``zz_scan`` subtree's stacked, zero-padded context weights, which the
scan wire (``scan_codec.ZigzagScanWire``) applies.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn.factories import hyper_encoder, hyper_mean, shallow_cc
from ..ops import ste_round
from ..scan import zigzag_merge, zigzag_split
from .base import nchw_to_nhwc, sliding_support

_TAGS = ("cc_mean", "cc_scale", "lrp")  # the context stacks a slice can have

class ZigzagCharmCoder(nn.Module):
    # 2x2 spatial blocks a channel slice, in the channel-unconstrained
    # order: the JAX layer's settings in every port model
    spatial_number = 2
    zigzag_constrained = False

    def __init__(
        self,
        latent_dim: int = 384,
        num_slices: int = 6,
        max_support: int = 12,
        support_num: int = 24,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 64),
        apply_lrp: bool = False,
    ):
        super().__init__()
        if latent_dim % num_slices or hyper_dec_widths[-1] != latent_dim:
            raise ValueError(f"latent {latent_dim}, {num_slices} slices, hyper-decoder "
                             f"width {hyper_dec_widths[-1]}")
        self.latent_dim = latent_dim
        self.num_slices = num_slices
        self.max_support = max_support
        self.support_num = support_num
        self.apply_lrp = apply_lrp
        sc = self.slice_ch
        self.h_a = hyper_encoder(latent_dim, tuple(hyper_enc_widths))
        z_ch = hyper_enc_widths[-1]
        self.h_mean_s = hyper_mean(z_ch, tuple(hyper_dec_widths))
        self.h_scale_s = hyper_mean(z_ch, tuple(hyper_dec_widths))
        self.cond_width = self.cond_blocks * sc
        for tag in self.tags:
            for i in range(self.ctx_slices):
                # LRP sees the mean support and the slice it corrects
                cin = self.cond_width + sc * min(i, max_support) + (sc if tag == "lrp" else 0)
                self.add_module(f"{tag}_{i}", shallow_cc(cin, sc, tuple(cc_widths)))
        self.entropy_bottleneck = EntropyBottleneck(z_ch)
        self.gaussian_conditional = GaussianConditional()

    @property
    def tags(self) -> Tuple[str, ...]:
        """The context stacks each slice has."""
        return _TAGS if self.apply_lrp else _TAGS[:2]

    @property
    def ctx_slices(self) -> int:
        return self.num_slices * self.spatial_number ** 2

    @property
    def slice_ch(self) -> int:
        return self.latent_dim // self.num_slices

    @property
    def cond_blocks(self) -> int:
        """The conditioning window in zigzag blocks."""
        return min(self.support_num, self.ctx_slices)

    # --- protocol pieces -------------------------------------------------------
    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        n = self.spatial_number
        return list(zigzag_split(t, self.num_slices, n, n, self.zigzag_constrained).unbind(1))

    def ctx_prepare(self, z_hat):
        return {"means": self._split(self.h_mean_s(z_hat)),
                "scales": self._split(self.h_scale_s(z_hat))}

    def latent_slices(self, y):
        return self._split(y)

    def ctx_support(self, i: int, decoded: list) -> list:
        return sliding_support(self.max_support)(i, decoded)

    def _cond(self, blocks: list, i: int) -> list:
        """Slice i's window of mean (scale) blocks [i, i + w), clamped at
        the tail."""
        n, w = self.ctx_slices, self.cond_blocks
        return blocks[n - w:] if i + w > n else blocks[i:i + w]

    def slice_context(self, i, state, support):
        """Slice i's (mu, scale, mean support)."""
        mean_support = torch.cat(self._cond(state["means"], i) + support, 1)
        mu = getattr(self, f"cc_mean_{i}")(mean_support)
        scale = getattr(self, f"cc_scale_{i}")(
            torch.cat(self._cond(state["scales"], i) + support, 1))
        return mu, scale, mean_support

    def slice_lrp(self, i: int, mean_support: torch.Tensor, y_hat_slice: torch.Tensor):
        """Slice i's latent residual prediction, added to its y_hat."""
        lrp = getattr(self, f"lrp_{i}")(torch.cat([mean_support, y_hat_slice], 1))
        return 0.5 * torch.tanh(lrp)

    @staticmethod
    def reconstruct(sym: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        """A slice's y_hat from its integer symbols."""
        return sym.to(mu.dtype) + mu

    def ctx_assemble(self, y_hat_slices):
        n = self.spatial_number
        return zigzag_merge(torch.stack(y_hat_slices, dim=1), self.num_slices, n, n,
                            self.zigzag_constrained)

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()[:, 0, 0]

    # --- the whole loop of this latent ------------------------------------------
    def code(self, y: torch.Tensor, generator: Optional[torch.Generator] = None):
        """y (B, M, h, w) -> (y_hat, {"y": ..., "z": ...}), the likelihoods
        NHWC as the models return them; noise drawn from ``generator`` (the
        training forward), none without (the eval forward). It is JAX's
        ``code``, and its ``code_scan`` up to the order of the sums (module
        docstring)."""
        z = self.h_a(y)
        _, z_likelihoods = self.entropy_bottleneck(z, generator)
        z_offset = self.eb_medians().reshape(1, -1, 1, 1)
        z_hat = ste_round(z - z_offset) + z_offset

        state = self.ctx_prepare(z_hat)
        y_slices = self.latent_slices(y)
        y_hat_slices: List[torch.Tensor] = []
        y_likelihood = []
        for i in range(self.ctx_slices):
            support = self.ctx_support(i, y_hat_slices)
            mu, scale, mean_support = self.slice_context(i, state, support)
            _, lik = self.gaussian_conditional(y_slices[i], scale, mu, generator)
            y_likelihood.append(lik)
            y_hat_slice = ste_round(y_slices[i] - mu) + mu
            if self.apply_lrp:
                y_hat_slice = y_hat_slice + self.slice_lrp(i, mean_support, y_hat_slice)
            y_hat_slices.append(y_hat_slice)
        y_hat = self.ctx_assemble(y_hat_slices)
        return y_hat, {"y": nchw_to_nhwc(torch.cat(y_likelihood, dim=1)),
                       "z": nchw_to_nhwc(z_likelihoods)}


# --- stacked context weights (JAX's ``zz_scan`` subtree, the scan wire's) ----

def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def _in_axis(leaf: str) -> int:
    """Input-channel axis of a conv kernel: the port's ``weight`` (O, I, kH,
    kW), the JAX package's ``kernel`` (kH, kW, I, O)."""
    return 1 if leaf == "weight" else 2


def _per_slice(params) -> dict:
    """A coder, its state dict, or nested dicts in either layout -> nested
    dicts ``{"cc_mean_{i}": {"Conv_j": {leaf: tensor}}}`` of its context
    stacks."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    out: dict = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            path = prefix + tuple(key.split("."))
            if isinstance(value, dict):
                walk(value, path)
            elif path[0].rsplit("_", 1)[0] in _TAGS:
                node = out
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = _as_tensor(value)

    walk(params, ())
    return out


def _first_conv(k: torch.Tensor, ax: int, i: int, coder, pad: bool, tag: str) -> torch.Tensor:
    """Slice i's first-conv kernel (input channels on ``ax``) padded to the
    scan's fixed width: the conditioning, then ``max_support`` support
    slots with the decoded blocks in the last ``min(i, max_support)`` of
    them (the oldest slots, not decoded yet, zero), then for ``lrp`` the
    slice it corrects; or, with ``pad=False``, the padding cut away
    again."""
    sc, cond = coder.slice_ch, coder.cond_width
    sup_w = coder.max_support * sc
    have = min(i, coder.max_support) * sc
    tail = sc if tag == "lrp" else 0
    if not pad:
        return torch.cat([k.narrow(ax, 0, cond), k.narrow(ax, cond + sup_w - have, have),
                          k.narrow(ax, cond + sup_w, tail)], ax).contiguous()
    shape = list(k.shape)
    shape[ax] = cond + sup_w + tail
    out = k.new_zeros(shape)
    out.narrow(ax, 0, cond).copy_(k.narrow(ax, 0, cond))
    out.narrow(ax, cond + sup_w - have, have).copy_(k.narrow(ax, cond, have))
    out.narrow(ax, cond + sup_w, tail).copy_(k.narrow(ax, cond + have, tail))
    return out


def stack_zigzag_params(params, coder: ZigzagCharmCoder) -> dict:
    """Per-slice context stacks -> ``{"zz_scan": {tag: {"Conv_j": {leaf:
    stacked}}}}``, each leaf stacked over the slices on a new first axis.
    Port of ``icm_tpu/models/zigzag_coder.py::stack_zigzag_params``: only
    ``Conv_0`` changes shape, zero-padded to ``cond_width + max_support *
    slice_ch`` input channels, the support in the last slots, where the
    scan's sliding buffer holds the decoded blocks (``lrp``: and the
    slice it corrects after them, JAX's ``tail``). ``params``: the coder,
    its state dict (``weight``) or nested dicts in either layout (the JAX
    package's ``kernel``); ``coder``: its configuration, whose
    ``apply_lrp`` says whether an ``lrp`` slot is stacked."""
    src = _per_slice(params)
    out: dict = {}
    for tag in coder.tags:
        out[tag] = {}
        for ln in src[f"{tag}_0"]:
            out[tag][ln] = {}
            for leaf in src[f"{tag}_0"][ln]:
                slices = []
                for i in range(coder.ctx_slices):
                    k = src[f"{tag}_{i}"][ln][leaf]
                    if ln == "Conv_0" and leaf != "bias":
                        k = _first_conv(k, _in_axis(leaf), i, coder, True, tag)
                    slices.append(k)
                out[tag][ln][leaf] = torch.stack(slices)
    return {"zz_scan": out}


def unstack_zigzag_params(stacked: dict, coder: ZigzagCharmCoder) -> dict:
    """Inverse of :func:`stack_zigzag_params` (port of the JAX package's
    ``unstack_zigzag_params``): ``{"zz_scan": ...}`` -> nested per-slice
    dicts ``{"cc_mean_{i}": {"Conv_j": {leaf: tensor}}}`` with the padding
    cut away, in the layout it came in."""
    out: dict = {}
    for tag, layers in stacked["zz_scan"].items():
        for i in range(coder.ctx_slices):
            tree = {}
            for ln, p in layers.items():
                tree[ln] = {}
                for leaf, v in p.items():
                    k = _as_tensor(v)[i]
                    if ln == "Conv_0" and leaf != "bias":
                        k = _first_conv(k, _in_axis(leaf), i, coder, False, tag)
                    tree[ln][leaf] = k.contiguous()
            out[f"{tag}_{i}"] = tree
    return out
