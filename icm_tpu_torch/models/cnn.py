"""WACNN: window-attention CNN codec with ChARM context (registry "cnn").

Port of ``icm_tpu/models/cnn.py`` (training and eval forwards and the
protocol the coder calls; the JAX ``scan_charm`` training forward, a
single-compile workaround with the same numerics, is not ported, but its
stacked context weights are: :func:`stack_charm_params` and
:func:`unstack_charm_params`, which the scan wire and
``convert.from_jax_params`` use): conv +
GDN + window-attention analysis and synthesis, a conv hyper-encoder, mean
and scale hyper-decoders, and a channel-autoregressive context over
``num_slices`` slices with first-``max_support_slices`` support and
latent-residual prediction (LRP, 0.5 * tanh). Submodule names follow the
flax tree (``g_a.Conv_0``, ``cc_mean_3.Conv_4`` ...). The hyper and
context part (:class:`ChannelCharm`) is stf's too.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn import (
    GDN,
    SubpelConv,
    Win_noShift_Attention,
    conv,
    conv3x3,
    deconv,
    named_sequential,
)
from .base import CompressionModel, prefix_support


class _Gelu(nn.Module):
    def forward(self, x):
        return F.gelu(x)


def _analysis(N: int, M: int) -> nn.Sequential:
    return named_sequential(
        conv(3, N, 5, 2), GDN(N),
        conv(N, N, 5, 2), GDN(N),
        Win_noShift_Attention(N, num_heads=8, window_size=8, shift_size=4),
        conv(N, N, 5, 2), GDN(N),
        conv(N, M, 5, 2),
        Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
    )


def _synthesis(N: int, M: int, out_ch: int = 3) -> nn.Sequential:
    return named_sequential(
        Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
        deconv(M, N, 5, 2), GDN(N, inverse=True),
        deconv(N, N, 5, 2), GDN(N, inverse=True),
        Win_noShift_Attention(N, num_heads=8, window_size=8, shift_size=4),
        deconv(N, N, 5, 2), GDN(N, inverse=True),
        deconv(N, out_ch, 5, 2),
    )


def _hyper_encoder(in_ch: int, widths: tuple) -> nn.Sequential:
    """3x3 convs with strides 1, 1, 2, 1, 2 and GELU between."""
    layers, c = [], in_ch
    for i, (w, s) in enumerate(zip(widths, (1, 1, 2, 1, 2))):
        if i > 0:
            layers.append(_Gelu())
        layers.append(conv3x3(c, w, stride=s))
        c = w
    return named_sequential(*layers)


def _hyper_decoder(in_ch: int, widths: tuple) -> nn.Sequential:
    """conv + sub-pixel 2x upsample stack (h_mean_s / h_scale_s)."""
    w = widths
    return named_sequential(
        conv3x3(in_ch, w[0]), _Gelu(),
        SubpelConv(w[0], w[1], r=2), _Gelu(),
        conv3x3(w[1], w[2]), _Gelu(),
        SubpelConv(w[2], w[3], r=2), _Gelu(),
        conv3x3(w[3], w[4]),
    )


def _cc_transform(in_ch: int, out_ch: int, widths: tuple) -> nn.Sequential:
    """Per-slice context stack: 3x3 convs with GELU between."""
    layers, c = [], in_ch
    for w in widths:
        layers += [conv(c, w, kernel_size=3, stride=1), _Gelu()]
        c = w
    layers.append(conv(c, out_ch, kernel_size=3, stride=1))
    return named_sequential(*layers)


class ChannelCharm(CompressionModel):
    """The part of the ChARM protocol that WACNN and stf share: a conv
    hyper-encoder ``h_a``, mean and scale hyper-decoders, and per slice a
    mean, a scale and an LRP context stack over the hyper-decoders' output
    and the first ``max_support_slices`` decoded slices. A subclass builds
    ``g_a`` and ``g_s`` first (parameters are drawn in module order), then
    calls :meth:`_build_context`, and supplies ``analyze`` (through ``h_a``)
    and ``synthesize``."""

    def _build_context(self, M: int, num_slices: int, max_support_slices: int,
                       hyper_enc_widths: tuple, hyper_dec_widths: tuple,
                       cc_widths: tuple) -> None:
        if M % num_slices:
            raise ValueError(f"M={M} does not split into {num_slices} slices")
        self.M = M
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        self.h_a = _hyper_encoder(M, hyper_enc_widths)
        z_ch = hyper_enc_widths[-1]
        self.h_mean_s = _hyper_decoder(z_ch, hyper_dec_widths)
        self.h_scale_s = _hyper_decoder(z_ch, hyper_dec_widths)
        sc = M // num_slices
        cond = hyper_dec_widths[-1]
        for i in range(num_slices):
            sup = sc * (i if max_support_slices < 0 else min(i, max_support_slices))
            self.add_module(f"cc_mean_{i}", _cc_transform(cond + sup, sc, cc_widths))
            self.add_module(f"cc_scale_{i}", _cc_transform(cond + sup, sc, cc_widths))
            self.add_module(f"lrp_{i}", _cc_transform(cond + sup + sc, sc, cc_widths))
        self.entropy_bottleneck = EntropyBottleneck(z_ch)
        self.gaussian_conditional = GaussianConditional()

    # --- ChARM protocol (see base.CompressionModel) --------------------------
    def ctx_prepare(self, z_hat):
        return {"means": self.h_mean_s(z_hat), "scales": self.h_scale_s(z_hat)}

    def latent_slices(self, y):
        return list(torch.chunk(y, self.num_slices, dim=1))

    @property
    def ctx_slices(self) -> int:
        return self.num_slices

    def ctx_support(self, i: int, decoded: list) -> list:
        return prefix_support(self.max_support_slices)(i, decoded)

    def slice_context(self, i, state, support):
        mean_support = torch.cat([state["means"]] + support, dim=1)
        mu = getattr(self, f"cc_mean_{i}")(mean_support)
        scale_support = torch.cat([state["scales"]] + support, dim=1)
        scale = getattr(self, f"cc_scale_{i}")(scale_support)
        return mu, scale, mean_support

    def slice_lrp(self, i, mean_support, y_hat_slice):
        lrp_support = torch.cat([mean_support, y_hat_slice], dim=1)
        return 0.5 * torch.tanh(getattr(self, f"lrp_{i}")(lrp_support))

    def ctx_assemble(self, y_hat_slices):
        return torch.cat(y_hat_slices, dim=1)


class WACNN(ChannelCharm):
    def __init__(
        self,
        N: int = 192,
        M: int = 320,
        num_slices: int = 10,
        max_support_slices: int = 5,
        hyper_enc_widths: tuple = (320, 288, 256, 224, 192),
        hyper_dec_widths: tuple = (192, 224, 256, 288, 320),
        cc_widths: tuple = (224, 176, 128, 64),
    ):
        super().__init__()
        self.N = N
        self.g_a = _analysis(N, M)
        self.g_s = _synthesis(N, M)
        self._build_context(M, num_slices, max_support_slices, hyper_enc_widths,
                            hyper_dec_widths, cc_widths)

    def analyze(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def synthesize(self, y_hat):
        return self.g_s(y_hat)


# --- stacked context weights (the scan wire's and JAX's ``charm_scan``) ------

CHARM_TAGS = ("cc_mean", "cc_scale", "lrp")
_SLICE_KEY = re.compile(r"^(cc_mean|cc_scale|lrp)_(\d+)\.(\w+)\.(weight|bias|kernel)$")


def _in_axis(leaf: str) -> int:
    """Input-channel axis of one slice's conv kernel: the port's ``weight``
    is (O, I, kH, kW), the JAX package's ``kernel`` (kH, kW, I, O)."""
    return 1 if leaf == "weight" else 2


def _support_width(tag: str, i: int, slice_ch: int, max_support: int, cond_width: int) -> int:
    """Input width of slice i's first conv: the conditioning, its prefix
    support, and for LRP its own slice last."""
    return cond_width + slice_ch * min(i, max_support) + (slice_ch if tag == "lrp" else 0)


def _nested(params) -> dict:
    """A ChannelCharm module, its state dict, or nested dicts
    ``{"cc_mean_0": {"Conv_0": {"weight": ...}}}`` -> the nested form of
    the context stacks' parameters, as tensors."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    out: dict = {}
    for key, value in params.items():
        if isinstance(value, dict):
            if key.rsplit("_", 1)[0] in CHARM_TAGS:
                out[key] = {ln: {leaf: torch.as_tensor(v) for leaf, v in p.items()}
                            for ln, p in value.items()}
            continue
        m = _SLICE_KEY.match(key)
        if m:
            tag, i, ln, leaf = m.groups()
            out.setdefault(f"{tag}_{i}", {}).setdefault(ln, {})[leaf] = torch.as_tensor(value)
    return out


def _layer_names(layers) -> list:
    return sorted(layers, key=lambda n: int(n.split("_")[1]))


def stack_charm_params(params, num_slices: int, slice_ch: int, max_support: int,
                       cond_width: int) -> dict:
    """Per-slice context stacks (``cc_mean_{i}``, ``cc_scale_{i}``,
    ``lrp_{i}``) -> ``{"charm_scan": {tag: {layer: {leaf: stacked}}}}``,
    each leaf stacked over the slices on a new first axis, the first conv's
    input channels zero-padded to the scanned support width
    ``cond_width + max_support * slice_ch`` (LRP: its own slice last). Port
    of ``icm_tpu/models/cnn.py::stack_charm_params``: the zero blocks meet
    the zero support slots the scan has not filled, so the outputs are the
    unrolled ones. ``params``: a ChannelCharm, its state dict (port
    layout, ``weight``) or nested dicts in either layout (the JAX
    package's ``kernel``)."""
    src = _nested(params)
    sup_max = max_support * slice_ch
    out: dict = {}
    for tag in CHARM_TAGS:
        out[tag] = {}
        for ln in _layer_names(src[f"{tag}_0"]):
            out[tag][ln] = {}
            for leaf in src[f"{tag}_0"][ln]:
                slices = []
                for i in range(num_slices):
                    k = src[f"{tag}_{i}"][ln][leaf]
                    if ln == "Conv_0" and leaf != "bias":
                        ax = _in_axis(leaf)
                        n_in = k.shape[ax]
                        shape = list(k.shape)
                        shape[ax] = cond_width + sup_max + (slice_ch if tag == "lrp" else 0)
                        kn = k.new_zeros(shape)
                        if tag == "lrp":
                            kn.narrow(ax, 0, n_in - slice_ch).copy_(k.narrow(ax, 0, n_in - slice_ch))
                            kn.narrow(ax, shape[ax] - slice_ch, slice_ch).copy_(
                                k.narrow(ax, n_in - slice_ch, slice_ch))
                        else:
                            kn.narrow(ax, 0, n_in).copy_(k)
                        k = kn
                    slices.append(k)
                out[tag][ln][leaf] = torch.stack(slices)
    return {"charm_scan": out}


def unstack_charm_params(stacked: dict, num_slices: int, slice_ch: int, max_support: int,
                         cond_width: int) -> dict:
    """Inverse of :func:`stack_charm_params` (port of the JAX package's
    ``unstack_charm_params``): ``{"charm_scan": ...}`` -> nested per-slice
    dicts ``{"cc_mean_{i}": {layer: {leaf: tensor}}}`` with the padded
    support channels cut away, in the layout it came in."""
    sub = stacked["charm_scan"]
    out: dict = {}
    for tag in CHARM_TAGS:
        for i in range(num_slices):
            layers = {}
            for ln, p in sub[tag].items():
                layers[ln] = {}
                for leaf, v in p.items():
                    k = torch.as_tensor(v)[i]
                    if ln == "Conv_0" and leaf != "bias":
                        ax = _in_axis(leaf)
                        width = _support_width(tag, i, slice_ch, max_support, cond_width)
                        if tag == "lrp":
                            k = torch.cat([k.narrow(ax, 0, width - slice_ch),
                                           k.narrow(ax, k.shape[ax] - slice_ch, slice_ch)], ax)
                        else:
                            k = k.narrow(ax, 0, width)
                    layers[ln][leaf] = k.contiguous()
            out[f"{tag}_{i}"] = layers
    return out
