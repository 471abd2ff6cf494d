"""czigzag: the cross-attention conditional codec (registry "czigzag").

Port of ``icm_tpu/models/czigzag.py`` (``conditionalZigzag``, the
reference's ``conditionalZigzag``). Beside x the model takes a second
image, ``up_x4`` (in the reference a GAN-upsampled reconstruction of a
base layer), which both coder sides have:

- ``up_x4`` is patch-embedded by x's own ``patch_embed`` and taken down
  three pyramids of stride-2 3x3 convolutions (``encoder_context_i``,
  ``hyper_context_i``, ``decoder_context_i``: parameters of their own
  each); every Swin stage of the analysis, the synthesis (its pyramid in
  reverse) and both hyper stacks attends to its level through cross
  window attention (``nn/swin.py``: ``BasicLayerCross``, q from the
  features, k and v from the context);
- the hyper-codec is Swin stacks at two scales: ``hyper_enc0`` over y
  (M = 384 channels, 4 heads: head width 96) and ``hyper_enc1`` over M / 2
  (head width 48) with a 3x3 conv between and a stride-2 one to z; the
  mean and scale decoders mirror it (a sub-pixel x2 conv, a stack at M /
  2, a conv, a stack at M);
- the entropy context is the zigzag one of ``stf8`` (4 channel slices x
  2x2 spatial blocks = 16 steps of 96 channels, channel-unconstrained,
  sliding support of ``max_support`` decoded blocks, a window of
  ``support_num`` mean (scale) blocks clamped at the tail) with a third
  conditioning: the same window of the zigzag blocks of ``hyper_ctx``
  (the hyper pyramid's top), after the support. LRP is applied in the
  loop: ``y_hat += 0.5 tanh(lrp_i(cat(mean support, y_hat)))``.

Submodules carry the flax names (``layer2.block3.attn.kv``,
``hyper_dec_mean1``, ``cc_mean_7.Conv_0`` ...), so
``convert.from_jax_params`` maps a JAX tree one to one. Swin features are
channel-last as in ``nn/swin.py``; the latents, the coder-facing stages'
tensors and the context stacks are NCHW; ``forward`` takes the JAX
package's NHWC images and returns NHWC.

The JAX package has two training forwards, the unrolled loop and
``scan_charm=True`` (``_CzigzagScanStep`` under ``nn.scan``: per-slice
weights stacked, the first convolution zero-padded to the scan's fixed
support width), which compute the same function up to the order of the
sums. The port's one forward serves both; a JAX tree of the scanned model
carries the context stacks as a ``czigzag_scan`` subtree, which
``convert.from_jax_params(tree, model=...)`` unstacks
(:func:`unstack_czigzag_params`). :func:`stack_czigzag_params` builds that
subtree; its padded kernels, ``[cond window | support, right-aligned |
hctx window (+ y_hat for LRP)]``, are what the scan wire
(``scan_codec.CzigzagScanWire``) applies.

The stages the codec calls (``crc_codec.CzigzagCodec``): ``ctx_pyramids``,
``analyze_cond``, ``hyper_encode``, ``hyper_decode``,
``ctx_prepare_cond``, ``latent_slices``, ``slice_context``,
``slice_lrp``, ``ctx_assemble``, ``synthesize_cond``. Stochastic depth
(``drop_path_rate`` over the analysis and synthesis blocks; the hyper
stacks have none, as in JAX, and take no generator) draws from the
forward's ``generator``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn import SubpelConv, conv3x3
from ..nn.factories import shallow_cc
from ..nn.swin import BasicLayerCross, PatchEmbed
from ..ops import ste_round
from ..scan import zigzag_merge, zigzag_split
from .base import CompressionModel, nchw_to_nhwc, nhwc_to_nchw, sliding_support
from .stf import _drop_path_rates
from .zigzag_coder import stack_zigzag_params, unstack_zigzag_params


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW convolution on channel-last features."""
    return nchw_to_nhwc(conv(nhwc_to_nchw(x)))


class conditionalZigzag(CompressionModel):
    # the context stacks each slice has (zigzag_coder's stacking helpers and
    # crc_codec._CharmLayerDriver read them, and ``tail_width``)
    tags = ("cc_mean", "cc_scale", "lrp")
    apply_lrp = True
    # positional inputs after x: up_x4 (the training steps take (x, up_x4)
    # batches)
    conditioning_inputs = 1

    def __init__(
        self,
        embed_dim: int = 48,
        depths: Tuple[int, ...] = (2, 2, 6, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 4,
        patch_size: int = 2,
        drop_path_rate: float = 0.2,
        num_slices: int = 4,
        max_support: int = 6,
        support_num: int = 6,
        hyper_depths: Tuple[int, ...] = (2, 6),
        cc_widths: Tuple[int, ...] = (224, 176, 128, 64),
    ):
        super().__init__()
        n = len(depths)
        self.n_stages = n
        self.num_slices = num_slices
        self.max_support = max_support
        self.support_num = support_num
        self.latent_dim = M = embed_dim * 2 ** (n - 1)
        if M % num_slices:
            raise ValueError(f"M={M} does not split into {num_slices} slices")
        half = M // 2
        self.slice_ch = sc = M // num_slices
        self.cond_width = self.cond_blocks * sc
        # the first convolutions' hyper-context window, after the support
        self.tail_width = self.cond_width

        self.patch_embed = PatchEmbed(3, patch_size, embed_dim)
        for i, rates in enumerate(_drop_path_rates(tuple(depths), drop_path_rate)):
            self.add_module(f"layer{i}", BasicLayerCross(
                embed_dim * 2 ** i, num_heads[i], window_size, rates,
                downsample="merge" if i < n - 1 else None))
        rdepths, rheads = tuple(reversed(depths)), tuple(reversed(num_heads))
        for i, rates in enumerate(_drop_path_rates(rdepths, drop_path_rate)):
            self.add_module(f"syn_layer{i}", BasicLayerCross(
                embed_dim * 2 ** (n - 1 - i), rheads[i], window_size, rates,
                downsample="split" if i < n - 1 else None))
        for tag in ("encoder_context", "hyper_context", "decoder_context"):
            for i in range(n - 1):
                self.add_module(f"{tag}_{i}", conv3x3(embed_dim * 2 ** i,
                                                      embed_dim * 2 ** (i + 1), stride=2))

        def hyper_stack(dim: int, depth: int) -> BasicLayerCross:
            return BasicLayerCross(dim, 4, window_size, [0.0] * depth)

        self.hyper_enc0 = hyper_stack(M, hyper_depths[0])
        self.hyper_enc1 = hyper_stack(half, hyper_depths[1])
        self.hyper_encoder_conv1 = conv3x3(M, half)
        self.hyper_encoder_conv1_2 = conv3x3(M, half)
        self.hyper_encoder_conv2 = conv3x3(half, half, stride=2)
        for tag in ("mean", "scale"):
            self.add_module(f"hyper_dec_{tag}0", hyper_stack(half, hyper_depths[0]))
            self.add_module(f"hyper_dec_{tag}1", hyper_stack(M, hyper_depths[1]))
            self.add_module(f"hyper_decoder_conv_{tag}1", SubpelConv(half, half, r=2))
            self.add_module(f"hyper_decoder_conv_{tag}2", conv3x3(half, M))

        for tag in self.tags:
            for i in range(self.ctx_slices):
                # [mean (scale) window | support | hyper-context window]; LRP:
                # the mean support and the slice it corrects
                cin = 2 * self.cond_width + sc * min(i, max_support) + (sc if tag == "lrp" else 0)
                self.add_module(f"{tag}_{i}", shallow_cc(cin, sc, tuple(cc_widths)))

        self.entropy_bottleneck = EntropyBottleneck(half)
        self.gaussian_conditional = GaussianConditional()
        self.end_up = SubpelConv(embed_dim, embed_dim, r=patch_size, kernel_size=5)
        # flax's nn.Conv without a dtype (icm_tpu/models/czigzag.py:232):
        # float32 under every activation policy, its input promoted
        self.end_to_rgb = nn.Conv2d(embed_dim, 3, 3, padding=1)

    @property
    def ctx_slices(self) -> int:
        return self.num_slices * 4

    @property
    def cond_blocks(self) -> int:
        """The mean, scale and hyper-context windows in zigzag blocks."""
        return min(self.support_num, self.ctx_slices)

    # --- helpers ---------------------------------------------------------------
    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        return list(zigzag_split(t, self.num_slices, 2, 2, False).unbind(1))

    def _window(self, blocks: list, i: int) -> list:
        """Blocks [i, i + w), clamped at the tail to the last w."""
        n, w = self.ctx_slices, self.cond_blocks
        return blocks[n - w:] if i + w > n else blocks[i:i + w]

    # --- coder-facing stages ---------------------------------------------------
    def ctx_pyramids(self, up_x4: torch.Tensor):
        """up_x4 (B, 3, H, W) -> the conditioning both sides derive: (the
        analysis stages' contexts, hyper_ctx, hyper_ctx2, the decoder's
        contexts), channel-last."""
        ctx = self.patch_embed(up_x4)  # x's own embedding
        ctx_list, hyper_ctx, dec = [ctx], ctx, [ctx]
        for i in range(self.n_stages - 1):
            ctx_list.append(_conv_nhwc(getattr(self, f"encoder_context_{i}"), ctx_list[-1]))
            hyper_ctx = _conv_nhwc(getattr(self, f"hyper_context_{i}"), hyper_ctx)
            dec.append(_conv_nhwc(getattr(self, f"decoder_context_{i}"), dec[-1]))
        return ctx_list, hyper_ctx, _conv_nhwc(self.hyper_encoder_conv1, hyper_ctx), dec

    def analyze_cond(self, x, ctx_list, generator: Optional[torch.Generator] = None):
        """x (B, 3, H, W) -> y (B, M, H / 16, W / 16)."""
        h = self.patch_embed(x)
        for i in range(self.n_stages):
            h = getattr(self, f"layer{i}")(h, ctx_list[i], generator)
        return nhwc_to_nchw(h)

    def hyper_encode(self, y, hyper_ctx, hyper_ctx2):
        """y (NCHW) -> z (NCHW, M / 2 channels at half y's grid)."""
        z = self.hyper_enc0(nchw_to_nhwc(y), hyper_ctx)
        z = _conv_nhwc(self.hyper_encoder_conv1_2, z)
        z = self.hyper_enc1(z, hyper_ctx2)
        return self.hyper_encoder_conv2(nhwc_to_nchw(z))

    def hyper_decode(self, z_hat, hyper_ctx, hyper_ctx2):
        """z_hat (NCHW) -> (latent means, latent scales), NCHW."""
        out = []
        for tag in ("mean", "scale"):
            h = nchw_to_nhwc(getattr(self, f"hyper_decoder_conv_{tag}1")(z_hat))
            h = getattr(self, f"hyper_dec_{tag}0")(h, hyper_ctx2)
            h = _conv_nhwc(getattr(self, f"hyper_decoder_conv_{tag}2"), h)
            out.append(nhwc_to_nchw(getattr(self, f"hyper_dec_{tag}1")(h, hyper_ctx)))
        return out[0], out[1]

    def ctx_prepare_cond(self, z_hat, hyper_ctx, hyper_ctx2) -> dict:
        """The context state: the zigzag blocks of the means, the scales and
        hyper_ctx."""
        means, scales = self.hyper_decode(z_hat, hyper_ctx, hyper_ctx2)
        return {"means": self._split(means), "scales": self._split(scales),
                "hctx": self._split(nhwc_to_nchw(hyper_ctx))}

    # the name the coder drivers call (crc_codec._CharmLayerDriver)
    ctx_prepare = ctx_prepare_cond

    def latent_slices(self, y) -> List[torch.Tensor]:
        return self._split(y)

    def ctx_support(self, i: int, decoded: list) -> list:
        return sliding_support(self.max_support)(i, decoded)

    def slice_context(self, i: int, state: dict, support: list):
        """Slice i's (mu, scale, mean support)."""
        hctx = self._window(state["hctx"], i)
        mean_support = torch.cat(self._window(state["means"], i) + support + hctx, 1)
        mu = getattr(self, f"cc_mean_{i}")(mean_support)
        scale = getattr(self, f"cc_scale_{i}")(
            torch.cat(self._window(state["scales"], i) + support + hctx, 1))
        return mu, scale, mean_support

    def slice_lrp(self, i: int, mean_support, y_hat_slice):
        """Slice i's latent residual prediction, added to its y_hat."""
        lrp = getattr(self, f"lrp_{i}")(torch.cat([mean_support, y_hat_slice], 1))
        return 0.5 * torch.tanh(lrp)

    @staticmethod
    def reconstruct(sym: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        """A slice's y_hat (before LRP) from its integer symbols."""
        return sym.to(mu.dtype) + mu

    def ctx_assemble(self, y_hat_slices) -> torch.Tensor:
        return zigzag_merge(torch.stack(list(y_hat_slices), dim=1), self.num_slices, 2, 2, False)

    def synthesize_cond(self, y_hat, decoder_contexts, generator=None):
        """y_hat (NCHW) -> x_hat (B, 3, H, W), the decoder's pyramid in
        reverse."""
        n = self.n_stages
        h = nchw_to_nhwc(y_hat)
        for i in range(n):
            h = getattr(self, f"syn_layer{i}")(h, decoder_contexts[n - 1 - i], generator)
        h = self.end_up(nhwc_to_nchw(h))
        return self.end_to_rgb(h.to(torch.promote_types(h.dtype, torch.float32)))

    def forward(self, x: torch.Tensor, up_x4: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """x, up_x4: (B, H, W, 3) -> {"x_hat": (B, H, W, 3), "likelihoods":
        {"y", "z"}} (NHWC). With ``generator`` (the training forward) the
        likelihoods of the latents plus uniform noise drawn from it and
        stochastic depth drawn from it; without (the eval forward), of the
        latents rounded. z_hat and the y_hat slices are STE-rounded in
        both."""
        ctx_list, hyper_ctx, hyper_ctx2, dec = self.ctx_pyramids(nhwc_to_nchw(up_x4))
        y = self.analyze_cond(nhwc_to_nchw(x), ctx_list, generator)
        z = self.hyper_encode(y, hyper_ctx, hyper_ctx2)
        _, z_likelihoods = self.entropy_bottleneck(z, generator)
        z_off = self.eb_medians().reshape(1, -1, 1, 1)
        z_hat = ste_round(z - z_off) + z_off

        state = self.ctx_prepare_cond(z_hat, hyper_ctx, hyper_ctx2)
        y_slices = self.latent_slices(y)
        y_hat_slices: List[torch.Tensor] = []
        y_likelihood = []
        for i in range(self.ctx_slices):
            mu, scale, mean_support = self.slice_context(
                i, state, self.ctx_support(i, y_hat_slices))
            _, lik = self.gaussian_conditional(y_slices[i], scale, mu, generator)
            y_likelihood.append(lik)
            y_hat_slice = ste_round(y_slices[i] - mu) + mu
            y_hat_slices.append(y_hat_slice + self.slice_lrp(i, mean_support, y_hat_slice))
        x_hat = self.synthesize_cond(self.ctx_assemble(y_hat_slices), dec, generator)
        return {"x_hat": nchw_to_nhwc(x_hat),
                "likelihoods": {"y": nchw_to_nhwc(torch.cat(y_likelihood, dim=1)),
                                "z": nchw_to_nhwc(z_likelihoods)}}


# --- stacked context weights (JAX's ``czigzag_scan`` subtree, the scan wire's) ------

def stack_czigzag_params(params, model: conditionalZigzag) -> dict:
    """Per-slice context stacks -> ``{"czigzag_scan": {tag: {"Conv_j": {leaf:
    stacked}}}}``, each leaf stacked over the slices on a new first axis.
    Port of ``icm_tpu/models/czigzag.py::stack_czigzag_params``: ``Conv_0``
    zero-padded to ``[cond window | max_support support slots, the decoded
    blocks in the last ones | hctx window (+ y_hat for lrp)]``.
    ``params``: the model, its state dict (``weight``) or nested dicts in
    either layout (the JAX package's ``kernel``)."""
    return {"czigzag_scan": stack_zigzag_params(params, model)["zz_scan"]}


def unstack_czigzag_params(stacked: dict, model: conditionalZigzag) -> dict:
    """Inverse of :func:`stack_czigzag_params`: -> nested per-slice dicts
    ``{"cc_mean_{i}": {"Conv_j": {leaf: tensor}}}``, the padding cut away,
    in the layout they came in."""
    return unstack_zigzag_params({"zz_scan": stacked["czigzag_scan"]}, model)
