"""The conditional residual coding family: ``stf9`` / ``stf11``, ``stf12``,
``stf13`` and ``stf14``.

Port of ``icm_tpu/models/crc.py`` (``ConditionalResidualCoding``,
``ConditionalResidualCoding2``, ``ConditionalResidualCoding3``,
``ResidualCoding`` and the modules they are built of). A layered codec
for machines and humans:

- the machine layer (:class:`_MachineLayer`): ``MainCNNEncoder`` to
  y (M channels at /16), coded by the zigzag ChARM coder
  (``zigzag_coder.ZigzagCharmCoder``: 6 x 2x2 zigzag blocks, sliding
  support 12, a conditioning window of 24 blocks, 5-conv context stacks,
  LRP not applied), decoded by the split decoder ``g_s1``, ``g_s2`` to
  ``machine_x_hat``;
- the human layer: a second latent, coded one-shot by its own hyperprior
  (:class:`_SimpleHyper`), from an encoder and to a decoder that are
  conditioned on the machine latent y_hat:

  - stf9: the decoder side's conditioning image ``human_g_s2(y_hat)`` (a
    whole ``MainCNNDecoder``), an encoder of ``cat(x, cond)``, a decoder
    of ``cat(human_y_hat, context(y_hat))``;
  - stf14: the same conditioning image, an encoder of the residual
    ``cond - x``, the decoder ``cond - human_g_s(human_y_hat)``;
  - stf12 (:class:`ConditionalResidualCoding2`): two conditioning
    signals, an image (``human_g_enc2``, ``context_scale1``) and N
    channels at a quarter of its scale (``human_g_enc3``,
    ``context_scale2``); a two-stage residual encoder (``x - image``,
    then its first stage's output less the quarter-scale signal) and a
    two-stage decoder that adds them back, each stage fed a context of
    y_hat. Its decoder head attends over 2M = 768 channels at 8 heads:
    window attention at head width 96.

stf13 (:class:`ConditionalResidualCoding3`) has three layers. Its machine
layer's coder applies LRP and has 3-conv context stacks (``cc_widths``
(224, 64)), and its machine decoder is one ``MainCNNDecoder`` (``g_s``).
A segmentation layer follows: an encoder of x conditioned on y_hat
(``seg_g_enc2`` / ``seg_g_enc3``, the two conditioning decoders; then
``seg_g_a1`` / ``seg_g_a2``), a second zigzag coder with LRP
(``seg_coder``) and a decoder to ``seg_x_hat`` (``seg_g_s``). The human
layer is conditioned on both latents through learned softmax masks
(:meth:`ConditionalResidualCoding3._masks_and_conds`): four conditioning
decoders (an image and a quarter-scale signal of each latent), two mask
nets whose channel softmax weighs the machine's signal against the
segmentation layer's at each scale, a two-stage residual encoder and a
two-stage decoder that adds the masked signals back, its hyperprior's
decoders three convolutions (conv, two x2 deconvs: ``_SimpleHyper(
deconv_style=True)``). Its training forward computes the masks and
conditioning signals once (JAX's computes them again in
``human_synthesize``: the same function, the same floats). Its output
dict adds ``seg_x_hat`` and ``seg_likelihoods``: train with
``RateDistortionLoss(likelihood_keys=model.likelihood_keys)`` (``"likelihoods",
"machine_likelihoods", "seg_likelihoods"``); no loss term reads
``machine_x_hat`` or ``seg_x_hat``, so ``g_s`` and ``seg_g_s`` get no
gradient.

The output dict is the JAX package's: ``x_hat`` and ``decompressedImage``
(the human reconstruction), ``machine_x_hat``, ``likelihoods`` (the human
layer's y and z) and ``machine_likelihoods``, NHWC. To train from scratch
take both: ``RateDistortionLoss(likelihood_keys=model.likelihood_keys)``
(``"likelihoods", "machine_likelihoods"``; ``model.no_loss``: the
parameters no loss term reaches). stf14's training forward adds the encoder's
residual back, as the reference's does; its decodable reconstruction is
:meth:`ResidualCoding.human_synthesize`, ``cond - r_hat``. stf12's
training forward computes its two conditioning signals once for the
encoder and the decoder (JAX's traces them twice, the same values).

JAX's ``scan_charm=True`` models run the machine coder's AR loop as one
``lax.scan`` over stacked, zero-padded context weights (``code_scan``),
which computes the unrolled loop's function up to the order of the sums.
The port has the one forward for both (``ZigzagCharmCoder``'s module
docstring); a JAX tree of such a model carries the coder's context as a
``zz_scan`` subtree, which ``convert.from_jax_params(tree, model=...)``
unstacks.

The stages the coders call (``crc_codec.CRCCodec``, ``CRC3Codec``): the
machine layer's ``g_a``, (stf13) ``seg_encode``, the coders' protocol,
``human_encode``, ``human_eb_medians``, ``human_synthesize``; the human
stages take the latents the human layer is conditioned on, y_hat (and
stf13's seg_y_hat). Submodules carry the flax
names (``machine.coder.cc_mean_3.Conv_0`` ...), so
``convert.from_jax_params`` maps a JAX tree one to one. Tensors are NCHW
inside; ``forward`` takes the JAX package's NHWC images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn import SubpelConv, Win_noShift_Attention, conv, conv3x3, deconv, named_sequential
from ..nn.factories import (
    Gelu,
    context_scale1,
    context_scale2,
    hyper_encoder,
    hyper_mean,
    main_cnn_decoder,
    main_cnn_decoder_part1,
    main_cnn_decoder_part2,
    main_cnn_encoder,
)
from ..ops import ste_round
from .base import CompressionModel, nchw_to_nhwc, nhwc_to_nchw
from .zigzag_coder import ZigzagCharmCoder


def _conv_stack(in_ch: int, width: int, depth: int) -> nn.Sequential:
    """``_ConvStack``: ``depth`` 3x3 convs at ``width``, GELU between."""
    layers = []
    for i in range(depth):
        if i > 0:
            layers.append(Gelu())
        layers.append(conv(in_ch if i == 0 else width, width, kernel_size=3, stride=1))
    return named_sequential(*layers)


def _human_encoder(in_ch: int, N: int, M: int) -> nn.Sequential:
    """``_HumanEncoder``: 4 stride-2 5x5 convs to M channels, GELU between."""
    return named_sequential(
        conv(in_ch, N, 5, 2), Gelu(), conv(N, N, 5, 2), Gelu(),
        conv(N, N, 5, 2), Gelu(), conv(N, M, 5, 2))


def _human_decoder(in_ch: int, N: int, out_ch: int = 3) -> nn.Sequential:
    """``_HumanDecoder``: 4 stride-2 5x5 deconvs to the image, GELU between."""
    return named_sequential(
        deconv(in_ch, N, 5, 2), Gelu(), deconv(N, N, 5, 2), Gelu(),
        deconv(N, N, 5, 2), Gelu(), deconv(N, out_ch, 5, 2))


def _deconv_hyper_dec(in_ch: int, widths: Tuple[int, int, int]) -> nn.Sequential:
    """``_DeconvHyperDec`` (stf13's human hyper-decoders): a 3x3 conv, then
    two stride-2 3x3 deconvs, GELU between."""
    return named_sequential(conv3x3(in_ch, widths[0]), Gelu(), deconv(widths[0], widths[1], 3, 2),
                            Gelu(), deconv(widths[1], widths[2], 3, 2))


class _SimpleHyper(nn.Module):
    """The human layer's one-shot hyperprior: a bottleneck on z, and a
    conditional Gaussian whose means and scales are the hyper-decoders'
    outputs for the whole latent (no slice context). ``deconv_style``:
    stf13's hyper-decoders (:func:`_deconv_hyper_dec` at widths
    ``dec_widths[0], dec_widths[1], dec_widths[-1]``)."""

    def __init__(self, M: int, enc_widths: Tuple[int, ...], dec_widths: Tuple[int, ...],
                 extra_convs: int = 5, deconv_style: bool = False):
        super().__init__()
        z_ch = enc_widths[-1]
        self.h_a = hyper_encoder(M, tuple(enc_widths))
        if deconv_style:
            widths = (dec_widths[0], dec_widths[1], dec_widths[-1])
            self.h_mean_s = _deconv_hyper_dec(z_ch, widths)
            self.h_scale_s = _deconv_hyper_dec(z_ch, widths)
        else:
            self.h_mean_s = hyper_mean(z_ch, tuple(dec_widths), extra_convs)
            self.h_scale_s = hyper_mean(z_ch, tuple(dec_widths), extra_convs)
        self.entropy_bottleneck = EntropyBottleneck(z_ch)
        self.gaussian_conditional = GaussianConditional()

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()[:, 0, 0]

    def code(self, y: torch.Tensor, generator: Optional[torch.Generator] = None):
        """y -> (y_hat, {"y", "z"} likelihoods, NHWC)."""
        z = self.h_a(y)
        _, z_lik = self.entropy_bottleneck(z, generator)
        z_off = self.eb_medians().reshape(1, -1, 1, 1)
        z_hat = ste_round(z - z_off) + z_off
        scales = self.h_scale_s(z_hat)
        means = self.h_mean_s(z_hat)
        _, y_lik = self.gaussian_conditional(y, scales, means, generator)
        y_hat = ste_round(y - means) + means
        return y_hat, {"y": nchw_to_nhwc(y_lik), "z": nchw_to_nhwc(z_lik)}


def _stride_conv_pair(in_ch: int, N: int) -> nn.Sequential:
    """``_StrideConvPair`` (stf12's ``human_g_a1``): two stride-2 3x3 convs,
    GELU between."""
    return named_sequential(conv(in_ch, N, 3, 2), Gelu(), conv(N, N, 3, 2))


def _enc_tail(in_ch: int, N: int, M: int, with_attn: bool = True) -> nn.Sequential:
    """``_EncTail`` (stf12's ``human_g_a2``, stf13's ``seg_g_a2`` and,
    without the attention, ``human_g_a2_2``): stride-2 5x5 convs to N and
    M, GELU after each, window attention (window 4, shift 2) over M."""
    layers = [conv(in_ch, N, 5, 2), Gelu(), conv(N, M, 5, 2), Gelu()]
    if with_attn:
        layers.append(Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2))
    return named_sequential(*layers)


def _dec_head(N: int, M: int) -> nn.Sequential:
    """``_DecHead`` (stf12's ``human_g_s1``): window attention over 2M
    channels at 8 heads (head width 2M / 8, 96 at M = 384), then stride-2
    3x3 deconvs to N, GELU after each but the last."""
    return named_sequential(
        Win_noShift_Attention(2 * M, num_heads=8, window_size=4, shift_size=2), Gelu(),
        deconv(2 * M, N, 3, 2), Gelu(), deconv(N, N, 3, 2))


def _dec_tail(in_ch: int, N: int, out_ch: int = 3) -> nn.Sequential:
    """``_DecTail`` (stf12's ``human_g_s2``): 3x3 deconv, conv, deconv to
    the image, GELU between."""
    return named_sequential(deconv(in_ch, N, 3, 2), Gelu(), conv(N, N, 3, 1), Gelu(),
                            deconv(N, out_ch, 3, 2))


def _subpel_context(N: int, M: int) -> nn.Sequential:
    """``_SubpelContext`` (stf12's ``human_context_decoder2``): two 3x3
    convs at M, then two sub-pixel x2 convs to N, GELU between: y_hat's
    context at a quarter of the image's scale."""
    return named_sequential(
        conv(M, M, 3, 1), Gelu(), conv(M, M, 3, 1), Gelu(),
        SubpelConv(M, N, r=2), Gelu(), SubpelConv(N, N, r=2))


def _deconv_pair(in_ch: int, N: int) -> nn.Sequential:
    """``_DeconvPair`` (stf13's ``human_g_s1_2``): two stride-2 3x3 deconvs
    to N, GELU between."""
    return named_sequential(deconv(in_ch, N, 3, 2), Gelu(), deconv(N, N, 3, 2))


def _deconv_context(M: int, N: int) -> nn.Sequential:
    """``_DeconvContext`` (stf13's ``human_context_decoder2_2`` / ``4``): a
    3x3 conv to N, then two stride-2 3x3 deconvs, GELU between: a latent's
    context at a quarter of the image's scale."""
    return named_sequential(conv(M, N, 3, 1), Gelu(), deconv(N, N, 3, 2), Gelu(),
                            deconv(N, N, 3, 2))


class _ChannelSoftmax(nn.Module):
    def forward(self, x):
        return torch.softmax(x, dim=1)


def _mask_net(in_ch: int, widths: Tuple[int, ...]) -> nn.Sequential:
    """``_MaskNet`` (stf13's ``generate_mask_scale1`` / ``2``): 3x3 convs
    through ``widths``, GELU between, then a softmax over the channels."""
    layers, c = [], in_ch
    for i, w in enumerate(widths):
        if i > 0:
            layers.append(Gelu())
        layers.append(conv3x3(c, w))
        c = w
    return named_sequential(*layers, _ChannelSoftmax())


class _MachineLayer(nn.Module):
    """``MainCNNEncoder`` and the zigzag ChARM coder of its latent."""

    def __init__(self, N: int, M: int, num_slices: int, max_support: int, support_num: int,
                 hyper_enc_widths: Tuple[int, ...],
                 hyper_dec_widths: Tuple[int, ...], cc_widths: Tuple[int, ...],
                 apply_lrp: bool = False):
        super().__init__()
        self.g_a = main_cnn_encoder(N, M)
        self.coder = ZigzagCharmCoder(
            latent_dim=M, num_slices=num_slices, max_support=max_support,
            support_num=support_num, hyper_enc_widths=hyper_enc_widths,
            hyper_dec_widths=hyper_dec_widths, cc_widths=cc_widths, apply_lrp=apply_lrp)

    def encode_code(self, x, generator: Optional[torch.Generator] = None):
        return self.coder.code(self.g_a(x), generator)


class ConditionalResidualCoding(CompressionModel):
    """stf9 / stf11 (registry "stf9", "stf11"), and the base of stf12's,
    stf13's and stf14's classes: the machine layer, its decoder
    (:meth:`_machine_decoder`), and the human layer that
    :meth:`_human_layer` builds."""

    residual = False  # stf14: the human layer codes cond - x
    lrp = False  # stf13: its coders apply LRP
    # the forward's likelihood groups, one a coded layer (a training loss's
    # rate terms), and the prefixes of the parameters no loss term reaches:
    # the decoder of machine_x_hat, which only the eval output carries
    likelihood_keys = ("likelihoods", "machine_likelihoods")
    no_loss = ("g_s1.", "g_s2.")

    def __init__(
        self,
        N: int = 192,
        M: int = 384,
        num_slices: int = 6,
        max_support: int = 12,
        support_num: int = 24,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 176, 128, 64),
        mid: int = 256,
    ):
        super().__init__()
        self.N, self.M, self.mid = N, M, mid
        self.num_slices, self.max_support, self.support_num = num_slices, max_support, support_num
        self.machine = _MachineLayer(N, M, num_slices, max_support, support_num,
                                     tuple(hyper_enc_widths), tuple(hyper_dec_widths),
                                     tuple(cc_widths), apply_lrp=self.lrp)
        self._machine_decoder(N, M, mid)
        self._human_layer(N, M, mid, tuple(hyper_enc_widths), tuple(hyper_dec_widths))

    def _machine_decoder(self, N, M, mid) -> None:
        """The split decoder of ``machine_x_hat``."""
        self.g_s1 = main_cnn_decoder_part1(N, M, mid)
        self.g_s2 = main_cnn_decoder_part2(N, mid)

    def _human_layer(self, N, M, mid, hyper_enc_widths, hyper_dec_widths) -> None:
        """The human layer's modules, in the JAX model's order."""
        self.human_g_s2 = main_cnn_decoder(N, M, mid)  # the decoder side's conditioning
        self.human_g_a = _human_encoder(3 if self.residual else 6, N, M)
        self.human_g_s = _human_decoder(M if self.residual else 2 * M, N)
        self.human_hyper = _SimpleHyper(M, hyper_enc_widths, hyper_dec_widths)
        if not self.residual:
            self.human_context_decoder = _conv_stack(M, M, 5)

    @property
    def coder(self) -> ZigzagCharmCoder:
        return self.machine.coder

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> the output dict (module docstring), NHWC; noise
        drawn from ``generator`` (training), rounding without (eval)."""
        x = nhwc_to_nchw(x)
        y_hat, m_lik = self.machine.encode_code(x, generator)
        machine_x_hat = self.machine_synthesize(y_hat)
        human_y, cond = self._human_latent(x, y_hat)
        human_y_hat, h_lik = self.human_hyper.code(human_y, generator)
        x_hat = nchw_to_nhwc(self._train_reconstruction(human_y_hat, y_hat, cond))
        return {"x_hat": x_hat, "decompressedImage": x_hat,
                "machine_x_hat": nchw_to_nhwc(machine_x_hat),
                "likelihoods": h_lik, "machine_likelihoods": m_lik}

    # --- coder-facing stages (crc_codec.CRCCodec) --------------------------------
    def machine_synthesize(self, y_hat):
        return self.g_s2(self.g_s1(y_hat))

    def _human_latent(self, x, y_hat):
        """-> (human_y, what the training forward's reconstruction reuses:
        the residual cond - x for stf14, None for stf9)."""
        cond = self.human_g_s2(y_hat)
        if self.residual:
            residual = cond - x
            return self.human_g_a(residual), residual
        return self.human_g_a(torch.cat([x, cond], dim=1)), None

    def _train_reconstruction(self, human_y_hat, y_hat, cond):
        """The training forward's x_hat (NCHW); ``cond``: from
        :meth:`_human_latent`."""
        if self.residual:
            # the reference's training formula adds the encoder's residual back
            return self.human_g_s(human_y_hat) + cond
        return self.human_synthesize(human_y_hat, y_hat)

    def human_encode(self, x, *latents):
        """-> (human_y, its hyper-latent hz); ``latents``: y_hat (stf13:
        y_hat and seg_y_hat)."""
        human_y, _ = self._human_latent(x, *latents)
        return human_y, self.human_hyper.h_a(human_y)

    def human_eb_medians(self) -> torch.Tensor:
        return self.human_hyper.eb_medians()

    def human_synthesize(self, human_y_hat, y_hat):
        """The decoder's human reconstruction from both latents."""
        context = self.human_context_decoder(y_hat)
        return self.human_g_s(torch.cat([human_y_hat, context], dim=1))

    def aux_loss(self) -> torch.Tensor:
        return (self.coder.entropy_bottleneck.aux_loss()
                + self.human_hyper.entropy_bottleneck.aux_loss())

    def eb_dict(self) -> dict:
        return {"entropy_bottleneck": self.coder.entropy_bottleneck,
                "entropy_bottleneck_human": self.human_hyper.entropy_bottleneck}


class ResidualCoding(ConditionalResidualCoding):
    """stf14 (registry "stf14"): the human layer codes the plain residual
    ``cond - x``, with no context decoder."""

    residual = True

    def human_synthesize(self, human_y_hat, y_hat):
        """The decodable reconstruction ``x_hat = cond - r_hat`` (the
        reference's training formula adds the encoder's residual, which a
        decoder does not have)."""
        return self.human_g_s2(y_hat) - self.human_g_s(human_y_hat)


class ConditionalResidualCoding2(ConditionalResidualCoding):
    """stf12 (registry "stf12"): a two-stage residual human layer, the
    module docstring's."""

    def _human_layer(self, N, M, mid, hyper_enc_widths, hyper_dec_widths) -> None:
        self.human_g_enc2 = context_scale1(N, M, mid)  # the image-scale conditioning
        self.human_g_enc3 = context_scale2(N, M)  # and the quarter-scale one
        self.human_hyper = _SimpleHyper(M, hyper_enc_widths, hyper_dec_widths)
        self.human_context_decoder = _conv_stack(M, M, 3)
        self.human_g_a1 = _stride_conv_pair(6, N)
        self.human_g_a2 = _enc_tail(2 * N, N, M)
        self.human_g_s1 = _dec_head(N, M)
        self.human_g_s2 = _dec_tail(2 * N, N)
        self.human_context_decoder2 = _subpel_context(N, M)

    def _conditioning(self, y_hat):
        """-> (the image-scale, the quarter-scale conditioning signal)."""
        return self.human_g_enc2(y_hat), self.human_g_enc3(y_hat)

    def _human_latent(self, x, y_hat):
        cond_img, cond_quarter = cond = self._conditioning(y_hat)
        human_y_1 = self.human_g_a1(torch.cat([x, x - cond_img], dim=1))
        residual2 = human_y_1 - cond_quarter
        return self.human_g_a2(torch.cat([human_y_1, residual2], dim=1)), cond

    def _train_reconstruction(self, human_y_hat, y_hat, cond):
        """The decoder's reconstruction from both latents and the two
        conditioning signals ``cond``."""
        cond_img, cond_quarter = cond
        context = self.human_context_decoder(y_hat)
        d1 = self.human_g_s1(torch.cat([human_y_hat, context], dim=1)) + cond_quarter
        context2 = self.human_context_decoder2(y_hat)
        return self.human_g_s2(torch.cat([d1, context2], dim=1)) + cond_img

    def human_synthesize(self, human_y_hat, y_hat):
        return self._train_reconstruction(human_y_hat, y_hat, self._conditioning(y_hat))


class ConditionalResidualCoding3(ConditionalResidualCoding):
    """stf13 (registry "stf13"): the machine, segmentation and human layers
    of the module docstring, both coders with LRP."""

    lrp = True
    likelihood_keys = ConditionalResidualCoding.likelihood_keys + ("seg_likelihoods",)
    no_loss = ("g_s.", "seg_g_s.")  # machine_x_hat's and seg_x_hat's decoders

    def __init__(
        self,
        N: int = 192,
        M: int = 384,
        num_slices: int = 6,
        max_support: int = 12,
        support_num: int = 24,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 64),  # 3-conv context stacks
        mid: int = 256,
    ):
        super().__init__(N, M, num_slices, max_support, support_num, hyper_enc_widths,
                         hyper_dec_widths, cc_widths, mid)
        # the segmentation layer's coder, configured as the machine layer's
        self.seg_coder = ZigzagCharmCoder(
            latent_dim=M, num_slices=num_slices, max_support=max_support,
            support_num=support_num, hyper_enc_widths=tuple(hyper_enc_widths),
            hyper_dec_widths=tuple(hyper_dec_widths), cc_widths=tuple(cc_widths),
            apply_lrp=True)

    def _machine_decoder(self, N, M, mid) -> None:
        self.g_s = main_cnn_decoder(N, M, mid)

    def _human_layer(self, N, M, mid, hyper_enc_widths, hyper_dec_widths) -> None:
        """The segmentation layer's transforms and the human layer, in the
        JAX model's order (the segmentation coder: ``__init__``)."""
        self.seg_g_enc2 = context_scale1(N, M, mid)
        self.seg_g_enc3 = context_scale2(N, M)
        self.seg_g_s = main_cnn_decoder(N, M, mid)
        self.human_g_enc2 = context_scale1(N, M, mid)  # y_hat's image-scale signal
        self.human_g_enc3 = context_scale2(N, M)  # and its quarter-scale one
        self.human_g_enc4 = context_scale1(N, M, mid)  # seg_y_hat's
        self.human_g_enc5 = context_scale2(N, M)
        self.human_hyper = _SimpleHyper(M, hyper_enc_widths, hyper_dec_widths,
                                        deconv_style=True)
        self.human_context_decoder = _conv_stack(M, M, 2)
        self.human_context_decoder3 = _conv_stack(M, M, 2)
        self.seg_g_a1 = _stride_conv_pair(6, N)
        self.seg_g_a2 = _enc_tail(2 * N, N, M)
        self.human_g_a1_2 = _stride_conv_pair(9, N)
        self.human_g_a2_2 = _enc_tail(3 * N, N, M, with_attn=False)
        self.generate_mask_scale1 = _mask_net(6, (12, 12, 9))
        self.generate_mask_scale2 = _mask_net(2 * N, (4 * N, 4 * N, 3 * N))
        self.human_context_decoder2_2 = _deconv_context(M, N)
        self.human_context_decoder4 = _deconv_context(M, N)
        self.human_g_s1_2 = _deconv_pair(3 * M, N)
        self.human_g_s2_2 = _dec_tail(3 * N, N)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> the output dict (module docstring), NHWC; noise
        drawn from ``generator`` (training), rounding without (eval), in
        JAX's order: the machine layer's, the segmentation layer's, the
        human layer's."""
        x = nhwc_to_nchw(x)
        y_hat, m_lik = self.machine.encode_code(x, generator)
        machine_x_hat = self.machine_synthesize(y_hat)
        seg_y_hat, seg_lik = self.seg_coder.code(self.seg_encode(x, y_hat), generator)
        seg_x_hat = self.seg_g_s(seg_y_hat)
        human_y, cond = self._human_latent(x, y_hat, seg_y_hat)
        human_y_hat, h_lik = self.human_hyper.code(human_y, generator)
        x_hat = nchw_to_nhwc(self._reconstruction(human_y_hat, y_hat, seg_y_hat, cond))
        return {"x_hat": x_hat, "decompressedImage": x_hat,
                "machine_x_hat": nchw_to_nhwc(machine_x_hat),
                "seg_x_hat": nchw_to_nhwc(seg_x_hat),
                "likelihoods": h_lik, "machine_likelihoods": m_lik,
                "seg_likelihoods": seg_lik}

    # --- coder-facing stages (crc_codec.CRC3Codec) ------------------------------
    def machine_synthesize(self, y_hat):
        return self.g_s(y_hat)

    def seg_encode(self, x, y_hat):
        """The segmentation layer's latent from x and its conditioning on
        y_hat (an image and a quarter-scale signal)."""
        seg_y_1 = self.seg_g_a1(torch.cat([x, self.seg_g_enc2(y_hat)], dim=1))
        return self.seg_g_a2(torch.cat([seg_y_1, self.seg_g_enc3(y_hat)], dim=1))

    def _masks_and_conds(self, y_hat, seg_y_hat):
        """-> the four conditioning signals (y_hat's image and quarter-scale
        signal, seg_y_hat's) and the masks of y_hat's and of seg_y_hat's
        signal at each scale: (dec2, cond2, dec3, cond4, mo1, ms1, mo2,
        ms2). The mask nets' softmax runs over 9 (3N) channels, of which
        the first 6 (2N) are read."""
        N = self.N
        dec2, cond2 = self.human_g_enc2(y_hat), self.human_g_enc3(y_hat)
        dec3, cond4 = self.human_g_enc4(seg_y_hat), self.human_g_enc5(seg_y_hat)
        m1 = self.generate_mask_scale1(torch.cat([dec2, dec3], dim=1))
        m2 = self.generate_mask_scale2(torch.cat([cond2, cond4], dim=1))
        return (dec2, cond2, dec3, cond4, m1[:, 0:3], m1[:, 3:6], m2[:, 0:N], m2[:, N:2 * N])

    def _human_latent(self, x, y_hat, seg_y_hat):
        """-> (human_y, the conditioning of :meth:`_masks_and_conds`)."""
        cond = self._masks_and_conds(y_hat, seg_y_hat)
        dec2, cond2, dec3, cond4, mo1, ms1, mo2, ms2 = cond
        residual1 = x - mo1 * dec2 - ms1 * dec3
        human_y_1 = self.human_g_a1_2(torch.cat([residual1, dec2, dec3], dim=1))
        residual2 = human_y_1 - mo2 * cond2 - ms2 * cond4
        return self.human_g_a2_2(torch.cat([residual2, cond2, cond4], dim=1)), cond

    def _reconstruction(self, human_y_hat, y_hat, seg_y_hat, cond):
        """The decoder's reconstruction (NCHW) from the three latents and
        the conditioning ``cond`` of :meth:`_masks_and_conds`."""
        dec2, cond2, dec3, cond4, mo1, ms1, mo2, ms2 = cond
        context = self.human_context_decoder(y_hat)
        context3 = self.human_context_decoder3(seg_y_hat)
        context2 = self.human_context_decoder2_2(y_hat)
        context4 = self.human_context_decoder4(seg_y_hat)
        d1 = self.human_g_s1_2(torch.cat([human_y_hat, context, context3], dim=1))
        d1 = d1 + mo2 * cond2 + ms2 * cond4
        d2 = self.human_g_s2_2(torch.cat([d1, context2, context4], dim=1))
        return d2 + mo1 * dec2 + ms1 * dec3

    def human_synthesize(self, human_y_hat, y_hat, seg_y_hat):
        return self._reconstruction(human_y_hat, y_hat, seg_y_hat,
                                    self._masks_and_conds(y_hat, seg_y_hat))

    def aux_loss(self) -> torch.Tensor:
        return (self.coder.entropy_bottleneck.aux_loss()
                + self.seg_coder.entropy_bottleneck.aux_loss()
                + self.human_hyper.entropy_bottleneck.aux_loss())

    def eb_dict(self) -> dict:
        return {"entropy_bottleneck": self.coder.entropy_bottleneck,
                "entropy_bottleneck_seg": self.seg_coder.entropy_bottleneck,
                "entropy_bottleneck_human": self.human_hyper.entropy_bottleneck}
