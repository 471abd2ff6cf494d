"""The conditional residual coding family: ``stf9`` / ``stf11`` and ``stf14``.

Port of ``icm_tpu/models/crc.py`` (``ConditionalResidualCoding``,
``ResidualCoding`` and the modules they are built of; ``stf12`` and
``stf13`` come later). A layered codec for machines and humans:

- the machine layer (:class:`_MachineLayer`): ``MainCNNEncoder`` to
  y (M channels at /16), coded by the zigzag ChARM coder
  (``zigzag_coder.ZigzagCharmCoder``: 6 x 2x2 zigzag blocks, sliding
  support 12, a conditioning window of 24 blocks, 5-conv context stacks,
  LRP not applied), decoded by the split decoder ``g_s1``, ``g_s2`` to
  ``machine_x_hat``;
- the human layer: the decoder side's conditioning image
  ``human_g_s2(y_hat)`` (a whole ``MainCNNDecoder``), an encoder of
  ``cat(x, cond)`` (stf9) or of the residual ``cond - x`` (stf14) to a
  second latent, coded one-shot by its own hyperprior
  (:class:`_SimpleHyper`), and a decoder: of ``cat(human_y_hat,
  context(y_hat))`` (stf9), or ``cond - human_g_s(human_y_hat)`` (stf14).

The output dict is the JAX package's: ``x_hat`` and ``decompressedImage``
(the human reconstruction), ``machine_x_hat``, ``likelihoods`` (the human
layer's y and z) and ``machine_likelihoods``, NHWC. To train from scratch
take both: ``RateDistortionLoss(likelihood_keys=("likelihoods",
"machine_likelihoods"))``. stf14's training forward adds the encoder's
residual back, as the reference's does; its decodable reconstruction is
:meth:`ResidualCoding.human_synthesize`, ``cond - r_hat``.

The stages the coders call (``crc_codec.CRCCodec``): ``machine_analyze``,
the machine coder's protocol, ``machine_synthesize``, ``human_encode``,
``human_eb_medians``, ``human_synthesize``. Submodules carry the flax
names (``machine.coder.cc_mean_3.Conv_0`` ...), so
``convert.from_jax_params`` maps a JAX tree one to one. Tensors are NCHW
inside; ``forward`` takes the JAX package's NHWC images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn import conv, deconv, named_sequential
from ..nn.factories import (
    Gelu,
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


class _SimpleHyper(nn.Module):
    """The human layer's one-shot hyperprior: a bottleneck on z, and a
    conditional Gaussian whose means and scales are the hyper-decoders'
    outputs for the whole latent (no slice context)."""

    def __init__(self, M: int, enc_widths: Tuple[int, ...], dec_widths: Tuple[int, ...],
                 extra_convs: int = 5):
        super().__init__()
        z_ch = enc_widths[-1]
        self.h_a = hyper_encoder(M, tuple(enc_widths))
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


class _MachineLayer(nn.Module):
    """``MainCNNEncoder`` and the zigzag ChARM coder of its latent."""

    def __init__(self, N: int, M: int, num_slices: int, max_support: int, support_num: int,
                 hyper_enc_widths: Tuple[int, ...],
                 hyper_dec_widths: Tuple[int, ...], cc_widths: Tuple[int, ...]):
        super().__init__()
        self.g_a = main_cnn_encoder(N, M)
        self.coder = ZigzagCharmCoder(
            latent_dim=M, num_slices=num_slices, max_support=max_support,
            support_num=support_num, hyper_enc_widths=hyper_enc_widths,
            hyper_dec_widths=hyper_dec_widths, cc_widths=cc_widths)

    def encode_code(self, x, generator: Optional[torch.Generator] = None):
        return self.coder.code(self.g_a(x), generator)


class ConditionalResidualCoding(CompressionModel):
    """stf9 / stf11 (registry "stf9", "stf11")."""

    residual = False  # stf14: the human layer codes cond - x

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
                                     tuple(cc_widths))
        self.g_s1 = main_cnn_decoder_part1(N, M, mid)
        self.g_s2 = main_cnn_decoder_part2(N, mid)
        self.human_g_s2 = main_cnn_decoder(N, M, mid)  # the decoder side's conditioning
        self.human_g_a = _human_encoder(3 if self.residual else 6, N, M)
        self.human_g_s = _human_decoder(M if self.residual else 2 * M, N)
        self.human_hyper = _SimpleHyper(M, tuple(hyper_enc_widths), tuple(hyper_dec_widths))
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
        human_y, residual = self._human_latent(x, y_hat)
        human_y_hat, h_lik = self.human_hyper.code(human_y, generator)
        if self.residual:
            # the reference's training formula adds the encoder's residual back
            x_hat = self.human_g_s(human_y_hat) + residual
        else:
            x_hat = self.human_synthesize(human_y_hat, y_hat)
        x_hat = nchw_to_nhwc(x_hat)
        return {"x_hat": x_hat, "decompressedImage": x_hat,
                "machine_x_hat": nchw_to_nhwc(machine_x_hat),
                "likelihoods": h_lik, "machine_likelihoods": m_lik}

    # --- coder-facing stages (crc_codec.CRCCodec) --------------------------------
    def machine_analyze(self, x):
        """NCHW images -> (y, z) of the machine layer."""
        y = self.machine.g_a(x)
        return y, self.coder.h_a(y)

    def machine_synthesize(self, y_hat):
        return self.g_s2(self.g_s1(y_hat))

    def _human_latent(self, x, y_hat):
        """-> (human_y, the residual cond - x, or None for stf9)."""
        cond = self.human_g_s2(y_hat)
        if self.residual:
            residual = cond - x
            return self.human_g_a(residual), residual
        return self.human_g_a(torch.cat([x, cond], dim=1)), None

    def human_encode(self, x, y_hat):
        """-> (human_y, its hyper-latent hz)."""
        human_y, _ = self._human_latent(x, y_hat)
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
