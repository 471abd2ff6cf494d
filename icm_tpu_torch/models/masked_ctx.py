"""The masked-transformer codecs ``stf2``, ``stf3`` and ``stf4`` (registry
"stf2", "stf3", "stf4").

Port of ``icm_tpu/models/masked_ctx.py``'s ``ClipEncoder`` (stf2),
``ClipEncoder3`` (stf3) and ``ClipEncoder4`` (stf4): training and eval
forwards, and the stages the coders call. All three are ``stf``'s
transforms (a Swin analysis and synthesis, embed 48, depths 2/2/6/2,
heads 3/6/12/24, window 4, M = 384) and its conv hyper-codec, with a
context over window tokens:

- the latent is cut into channel slices and each slice into windows of
  ``mask_win_size``; the windows are ordered by the constrained zigzag
  over (slice, window row, window column) (``scan/zigzag.py``), and each
  flattens channel-major (c, h, w) to a token, the reference's order,
  which every converted dense weight indexes
  (:func:`~icm_tpu_torch.scan.zigzag_split_tokens`). stf3 and stf4: 8
  slices of 48, windows of 4 x 4, D = 768, N = 512 tokens an image at
  512 x 512; stf2: 4 slices of 96, windows of 8 x 8, D = 6144, N = 64;
- ``stf3``: two ``MaskedContextModel`` stacks (five blocks of plain
  attention with no residual around it, then a LayerNorm / GELU MLP
  residual) over [N hyper tokens, N y_hat tokens], the mu stack fed the
  *scale* hyper tokens and the sigma stack the *mean* ones (the
  reference's swapped names, kept so that converted checkpoints see the
  token types they were trained on); teacher-forced: output row N - 1 + i
  predicts token i. Its default mask is the reference's additive block
  mask (0 / -1000: hyper rows see hyper columns only, y row N + i sees
  columns <= N + i); ``causal=True`` takes a boolean lower-triangular one;
- ``stf4``: one bare 2-head attention over the y_hat tokens (the
  reference's strict lower-triangular -1000 mask, whose row 0 has every
  key masked and so degenerates to full attention; ``causal=True`` takes
  a boolean lower-triangular one), then per token a conv head over the
  shifted context window of the 27 previous context rows and the 27
  hyper tokens up to it, laid out as the reference's ``nn.Unfold``
  leaves them (:meth:`ClipEncoder4._fused_heads`). ``cc_mean_head``
  computes both mu and scale (from the scale and the mean hyper windows,
  swapped as in ``stf3``); ``cc_scale_head`` has parameters that no
  forward applies, so that the state-dict trees stay equal;
- stf3 and stf4: y_hat = round(y) (no mean offset), the conditional
  Gaussian of it with the context's mu and scale, then a global LRP stack
  on cat(y_hat, means, scales) before the synthesis;
- ``stf2`` (:class:`ClipEncoder`): an autoregressive loop over the N
  tokens. Step i attends, with one unmasked single-head attention each
  for mu and sigma (a qkv product, softmax, ``@ v``), over 2s tokens: the
  s = ``num_sliding`` hyper tokens up to i and the s tokens decoded
  before it (zeros before the first). The hyper windows come from the
  *scale* hyper output for mu and from the *mean* one for sigma (the
  reference's swapped names again), each laid out by the reference's
  ``nn.Unfold`` scramble (:func:`_unfold_scramble`); the history is
  not scrambled. Step 0 orders the sequence [history, hyper], every later
  step [hyper, history]: the reference's two orders, which its conv heads
  were trained on. Three conv heads read the 2s attention outputs as a
  (2s C', ws, ws) image: ``cc_mean_head`` and ``cc_scale_head`` give mu
  and scale, ``lrp_head`` on cat(mu's context, y_hat) the token's LRP.
  Then ``y_hat = ste_round(y - mu) + mu + 0.5 tanh(lrp)`` joins the
  history. JAX's two training forwards (its unrolled loop and
  ``scan_tokens=True``, one ``lax.scan``, the same parameter tree)
  compute the one function of :meth:`ClipEncoder.forward`.

The stf3 / stf4 coder (``masked_codec.Stf3Codec``) calls :meth:`analyze`,
:meth:`eb_medians`, :meth:`coder_tokens`, :meth:`causal_mu_scale`,
:meth:`coder_reconstruct` and :meth:`synthesize`. ``causal_mu_scale`` is
one full context pass whose row i depends on the token buffer's rows < i
only, and only through rows whose masked softmax weights are exactly 0: a
boolean mask puts -inf in the logits, and the reference's -1000 fills
underflow to 0 in float32 as long as no masked logit comes within about
100 of its row's maximum. The decoder runs the same pass on its
zero-padded prefix buffer and reads one row, so each op of the pass must
compute every output row from that row's inputs alone, in an order fixed
by the shapes: plain matmuls and softmax, not a fused attention kernel.
The stf2 coder (``masked_codec.Stf2Codec``) calls :meth:`analyze`,
:meth:`ClipEncoder.token_windows`, :meth:`ClipEncoder.token_context`,
:meth:`ClipEncoder.token_lrp`, :meth:`ClipEncoder.tokens_assemble` and
:meth:`synthesize` (and :meth:`ClipEncoder.hyper_windows`), one step a
token on both sides.

The attention and MLP dense layers are flax ``nn.Dense`` in the JAX
package: drawn at its default fan-in scaling (:class:`Dense`), and outside
the bfloat16 activation policy, as flax's ``nn.Dense`` without a dtype
is: a bfloat16 input is promoted to the float32 weights' dtype, so the
attention and the MLPs compute and return float32. The conv heads and LRP
stacks, the transforms and the hyper-codec follow the policy as the JAX
package's ``conv`` does, and a bfloat16 activation meets a float32 one
(cat, add) in float32, as jnp promotes. Tensors are NCHW inside;
``forward`` takes and gives the JAX package's NHWC images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..nn import conv, named_sequential
from ..nn.factories import Gelu
from ..ops import ste_round
from ..scan import zigzag_merge, zigzag_split_tokens
from .base import CompressionModel, nchw_to_nhwc, nhwc_to_nchw
from .cnn import _hyper_decoder, _hyper_encoder
from .stf import _SwinAnalysis, _SwinSynthesis


class Dense(nn.Linear):
    """flax's ``nn.Dense`` at its default init: ``init_parameters`` draws
    its weight truncated-normal at fan-in scale (flax's ``lecun_normal``),
    not at the Swin layers' 0.02."""

    fan_in_init = True


class PlainAttention(nn.Module):
    """Self-attention with a qkv projection only (no output projection, no
    bias table): per head ``softmax(q k^T / sqrt(hd) + mask) v``. ``mask``
    (L, L): boolean (True: the key is visible; the others get -inf, so
    their weights are exactly 0), or float, added to the logits (the
    reference's -1000 fills; a row with every key masked then attends to
    all of them)."""

    def __init__(self, dim: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        # flax promotes a bfloat16 input to its float32 kernel's dtype
        qkv = self.qkv(x.to(torch.promote_types(x.dtype, self.qkv.weight.dtype))).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
        if mask is not None:
            if mask.dtype == torch.bool:
                logits = logits.masked_fill(~mask, float("-inf"))
            else:
                logits = logits + mask
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return out.transpose(1, 2).reshape(B, N, C)


class MaskedContextModel(nn.Module):
    """``depth`` x (``x = attn(x)``; ``x = x + Dense(GELU(Dense(LayerNorm(x))))``),
    LayerNorm eps 1e-5, the MLP 2x wide. Children carry the flax names:
    ``attn{i}``, ``LayerNorm_{i}``, ``Dense_{2i}``, ``Dense_{2i+1}``."""

    def __init__(self, dim: int, depth: int = 5, num_heads: int = 1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn{i}", PlainAttention(dim, num_heads))
            self.add_module(f"LayerNorm_{i}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"Dense_{2 * i}", Dense(dim, 2 * dim))
            self.add_module(f"Dense_{2 * i + 1}", Dense(2 * dim, dim))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        for i in range(self.depth):
            x = getattr(self, f"attn{i}")(x, mask)
            h = getattr(self, f"LayerNorm_{i}")(x)
            h = F.gelu(getattr(self, f"Dense_{2 * i}")(h))
            x = x + getattr(self, f"Dense_{2 * i + 1}")(h)
        return x


def _conv_head(in_ch: int, widths: Tuple[int, ...]) -> nn.Sequential:
    """3x3 convs through ``widths``, GELU between (``_GlobalLRP`` and
    ``_ConvHead``)."""
    layers, c = [], in_ch
    for i, w in enumerate(widths):
        if i:
            layers.append(Gelu())
        layers.append(conv(c, w, kernel_size=3, stride=1))
        c = w
    return named_sequential(*layers)


def _causal_windows(tokens: torch.Tensor, window: int, include_current: bool) -> torch.Tensor:
    """(B, N, D) -> (B, N, D, window): for each i the ``window`` tokens
    before it ([i - w, i), or [i - w + 1, i] with ``include_current``),
    zero-padded at the front, each window laid out d-major (the
    reference's ``nn.Unfold`` order). JAX gathers (B, N, window, D) and
    transposes; here one unfold view."""
    pad = window - 1 if include_current else window
    return F.pad(tokens, (0, 0, pad, 0)).unfold(1, window, 1)[:, :tokens.shape[1]]


def _unfold_scramble(tokens: torch.Tensor, window: int) -> torch.Tensor:
    """(B, N, D) -> (B, N, window, D): stf2's hyper windows as the reference
    feeds them (stf2.py:1063-1079): ``nn.Unfold`` lays each (D, window)
    window out d-major and the reference reads the flat vector back
    token-major, so each "window token" is the transpose-scramble
    ``(W^T).reshape(window, D)`` of the true window W (window, D). The
    d-major windows of :func:`_causal_windows` (zero-padded at the front,
    the current token included) are that flat vector already."""
    B, N, D = tokens.shape
    return _causal_windows(tokens, window, include_current=True).reshape(B, N, window, D)


class _MaskedBase(CompressionModel):
    """The transforms, hyper-codec and token layout of the masked family."""

    def __init__(
        self,
        embed_dim: int = 48,
        depths: Tuple[int, ...] = (2, 2, 6, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 4,
        patch_size: int = 2,
        drop_path_rate: float = 0.2,
        num_slices: int = 8,
        mask_win_size: int = 4,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
    ):
        super().__init__()
        self.latent_dim = embed_dim * 2 ** (len(depths) - 1)
        if self.latent_dim % num_slices:
            raise ValueError(f"M={self.latent_dim} does not split into {num_slices} slices")
        self.num_slices = num_slices
        self.mask_win_size = mask_win_size
        self.slice_ch = self.latent_dim // num_slices
        self.token_dim = mask_win_size ** 2 * self.slice_ch
        # the analysis pads every stage up (the patch, each merge): y's side
        # is the image's over this, rounded up
        self.latent_stride = patch_size * 2 ** (len(depths) - 1)
        self.g_a = _SwinAnalysis(embed_dim, tuple(depths), tuple(num_heads), window_size,
                                 patch_size, drop_path_rate)
        self.g_s = _SwinSynthesis(embed_dim, tuple(reversed(depths)), tuple(reversed(num_heads)),
                                  window_size, patch_size, drop_path_rate)
        self.h_a = _hyper_encoder(self.latent_dim, tuple(hyper_enc_widths))
        z_ch = hyper_enc_widths[-1]
        self.h_mean_s = _hyper_decoder(z_ch, tuple(hyper_dec_widths))
        self.h_scale_s = _hyper_decoder(z_ch, tuple(hyper_dec_widths))
        self.entropy_bottleneck = EntropyBottleneck(z_ch)
        self.gaussian_conditional = GaussianConditional()
        self.cond_width = hyper_dec_widths[-1]

    # --- token layout -------------------------------------------------------------
    def _tokens(self, t: torch.Tensor):
        """(B, C, H, W) -> ((B, N, D) tokens in zigzag order, channel-major
        within a token, (window rows, window columns))."""
        tok, nH, nW = zigzag_split_tokens(t, self.num_slices, self.mask_win_size)
        return tok, (nH, nW)

    def _blocks(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N, D) tokens -> (B, N, C', ws, ws) window blocks."""
        ws = self.mask_win_size
        return tokens.reshape(tokens.shape[0], tokens.shape[1], self.slice_ch, ws, ws)

    def _merge(self, blocks: torch.Tensor, lattice, out_hw) -> torch.Tensor:
        """(B, N, C', ws, ws) blocks -> (B, C, H, W), the padding cut."""
        nH, nW = lattice
        x = zigzag_merge(blocks, self.num_slices, nH, nW, True)
        return x[:, :, :out_hw[0], :out_hw[1]]

    def _hyper(self, y, generator):
        z = self.h_a(y)
        _, z_lik = self.entropy_bottleneck(z, generator)
        z_off = self.eb_medians().reshape(1, -1, 1, 1)
        z_hat = ste_round(z - z_off) + z_off
        return self.h_mean_s(z_hat), self.h_scale_s(z_hat), z_lik

    # --- the stages the coders call ----------------------------------------------------
    def analyze(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def synthesize(self, y_hat):
        return self.g_s(y_hat)


class _OneShotContext(_MaskedBase):
    """What stf3 and stf4 share: a one-pass context over all tokens,
    y_hat = round(y), the global LRP stack, and the coder's full causal
    pass."""

    def __init__(self, causal: bool = False, num_slices: int = 8, mask_win_size: int = 4,
                 **kwargs):
        super().__init__(num_slices=num_slices, mask_win_size=mask_win_size, **kwargs)
        self.causal = causal

    def _lrp_stack(self) -> nn.Sequential:
        """The global LRP stack on cat(y_hat, means, scales): 2M, M, M, M."""
        M = self.latent_dim
        return _conv_head(M + 2 * self.cond_width, (2 * M, M, M, M))

    def _with_lrp(self, y_hat, means, scales):
        return y_hat + 0.5 * torch.tanh(self.lrp(torch.cat([y_hat, means, scales], dim=1)))

    def _token_inputs(self, y_hat, means, scales):
        y_tok, lattice = self._tokens(y_hat)
        return y_tok, self._tokens(means)[0], self._tokens(scales)[0], lattice

    # --- forward --------------------------------------------------------------------
    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> {"x_hat", "likelihoods": {"y", "z"}}, NHWC.
        With ``generator`` (training): stochastic depth in the transforms
        and the likelihoods of the latents plus uniform noise, drawn from
        it; without: the eval forward."""
        y = self.g_a(nhwc_to_nchw(x), generator)
        means, scales, z_lik = self._hyper(y, generator)
        y_hat = ste_round(y)
        y_tok, m_tok, s_tok, lattice = self._token_inputs(y_hat, means, scales)
        mu, scale = self._context(m_tok, s_tok, y_tok, self.causal)
        out_hw = y.shape[2:]
        mu = self._merge(self._blocks(mu), lattice, out_hw)
        scale = self._merge(self._blocks(scale), lattice, out_hw)
        _, y_lik = self.gaussian_conditional(y_hat, scale, mu, generator)
        x_hat = self.g_s(self._with_lrp(y_hat, means, scales), generator)
        return {"x_hat": nchw_to_nhwc(x_hat),
                "likelihoods": {"y": nchw_to_nhwc(y_lik), "z": nchw_to_nhwc(z_lik)}}

    # --- the stages the coder calls --------------------------------------------------
    def coder_tokens(self, y, z_hat):
        """-> (round(y)'s tokens, mean tokens, scale tokens, means, scales,
        lattice (window rows, columns), latent (H, W)), the layouts of the
        forward, each a contiguous (B, N, D)."""
        means, scales = self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        y_tok, m_tok, s_tok, lattice = self._token_inputs(torch.round(y), means, scales)
        return (y_tok.contiguous(), m_tok.contiguous(), s_tok.contiguous(), means, scales,
                lattice, tuple(y.shape[2:]))

    # the coder's context mask: the model's own (stf3), or the causal one
    # whatever the model's (stf4, whose reference mask does not code)
    coder_causal = False

    def causal_mu_scale(self, m_tok, s_tok, y_buf):
        """One full context pass -> (mu, scale) tokens (B, N, D); row i
        depends on ``y_buf``'s rows < i only (module docstring)."""
        return self._context(m_tok, s_tok, y_buf, self.causal or self.coder_causal)

    def coder_reconstruct(self, y_tok, means, scales, lattice, out_hw):
        """Integer token buffer -> y_hat with the global LRP (as the forward)."""
        return self._with_lrp(self._merge(self._blocks(y_tok), lattice, out_hw), means, scales)


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()


class ClipEncoder3(_OneShotContext):
    """stf3 (see the module docstring). Both masks are decodable: the
    reference's block mask with the teacher-forcing shift gives prediction
    i exactly y_hat[< i], and so does ``causal=True``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        D = self.token_dim
        self.maskedContextModel_mu = MaskedContextModel(D)
        self.maskedContextModel_sigma = MaskedContextModel(D)
        self.lrp = self._lrp_stack()
        self._masks = {}

    def _ctx_mask(self, N: int, device, causal: bool) -> torch.Tensor:
        """The (2N, 2N) mask of the context sequence [hyper | y], made on
        ``device`` once per size (with ops on the device, not a copy to it,
        so that a decoder's first pass waits for nothing)."""
        key = (N, torch.device(device), causal)
        if key not in self._masks:
            L = 2 * N
            if causal:
                mask = _tril(L, device)
            else:
                vis = torch.zeros(L, L, dtype=torch.bool, device=device)
                vis[:N, :N] = True
                vis[N:] = torch.ones(N, L, dtype=torch.bool, device=device).tril(N)
                mask = torch.where(vis, 0.0, -1000.0)
            self._masks[key] = mask
        return self._masks[key]

    def _context(self, m_tok, s_tok, y_tok, causal: bool):
        """Both stacks' outputs, teacher-shifted: row i predicts token i.
        The mu stack reads the scale hyper tokens, the sigma stack the mean
        ones (the reference's wiring)."""
        N = y_tok.shape[1]
        mask = self._ctx_mask(N, y_tok.device, causal)
        mu = self.maskedContextModel_mu(torch.cat([s_tok, y_tok], dim=1), mask)
        scale = self.maskedContextModel_sigma(torch.cat([m_tok, y_tok], dim=1), mask)
        return mu[:, N - 1:-1], scale[:, N - 1:-1]


class ClipEncoder4(_OneShotContext):
    """stf4 (see the module docstring). Its reference mask lets token 0 see
    every token, so only ``causal=True`` codes (``Stf4Codec`` raises
    otherwise); its training forward keeps the reference mask by
    default."""

    coder_causal = True

    def __init__(self, sliding: int = 27, **kwargs):
        super().__init__(**kwargs)
        self.sliding = sliding
        Cp, w = self.slice_ch, sliding
        self.maskedContextModel_mu = PlainAttention(self.token_dim, 2)
        widths = (w * Cp, 15 * Cp, 8 * Cp, Cp)
        self.cc_mean_head = _conv_head(2 * w * Cp, widths)
        self.cc_scale_head = _conv_head(2 * w * Cp, widths)  # no forward applies it
        self.lrp = self._lrp_stack()
        self._masks = {}

    def _mask(self, N: int, device, causal: bool) -> torch.Tensor:
        """(N, N): boolean lower-triangular, or the reference's strict
        lower-triangular -1000 fills (row 0 all masked)."""
        key = (N, torch.device(device), causal)
        if key not in self._masks:
            self._masks[key] = (_tril(N, device) if causal else
                                torch.where(_tril(N, device).tril(-1), 0.0, -1000.0))
        return self._masks[key]

    def _fused_heads(self, ctx, m_tok, s_tok):
        """Context rows (B, N, D) and the hyper tokens -> (mu, scale) tokens.
        Token i's input: the shifted context window (rows [i - w, i)) and a
        hyper window (tokens [i - w + 1, i]), each flattened d-major, the two
        concatenated and read row-major as an NCHW (2 w C', ws, ws) image:
        the reference's scramble of window offsets into the head's spatial
        dims, which converted checkpoints were trained on. The port's
        convolutions are NCHW, so that image is the flat vector's own
        layout. ``cc_mean_head`` computes both: mu from the scale hyper
        windows, scale from the mean ones."""
        B, N, D = ctx.shape
        w, ws = self.sliding, self.mask_win_size
        ctx_w = _causal_windows(ctx, w, include_current=False).reshape(B, N, D * w)

        def fuse(hyper):
            h_w = _causal_windows(hyper, w, include_current=True).reshape(B, N, D * w)
            h = torch.cat([ctx_w, h_w], dim=2).reshape(B * N, 2 * w * self.slice_ch, ws, ws)
            return self.cc_mean_head(h).reshape(B, N, D)

        return fuse(s_tok), fuse(m_tok)

    def _context(self, m_tok, s_tok, y_tok, causal: bool):
        ctx = self.maskedContextModel_mu(y_tok, self._mask(y_tok.shape[1], y_tok.device, causal))
        return self._fused_heads(ctx, m_tok, s_tok)


class ClipEncoder(_MaskedBase):
    """stf2 (see the module docstring): the autoregressive token loop over
    ``num_slices`` slices of windows of ``mask_win_size``, each step's
    attention over ``num_sliding`` hyper tokens and as many decoded ones.
    Only a stride of 1 (``num_stride_sliding``) is defined, as in the JAX
    package. Children carry the flax names: ``muContextModel``,
    ``sigmaContextModel`` (each a ``qkv`` dense), ``cc_mean_head``,
    ``cc_scale_head``, ``lrp_head`` (four 3 x 3 convs each: s C', 15 C',
    8 C', C')."""

    def __init__(self, num_slices: int = 4, mask_win_size: int = 8, num_sliding: int = 6,
                 num_stride_sliding: int = 1, **kwargs):
        if num_stride_sliding != 1:
            raise ValueError("stf2 is defined for num_stride_sliding=1 only, as in the JAX "
                             "package")
        super().__init__(num_slices=num_slices, mask_win_size=mask_win_size, **kwargs)
        D, Cp, s = self.token_dim, self.slice_ch, num_sliding
        self.num_sliding = s
        self.muContextModel = PlainAttention(D, 1)
        self.sigmaContextModel = PlainAttention(D, 1)
        widths = (s * Cp, 15 * Cp, 8 * Cp, Cp)
        self.cc_mean_head = _conv_head(2 * s * Cp, widths)
        self.cc_scale_head = _conv_head(2 * s * Cp, widths)
        self.lrp_head = _conv_head(2 * s * Cp + Cp, widths)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> {"x_hat", "likelihoods": {"y", "z"}}, NHWC;
        y's likelihoods are the tokens' (B, ws, ws, C') blocks concatenated
        along the channels, token by token, as JAX's. With ``generator``
        (training): stochastic depth and the likelihoods' noise drawn from
        it (z's, then each token's in order); without: the eval forward."""
        y = self.g_a(nhwc_to_nchw(x), generator)
        means, scales, z_lik = self._hyper(y, generator)
        y_tok, lattice = self._tokens(y)
        m_win, s_win = self._hyper_windows(means, scales)
        B, N, D = y_tok.shape
        prev = y_tok.new_zeros(B, self.num_sliding, D)
        toks, liks = [], []
        for i in range(N):
            mu, scale, ctx = self.token_context(m_win[:, i], s_win[:, i], prev, i == 0)
            y_i = self._blocks(y_tok[:, i:i + 1])[:, 0]
            _, lik = self.gaussian_conditional(y_i, scale, mu, generator)
            y_hat = ste_round(y_i - mu) + mu
            tok = (y_hat + self.token_lrp(ctx, y_hat)).reshape(B, D)
            prev = torch.cat([prev[:, 1:], tok[:, None]], 1)
            toks.append(tok)
            liks.append(lik)
        y_hat = self.tokens_assemble(torch.stack(toks, 1), lattice, y.shape[2:])
        x_hat = self.g_s(y_hat, generator)
        return {"x_hat": nchw_to_nhwc(x_hat),
                "likelihoods": {"y": nchw_to_nhwc(torch.cat(liks, 1)), "z": nchw_to_nhwc(z_lik)}}

    # --- the stages the coder calls (and the forward) ------------------------------------
    def token_windows(self, y, z_hat):
        """-> (y's tokens (B, N, D), mu's and sigma's hyper windows (B, N, s,
        D), lattice (window rows, columns)): JAX's stage, whose decoder
        passes a zero y of the latent's shape; the windows depend on z_hat
        alone (:meth:`hyper_windows`)."""
        y_tok, lattice = self._tokens(y)
        return (y_tok,) + self.hyper_windows(z_hat) + (lattice,)

    def hyper_windows(self, z_hat):
        """z_hat -> (mu's, sigma's hyper windows (B, N, s, D))."""
        return self._hyper_windows(self.h_mean_s(z_hat), self.h_scale_s(z_hat))

    def _hyper_windows(self, means, scales):
        """mu's windows come from the *scale* hyper output and sigma's from
        the *mean* one (the reference's names, stf2.py:1048-1049), each
        scrambled as the reference's unfold leaves it."""
        s = self.num_sliding
        return (_unfold_scramble(self._tokens(scales)[0], s),
                _unfold_scramble(self._tokens(means)[0], s))

    def _spatial(self, ctx: torch.Tensor) -> torch.Tensor:
        """(B, k, D) channel-major tokens -> the (B, k C', ws, ws) image the
        heads read, channel k' C' + c (the reference's view(B, -1, ws, ws))."""
        ws = self.mask_win_size
        return ctx.reshape(ctx.shape[0], -1, ws, ws)

    def token_context(self, m_i, s_i, prev, first: bool):
        """One step's (mu, scale) blocks (B, C', ws, ws) and mu's context
        image, from the step's hyper windows (B, s, D) and the history
        ``prev`` (B, s, D), oldest first: [history, hyper] at the first step,
        [hyper, history] at every later one (stf2.py:1085-1089 against
        1131-1133)."""
        if first:
            mu_in, sigma_in = torch.cat([prev, m_i], 1), torch.cat([prev, s_i], 1)
        else:
            mu_in, sigma_in = torch.cat([m_i, prev], 1), torch.cat([s_i, prev], 1)
        ctx_mu = self._spatial(self.muContextModel(mu_in))
        ctx_sigma = self._spatial(self.sigmaContextModel(sigma_in))
        return self.cc_mean_head(ctx_mu), self.cc_scale_head(ctx_sigma), ctx_mu

    def token_lrp(self, ctx_mu, y_hat):
        """The token's LRP term, 0.5 tanh(lrp_head(cat(mu's context, y_hat)))."""
        return 0.5 * torch.tanh(self.lrp_head(torch.cat([ctx_mu, y_hat], 1)))

    def tokens_assemble(self, toks: torch.Tensor, lattice, out_hw) -> torch.Tensor:
        """(B, N, D) y_hat tokens -> y_hat (B, M, H, W), the padding cut."""
        return self._merge(self._blocks(toks), lattice, out_hw)
