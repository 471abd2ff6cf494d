"""Real-bitstream compress/decompress for the masked family: ``stf3`` and
``stf4`` (:class:`Stf3Codec`), ``stf2`` (:class:`Stf2Codec`, its own
design: see its docstring).

Port of ``icm_tpu/models/masked_codec.py``'s ``Stf3Codec`` (``Stf4Codec``
is the same class), on the host wire and the device wire. The reference
shipped no coder for these models; the JAX package's design, kept here:

- z: the factorized bottleneck, one stream an image, symbols in NHWC
  order (``CharmCodec``'s);
- y: symbols are the absolute integers ``round(y) - round(mu)`` under the
  zero-mean scale tables, so that the decoded tokens are exactly
  ``round(y)``, the tokens the training forward's context reads;
- one causal context pass (``model.causal_mu_scale``), shared by both
  sides (:meth:`Stf3Codec._context`): the encoder runs it once on the
  whole token sequence, the decoder once per token on its zero-padded
  prefix buffer, reading one row. Row i of the pass depends on the
  buffer's rows < i only (``masked_ctx``'s module docstring), so the two
  sides read the same floats. Decode is N passes for N tokens (512 an
  image at 512 x 512): O(N^2) work.

``stf3`` codes with either mask (its reference block mask is causal under
the teacher-forcing shift); ``stf4`` only with ``causal=True``: its
reference mask lets token 0 attend to every token.

``wire="host"``: rANS on the host (``coding/``), the token sequence in
order, a token's elements channel-major; the decoder brings each token's
scale indexes to the host and its symbols back, one round trip a token.
``wire="device"``: the lane rANS of ``csrc/rans_lanes.cu``, one lane per
(image, token element), B * D lanes and one step a token, in JAX's
``WIRE_SCAN`` format with its tier byte (the escape cap of a token's
segment, ``scan_codec._tier_for``): compress is one pass and two encode
launches (y, z); decompress uploads the streams once, decodes z, then runs
N steps of a full pass and one decode launch, launch by launch and with no
host round trip. A decoder step takes round(mu) of token i from the pass,
the value JAX's ``wire_step`` reads as ``-sym_all[:, i]`` from its
encoder's symbol function on a buffer whose row i is zero.

``latent_scale`` scales y and z before the symbols are formed (JAX's
stand-in for the other codecs' ``narrow``, which cannot apply here: the
context reads the coded tokens themselves), so that seeded, untrained
weights code symbols near a trained model's.

Under the bfloat16 activation policy the encoder's tokens are round(y) in
y's bfloat16, and the decoder holds its token buffer in the same dtype (the
hyper-decoders', which the policy sets alike), so both sides reconstruct
from the same tensor; JAX's decoder holds float32, so its decoder's y_hat is
float32 where its encoder's is bfloat16. The integers coded are the same.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import coding
from ..coding.device_rans import decode_lanes, encode_lanes, fix_escapes
from ..coding.wire import WIRE_SCAN
from ..entropy import build_indexes
from ..graphs import weights_version
from .base import CodecTables, nhwc_to_nchw
from .codec import (_canonical, _eb_indexes, _flat, _unflat, build_codec_tables, cuda_numerics,
                    enc_round)

Z_KEY = "entropy_bottleneck"


def encode_token_lanes(kit, sym: torch.Tensor, index: torch.Tensor) -> List[bytes]:
    """(B, N, D) symbols and indexes -> step-major (N, B * D) lanes (one
    step a token), one encode launch, per image a ``WIRE_SCAN`` wire framed
    with the smallest escape tier that holds every token's escapes."""
    from .device_codec import _pack_wire
    from .scan_codec import _seg_esc_counts, _tier_for, _wrap_tier

    B, N, D = sym.shape

    def lanes(a):
        return a.permute(1, 0, 2).reshape(N, B * D).contiguous()

    enc = encode_lanes(lanes(sym), lanes(index), kit.gauss_dev)
    blobs = [_pack_wire(*p, fmt=WIRE_SCAN) for p in kit.fetch_encoded(enc, B)]
    counts = _seg_esc_counts(blobs, D, 1, N)
    return _wrap_tier(blobs, _tier_for(int(counts.max()), B * D))


class _TokenCodec:
    """What the masked family's codecs share: the model on its device, the
    coder tables, z's coding on both wires and y's lane layout on the
    device wire. ``tables``: coder tables in place of the model's own
    (``build_codec_tables``), e.g. a reference checkpoint's or the JAX
    codec's; ``wire``: "host" or "device"."""

    # the latent key of the debug output and decompress
    LATENT_KEYS = ("y_hat",)

    def __init__(self, model, tables: Optional[CodecTables], wire: str):
        if wire not in ("host", "device"):
            raise ValueError(f"wire must be 'host' or 'device', got {wire!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            cuda_numerics()
        self.wire = wire
        if tables is None:
            with torch.no_grad():
                tables = build_codec_tables(model)
        self.tables = tables
        self._scale_table = torch.from_numpy(tables.scale_table).to(self.device)
        self._medians = None
        if wire == "device":
            from .device_codec import DeviceWireKit

            self.kit = DeviceWireKit(tables, device=self.device)

    def _z_offset(self) -> torch.Tensor:
        if self._medians is None:
            self._medians = self.model.eb_medians().detach().reshape(1, -1, 1, 1)
        return self._medians

    def _z_hat(self, z_sym: torch.Tensor) -> torch.Tensor:
        return z_sym.to(torch.float32) + self._z_offset()

    def _code_z(self, z_sym: torch.Tensor) -> List[bytes]:
        if self.wire == "device":
            return self.kit.encode_z(z_sym, Z_KEY)
        return self._encode_z(z_sym)

    def _z_tables(self):
        return self.tables.bottlenecks[Z_KEY]

    def _encode_z(self, sym: torch.Tensor) -> List[bytes]:
        B, C, h, w = sym.shape
        t = self._z_tables()
        idx = np.broadcast_to(_eb_indexes((h, w), C, False), (B, h * w * C))
        return coding.encode_batch(_flat(sym.cpu().numpy(), False), idx, t.quantized_cdf,
                                   t.cdf_length, t.offset)

    def _decode_z(self, strings: List[bytes], shape_hw) -> torch.Tensor:
        """-> z's int32 symbols (B, C, h, w) on the codec's device, with the
        standard strides."""
        h, w = shape_hw
        if self.wire == "device":
            return _canonical(self.kit.decode_z(strings, h, w, Z_KEY))
        t = self._z_tables()
        C = t.num_distributions
        idx = np.broadcast_to(_eb_indexes((h, w), C, False), (len(strings), h * w * C))
        dec = coding.BatchRansDecoder(strings)
        try:
            sym = dec.decode_stream(idx, t.quantized_cdf, t.cdf_length, t.offset,
                                    lut=t.symbol_lut())
        finally:
            dec.close()
        return _canonical(torch.from_numpy(_unflat(sym, C, h, w, False)).to(self.device))

    def _encode_y_host(self, sym: torch.Tensor, index: torch.Tensor) -> List[bytes]:
        """(B, N, D) symbols and indexes -> one host rANS stream an image,
        token by token."""
        B = sym.shape[0]
        gt = self.tables.gaussian
        return coding.encode_batch(sym.reshape(B, -1).cpu().numpy(),
                                   index.reshape(B, -1).cpu().numpy(),
                                   gt.quantized_cdf, gt.cdf_length, gt.offset)


class Stf3Codec(_TokenCodec):
    """compress()/decompress() for ``masked_ctx.ClipEncoder3`` (either mask)
    and ``ClipEncoder4(causal=True)``; strings = [y_strings, z_strings].

    ``tables``, ``wire``: see :class:`_TokenCodec`; ``latent_scale``: see
    the module docstring."""

    # the keys of compress's output that decompress takes after the strings
    DECOMPRESS_KEYS = ("shape",)

    def __init__(self, model, tables: Optional[CodecTables] = None, wire: str = "host",
                 latent_scale: float = 1.0):
        # stf4's coder pass is causal whatever its mask; the codec takes only
        # the model whose forward is that pass (causal=True), as JAX's does
        if model.coder_causal and not model.causal:
            raise ValueError(
                "Stf4Codec needs a causal context model: build with causal=True (the "
                "reference stf4 mask lets token 0 attend to every token)")
        super().__init__(model, tables, wire)
        self.latent_scale = float(latent_scale)

    # --- stages both sides share -------------------------------------------------
    def _context(self, m_tok, s_tok, y_buf):
        """The one context pass: -> (round(mu), int32 scale indexes), (B, N, D)."""
        mu, scale = self.model.causal_mu_scale(m_tok, s_tok, y_buf)
        return torch.round(mu), build_indexes(scale, self._scale_table).to(torch.int32)

    def _reconstruct(self, y_buf, means, scales, lattice, out_hw):
        """-> (y_hat NCHW, x_hat NHWC in [0, 1]) from the integer tokens."""
        mdl = self.model
        y_hat = mdl.coder_reconstruct(y_buf, means, scales, lattice, out_hw)
        x_hat = torch.clamp(mdl.synthesize(y_hat), 0.0, 1.0)
        return y_hat, x_hat.permute(0, 2, 3, 1).contiguous()

    def _tokens(self, y, z_sym):
        return self.model.coder_tokens(y, z_sym.to(torch.float32) + self._z_offset())

    # --- public API ----------------------------------------------------------------
    @torch.no_grad()
    def symbols(self, x) -> torch.Tensor:
        """x as :meth:`compress` takes it -> y's int32 symbols (B, N, D),
        as both wires code them."""
        return self._encode(x)["sym"]

    def _encode(self, x) -> Dict[str, Any]:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y, z = self.model.analyze(nhwc_to_nchw(x))
        if self.latent_scale != 1.0:
            y, z = y * self.latent_scale, z * self.latent_scale
        z_sym = _canonical(torch.round(z - self._z_offset()).to(torch.int32))
        y_tok, m_tok, s_tok, means, scales, lattice, out_hw = self._tokens(y, z_sym)
        mu, index = self._context(m_tok, s_tok, y_tok)
        return dict(sym=(y_tok - mu).to(torch.int32), index=index, z_sym=z_sym,
                    tokens=(y_tok, m_tok, s_tok), recon=(means, scales, lattice, out_hw))

    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). -> {"strings": [y, z],
        "shape": z's (h, w)}; with ``return_debug`` also the decoder's
        "y_hat" (NCHW) and "x_hat" (NHWC)."""
        enc = self._encode(x)
        z_sym = enc["z_sym"]
        if self.wire == "device":
            y_strings = encode_token_lanes(self.kit, enc["sym"], enc["index"])
        else:
            y_strings = self._encode_y_host(enc["sym"], enc["index"])
        z_strings = self._code_z(z_sym)
        out: Dict[str, Any] = {"strings": [y_strings, z_strings],
                               "shape": (z_sym.shape[2], z_sym.shape[3])}
        if return_debug:
            out["y_hat"], out["x_hat"] = self._reconstruct(enc["tokens"][0], *enc["recon"])
        return out

    @torch.no_grad()
    def decompress(self, strings, shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": (B, M, h, w)}."""
        y_strings, z_strings = strings
        z_sym = self._decode_z(z_strings, shape)
        B = z_sym.shape[0]
        # the token geometry from a zero latent of the hyper-decoders' grid (x4)
        zero_y = torch.zeros(B, self.model.latent_dim, 4 * shape[0], 4 * shape[1],
                             device=self.device)
        _, m_tok, s_tok, means, scales, lattice, out_hw = self._tokens(zero_y, z_sym)
        # the tokens in the encoder's dtype, the transforms' (bfloat16 under
        # the policy, as the hyper-decoders'), so that the two sides
        # reconstruct alike; JAX's decoder holds float32 (ROADMAP Queue 3)
        y_buf = torch.zeros(m_tok.shape, dtype=m_tok.dtype, device=self.device)
        if self.wire == "device":
            self._decode_y_lanes(y_strings, m_tok, s_tok, y_buf)
        else:
            self._decode_y_host(y_strings, m_tok, s_tok, y_buf)
        y_hat, x_hat = self._reconstruct(y_buf, means, scales, lattice, out_hw)
        return {"x_hat": x_hat, "y_hat": y_hat}

    # --- the host wire ---------------------------------------------------------------
    def _decode_y_host(self, y_strings: List[bytes], m_tok, s_tok, y_buf) -> None:
        """Token by token: the pass, token i's indexes to the host, rANS,
        its symbols back into row i of ``y_buf``."""
        B, N, D = y_buf.shape
        gt = self.tables.gaussian
        lut = gt.symbol_lut()
        dec = coding.BatchRansDecoder(y_strings)
        try:
            for i in range(N):
                mu, index = self._context(m_tok, s_tok, y_buf)
                sym = dec.decode_stream(index[:, i].cpu().numpy(), gt.quantized_cdf,
                                        gt.cdf_length, gt.offset, lut=lut)
                y_buf[:, i] = torch.from_numpy(sym).to(self.device) + mu[:, i]
        finally:
            dec.close()

    # --- the device wire ---------------------------------------------------------------
    def _decode_y_lanes(self, y_strings: List[bytes], m_tok, s_tok, y_buf) -> None:
        """The streams up once, then per token the pass and one decode
        launch continuing every lane, row i of ``y_buf`` written on the
        card: no host round trip."""
        from .scan_codec import _wire_inputs

        B, N, D = y_buf.shape
        L = B * D  # one token = one step of every lane
        _, words, off, esc_d, esc_r = _wire_inputs(y_strings, N, L, L, N * L, self.device)
        state = ptr = None
        for i in range(N):
            mu, index = self._context(m_tok, s_tok, y_buf)
            vals, state, ptr = decode_lanes(words, off, index[:, i].reshape(1, L),
                                            self.kit.gauss_dev, state, ptr)
            vals = fix_escapes(vals, esc_d[i], esc_r[i])
            y_buf[:, i] = vals.reshape(B, D).to(mu.dtype) + mu[:, i]


# ClipEncoder4 has the same coder-facing stages, so one codec class serves both
Stf4Codec = Stf3Codec


def token_chain(model, scale_table: torch.Tensor, m_win, s_win, symbols):
    """``stf2``'s token loop, the float code both coder sides and both wires
    run. Step i: the context of the hyper windows (B, N, s, D) at i and the
    history (the s tokens before it, zeros before the first; step 0 in its
    own concat order), the scale indexes, ``symbols(i, mu, index)`` -> the
    token's int32 symbols (B, C', ws, ws), ``y_hat = sym + mu`` in mu's
    dtype, plus the LRP; the token joins the history. -> (tokens (B, N,
    D), symbols and indexes (B, N, D), each token's (h, w, c) as the JAX
    wires lay them)."""
    B, N, _, D = m_win.shape
    prev = m_win.new_zeros(B, model.num_sliding, D)

    def hwc(a):
        return a.permute(0, 2, 3, 1).reshape(B, D)

    toks, syms, idxs = [], [], []
    for i in range(N):
        mu, scale, ctx = model.token_context(m_win[:, i], s_win[:, i], prev, i == 0)
        index = build_indexes(scale, scale_table).to(torch.int32)
        sym = _canonical(symbols(i, mu, index))
        y_hat = sym.to(mu.dtype) + mu
        tok = (y_hat + model.token_lrp(ctx, y_hat)).reshape(B, D)
        prev = torch.cat([prev[:, 1:], tok[:, None]], 1)
        toks.append(tok)
        syms.append(hwc(sym))
        idxs.append(hwc(index))
    return torch.stack(toks, 1), torch.stack(syms, 1), torch.stack(idxs, 1)


def encode_symbols(model, y_tok, narrow: float):
    """The encoder's ``symbols`` of :func:`token_chain`: ``enc_round(y_i -
    mu, narrow)`` of y's token i as a (B, C', ws, ws) block."""
    y_blocks = model._blocks(y_tok)
    return lambda i, mu, _: enc_round(y_blocks[:, i] - mu, narrow).to(torch.int32)


class Stf2Codec(_TokenCodec):
    """compress()/decompress() for ``masked_ctx.ClipEncoder`` (``stf2``);
    strings = [y_strings, z_strings]. Port of the JAX package's
    ``crc_codec.Stf2Codec`` and its scan wire (``scan_codec.Stf2ScanWire``).

    Both sides run :func:`token_chain`: the encoder with
    ``enc_round(y - mu, narrow)`` as the symbols, the decoder with the
    symbols it decodes. z: the factorized bottleneck with ``narrow`` too
    (its symbols NHWC on the host wire, as ``SegOjCodec._code_z``).
    ``compress`` gives "shape" (z's), "out_hw" (the latent's) and
    "lattice" (window rows, columns); :meth:`decompress` takes them.

    ``wire="host"``: rANS on the host, one stream an image, each token's
    symbols (h, w, c) in order; the decoder brings each token's indexes to
    the host and its symbols back: N round trips. ``wire="device"``: the
    token scan (``scan_codec.Stf2ScanWire``): lanes (image, token element),
    B * D lanes and one step a token, in JAX's ``WIRE_SCAN`` format with
    its tier byte; compress runs the N steps and one encode launch for y
    (and one for z), decompress uploads the streams once and makes one
    decode launch a token, the lane state carried on the card, with no host
    round trip. Its programs (the analysis front, the hyper windows, the
    token chain each way, assembly and synthesis) are captured as CUDA
    graphs on the card (``graphs.GraphCache``); ``cuda_graphs=False`` runs
    them launch by launch. The bfloat16 policy applies to both wires, as in
    the JAX package (y_hat takes mu's dtype)."""

    DECOMPRESS_KEYS = ("shape", "out_hw", "lattice")

    def __init__(self, model, tables: Optional[CodecTables] = None, narrow: float = 1.0,
                 wire: str = "host", cuda_graphs: bool = True):
        super().__init__(model, tables, wire)
        self.narrow = float(narrow)
        if wire == "device":
            from ..graphs import GraphCache
            from .scan_codec import Stf2ScanWire

            self.graphs = GraphCache(enabled=cuda_graphs)
            self._scan = Stf2ScanWire(self.model, self.kit, self._scale_table, self.graphs,
                                      narrow=self.narrow)

    # --- stages both sides share -------------------------------------------------
    def _sync(self) -> None:
        """Before a device-wire call: the captured programs of the current
        weights and policy."""
        if self.graphs.refresh(weights_version(self.model)):
            self._medians = None

    def _run(self, key: tuple, fn, inputs):
        if self.wire == "device":
            return self.graphs.run(key, fn, inputs)
        return tuple(fn(*inputs))

    def _front(self, x):
        """NHWC images -> (z's int32 symbols, y's tokens (B, N, D))."""
        y, z = self.model.analyze(nhwc_to_nchw(x))
        z_sym = enc_round(z - self._z_offset(), self.narrow).to(torch.int32)
        return z_sym, self.model._tokens(y)[0]

    def _windows(self, z_sym):
        return self.model.hyper_windows(self._z_hat(z_sym))

    def _assemble(self, toks, lattice, out_hw):
        """(B, N, D) tokens -> (y_hat (B, M, h, w), x_hat NHWC in [0, 1])."""
        mdl = self.model
        y_hat = mdl.tokens_assemble(toks, lattice, out_hw)
        x_hat = torch.clamp(mdl.synthesize(y_hat), 0.0, 1.0)
        return y_hat, x_hat.permute(0, 2, 3, 1).contiguous()

    def encode_chain(self, m_win, s_win, y_tok):
        """The encoder's N steps, launch by launch -> (tokens, symbols,
        indexes) (B, N, D)."""
        return token_chain(self.model, self._scale_table, m_win, s_win,
                           encode_symbols(self.model, y_tok, self.narrow))

    # --- public API ----------------------------------------------------------------
    @torch.no_grad()
    def symbols(self, x) -> torch.Tensor:
        """x as :meth:`compress` takes it -> y's int32 symbols (B, N, D),
        as both wires code them (host wire, launch by launch)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        z_sym, y_tok = self._front(x)
        return self.encode_chain(*self._windows(_canonical(z_sym)), y_tok)[1]

    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). -> {"strings": [y, z],
        "shape", "out_hw", "lattice"}; with ``return_debug`` also the
        decoder's "y_hat" (NCHW) and "x_hat" (NHWC)."""
        if self.wire == "device":
            self._sync()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        z_sym, y_tok = self._run(("front",) + tuple(x.shape), self._front, [x])
        z_sym = _canonical(z_sym)
        m_win, s_win = self._run(("windows",) + tuple(z_sym.shape), self._windows, [z_sym])
        if self.wire == "device":
            y_strings, toks = self._scan.encode(m_win, s_win, y_tok)
        else:
            toks, sym, index = self.encode_chain(m_win, s_win, y_tok)
            y_strings = self._encode_y_host(sym, index)
        z_strings = self._code_z(z_sym)
        y_hw = tuple(-(-d // self.model.latent_stride) for d in x.shape[1:3])
        lattice = tuple(-(-d // self.model.mask_win_size) for d in y_hw)
        out: Dict[str, Any] = {"strings": [y_strings, z_strings],
                               "shape": (z_sym.shape[2], z_sym.shape[3]),
                               "out_hw": y_hw, "lattice": lattice}
        if return_debug:
            y_hat, x_hat = self._run(("assemble", lattice, y_hw) + tuple(toks.shape),
                                     functools.partial(self._assemble, lattice=lattice,
                                                       out_hw=y_hw), [toks])
            out.update(y_hat=y_hat.clone(), x_hat=x_hat.clone())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, out_hw, lattice) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": (B, M, h, w)}."""
        if self.wire == "device":
            self._sync()
        y_strings, z_strings = strings
        out_hw, lattice = tuple(out_hw), tuple(lattice)
        z_sym = self._decode_z(z_strings, shape)
        m_win, s_win = self._run(("windows",) + tuple(z_sym.shape), self._windows, [z_sym])
        if self.wire == "device":
            toks = self._scan.decode(y_strings, m_win, s_win)
        else:
            toks = self._decode_y_host(y_strings, m_win, s_win)
        y_hat, x_hat = self._run(("assemble", lattice, out_hw) + tuple(toks.shape),
                                 functools.partial(self._assemble, lattice=lattice,
                                                   out_hw=out_hw), [toks])
        return {"x_hat": x_hat.clone(), "y_hat": y_hat.clone()}

    # --- the host wire ---------------------------------------------------------------
    def _decode_y_host(self, y_strings: List[bytes], m_win, s_win) -> torch.Tensor:
        """Token by token: the step, its indexes to the host, rANS, its
        symbols back. -> tokens (B, N, D)."""
        mdl = self.model
        B, D = m_win.shape[0], m_win.shape[-1]
        ws, Cp = mdl.mask_win_size, mdl.slice_ch
        gt = self.tables.gaussian
        lut = gt.symbol_lut()
        dec = coding.BatchRansDecoder(y_strings)

        def host_symbols(i, mu, index):
            idx = index.permute(0, 2, 3, 1).reshape(B, D).cpu().numpy()
            sym = dec.decode_stream(idx, gt.quantized_cdf, gt.cdf_length, gt.offset, lut=lut)
            return torch.from_numpy(sym.reshape(B, ws, ws, Cp)).to(self.device).permute(0, 3, 1, 2)

        try:
            return token_chain(mdl, self._scale_table, m_win, s_win, host_symbols)[0]
        finally:
            dec.close()
