"""The scan wire: the whole ChARM chain as one program both coder sides run.

Port of ``icm_tpu/models/scan_codec.py``'s ``CharmScanWire`` (``cnn``,
``stf``), ``ZigzagSwinScanWire`` (the zigzag family ``stf5``-``stf8``),
``ZigzagScanWire`` (a CRC model's zigzag coding layers: the machine
layer of ``stf9``, ``stf11``, ``stf12`` and ``stf14``, the machine and
segmentation layers of ``stf13``), ``Stf2ScanWire`` (``stf2``'s token
loop, the device wire of ``masked_codec.Stf2Codec``) and the
static-signature helpers they share. The JAX package compiles the whole
autoregressive chain of a prefix-support ChARM model (``cnn``, ``stf``)
as one ``lax.scan``: per slice the context convolutions over stacked,
zero-padded per-slice weights (``cnn.stack_charm_params``), the scale
indexes, the lane rows, the symbols (rounded on encode, rANS-decoded on
the card on decode), ``y_hat = sym + mu`` and LRP. Encoder and decoder
run that one executable, so the context is bit-identical by
construction; a traced flag picks the symbol source.

On the card the counterpart of one executable is one captured CUDA graph
(``graphs.py``). Two graphs, encode and decode, are captured from ONE
step function (:meth:`CharmScanWire._program`) whose float part does not
depend on the direction; the card runs the same kernels with the same
launch configurations on the same shapes, and the codec's numerics
(``codec.cuda_numerics``: deterministic cuDNN, no autotuning, no TF32)
make both compute the same floats. ``chip_smoke.py`` holds that at full
width: decoder y_hat equal to the encoder's, replays equal to launches.

The encode kernel and its escape compaction (a host wait) run after the
encode graph, outside it, as JAX's ``encode_y_stack`` runs after its
scan. Scan-wire streams are tagged ``WIRE_SCAN`` and carry one tier byte
after the tag: the static escape cap the decode program is built for.
They are not interchangeable with the device wire's: the padded first
conv sums in another order than the unrolled per-slice one.

Static signature (JAX's, ``scan_codec.py:73-100``): the decode program's
inputs have shapes that follow from (N, B, h, w, sc) alone: the words a
zeroed buffer of ``_static_word_cap`` 16-bit words (the encoder emits at
most one word a symbol and two a lane), the escapes padded to a cap of
three tiers (1/64, 1/8 or all of a segment, at least 64). The encoder
picks the smallest tier its escape counts fit; the decoder reads it from
the tier byte.

Left out: the mesh parts (``_shard_batch``, ``_replicated``: one card has
no batch sharding); ``_place_words``' power-of-two upload buckets (they
keep XLA from compiling per upload size; the port places the real words
in the static buffer directly); ``_enc_inputs``' zero dummies (the port's
encode program reads no words or escapes, which is also why a higher
tier does not encode again: JAX re-runs because the escape cap is part
of its one executable's signature, and the re-run gives the same
symbols).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..coding.device_rans import decode_lanes, fix_escapes, lane_offsets
from ..coding.wire import WIRE_SCAN, WireFormatError, wire_offset
from ..entropy import build_indexes
from .cnn import stack_charm_params
from .codec import _canonical, enc_round
from .device_codec import _unpack_wire

_WORD_BUCKET = 1 << 16  # the static word buffer's granule (16-bit words)
_ESC_TIER_SHIFTS = (6, 3, 0)  # escape cap = segment >> shift (at least 64)


def _cc_apply(layers: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    """Slice i's context stack from stacked parameters
    ``{"Conv_j": {"weight": (S, O, I, 3, 3), "bias": (S, O)}}``: 3x3
    convolutions, stride 1, same padding, exact GELU between, none after
    the last."""
    names = sorted(layers, key=lambda n: int(n.split("_")[1]))
    for j, ln in enumerate(names):
        x = F.conv2d(x, layers[ln]["weight"][i], layers[ln]["bias"][i], padding=1)
        if j + 1 < len(names):
            x = F.gelu(x)
    return x


def _round_up(n: int, q: int) -> int:
    return ((max(n, 1) + q - 1) // q) * q


def _esc_tier_cap(seg_size: int, tier: int) -> int:
    return max(1, min(seg_size, max(64, seg_size >> _ESC_TIER_SHIFTS[tier])))


def _tier_for(max_seg_count: int, seg_size: int) -> int:
    for t in range(len(_ESC_TIER_SHIFTS)):
        if max_seg_count <= _esc_tier_cap(seg_size, t):
            return t
    return len(_ESC_TIER_SHIFTS) - 1  # unreachable: the last cap is the segment


def _static_word_cap(n_syms: int, lanes: int) -> int:
    return _round_up(n_syms + 2 * lanes, _WORD_BUCKET)


def _host(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor to copy to ``device``: pinned for the
    card, so that the copy does not wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def _place_words(words: np.ndarray, w_cap: int, device) -> torch.Tensor:
    """The real uint16 words -> a zeroed static (w_cap,) int16 buffer
    on ``device`` holding them first (the decode kernel reads int16; the
    JAX package's buffer is int32)."""
    if words.shape[0] > w_cap:
        raise ValueError(f"{words.shape[0]} words exceed the static buffer of {w_cap}")
    out = torch.zeros(w_cap, dtype=torch.int16, device=device)
    if words.shape[0]:
        out[:words.shape[0]].copy_(_host(words.view(np.int16), device), non_blocking=True)
    return out


def _seg_esc_counts(blobs, n_l_img: int, steps_per_seg: int, n_segs: int) -> np.ndarray:
    """Per-segment escape counts of an untiered scan wire, from its bytes
    alone. An image-local escape position is ``t * n_l + lane``; step t
    lies in segment ``t // steps_per_seg``."""
    counts = np.zeros((n_segs,), np.int64)
    for blob in blobs:
        _, _, dest, _ = _unpack_wire(blob, WIRE_SCAN)
        if dest.shape[0]:
            seg = (dest.astype(np.int64) // n_l_img) // steps_per_seg
            counts += np.bincount(seg, minlength=n_segs)[:n_segs]
    return counts


def _wrap_tier(blobs: List[bytes], tier: int) -> List[bytes]:
    """The scan-wire framing: the tier byte after the 4-byte tag."""
    return [b[:4] + bytes([tier]) + b[4:] for b in blobs]


def _wire_inputs(blobs, n_segs: int, seg_size: int, lanes: int, n_syms: int, device):
    """Decode-side wire preparation, all on the host but the uploads, to
    the decode program's static signature -> (tier, words int16 (w_cap,),
    off int32 (lanes,), esc_d, esc_r int32 (n_segs, cap)); esc_d is padded
    with ``seg_size``, which ``fix_escapes`` drops."""
    tiers = set()
    for blob in blobs:
        wire_offset(blob, WIRE_SCAN)
        tiers.add(blob[4])
    if len(tiers) != 1 or not tiers <= set(range(len(_ESC_TIER_SHIFTS))):
        raise WireFormatError(f"scan-wire tier bytes {sorted(tiers)}: one tier of "
                              f"0..{len(_ESC_TIER_SHIFTS) - 1} expected")
    tier = tiers.pop()
    offs, words, dests, raws = [], [], [], []
    base = 0
    B = len(blobs)
    for b, blob in enumerate(blobs):
        lengths, w, dest, raw = _unpack_wire(blob, WIRE_SCAN, skip=1)
        if (lengths < 2).any() or int(lengths.sum()) != w.shape[0]:
            raise ValueError(f"wire {b}: lane lengths do not add up to its words")
        n_l = lengths.shape[0]
        if n_l * B != lanes:
            raise ValueError(f"wire {b} has {n_l} lanes; this decode takes {lanes // B}")
        offs.append(lane_offsets(lengths) + base)
        base += int(w.shape[0])
        words.append(w)
        t = dest.astype(np.int64) // n_l
        dests.append(t * (B * n_l) + b * n_l + (dest - t * n_l))
        raws.append(raw)
    dest = np.concatenate(dests)
    raw = np.concatenate(raws).astype(np.int32)
    order = np.argsort(dest, kind="stable")
    dest, raw = dest[order], raw[order]

    cap = _esc_tier_cap(seg_size, tier)
    esc_d = np.full((n_segs, cap), seg_size, np.int32)
    esc_r = np.zeros((n_segs, cap), np.int32)
    for i in range(n_segs):
        a, b2 = np.searchsorted(dest, [i * seg_size, (i + 1) * seg_size], side="left")
        if b2 - a > cap:
            raise ValueError(f"segment {i} has {b2 - a} escapes, over tier {tier}'s cap {cap}")
        esc_d[i, :b2 - a] = dest[a:b2] - i * seg_size
        esc_r[i, :b2 - a] = raw[a:b2]
    words = _place_words(np.concatenate(words), _static_word_cap(n_syms, lanes), device)
    off = torch.empty(lanes, dtype=torch.int32, device=device)
    off.copy_(_host(np.concatenate(offs).astype(np.int32), device), non_blocking=True)
    esc = []
    for a in (esc_d, esc_r):
        t = torch.empty(a.shape, dtype=torch.int32, device=device)
        esc.append(t.copy_(_host(a, device), non_blocking=True))
    return tier, words, off, esc[0], esc[1]


class _StaticScanIO:
    """What every scan wire shares: the static-signature plumbing (the
    three-tier escape ladder), the lane layout, the step loop of both
    directions (:meth:`_program`) and both run through the owner's
    ``GraphCache``. A wire supplies ``N`` (the segment count: its
    slices), ``kit``, ``graphs``, ``sc`` (a slice's channels),
    ``max_sup``, ``prefix`` and ``Wc`` (its support and conditioning),
    ``_stacked`` (the stacked context convolutions, built by
    :meth:`restack`), :meth:`conditioning` and, where it has refiners,
    :meth:`_refine`."""

    def __init__(self, model, kit, scale_table: torch.Tensor, graphs, narrow: float):
        self.model = model
        self.kit = kit
        self.scale_table = scale_table
        self.graphs = graphs
        self.narrow = narrow
        self.N = int(model.ctx_slices)

    def _encode_tiered(self, run_pack, n_l_img: int, steps_per_seg: int, seg_size: int):
        """``run_pack()`` -> (outs, untiered blobs); -> (blobs framed with
        the smallest tier whose cap holds every segment's escapes (the last
        cap is a whole segment, so one always does), outs)."""
        outs, blobs = run_pack()
        counts = _seg_esc_counts(blobs, n_l_img, steps_per_seg, self.N)
        return _wrap_tier(blobs, _tier_for(int(counts.max()), seg_size)), outs

    def _layout(self, B: int, h: int, w: int, sc: int):
        """(n_l per image, lanes, steps a segment, symbols a segment)."""
        n_l = self.kit.n_lanes(h, w)
        L = B * n_l
        Ts = ((h * w) // n_l) * sc
        return n_l, L, Ts, Ts * L

    def encode(self, means: torch.Tensor, scales: torch.Tensor, y_stack: torch.Tensor):
        """Conditioning (B, C, h, w) (:meth:`conditioning`) and latent
        slices (N, B, sc, h, w) -> (tier-framed wire blobs, one an image;
        y_hat stack (N, B, sc, h, w), which the next encode overwrites)."""
        _, B, sc, h, w = y_stack.shape
        n_l, L, Ts, seg = self._layout(B, h, w, sc)

        def run_pack():
            y_hats, syms, idxs = self.graphs.run(
                self._key("encode", B, h, w, None), self._program(True), [means, scales, y_stack])
            return y_hats, self.kit.encode_y_stack(syms, idxs, fmt=WIRE_SCAN)

        return self._encode_tiered(run_pack, n_l, Ts, seg)

    def decode(self, blobs: List[bytes], means: torch.Tensor, scales: torch.Tensor):
        """-> y_hat stack (N, B, sc, h, w), which the next decode
        overwrites. The latent grid is the conditioning's."""
        B, _, h, w = means.shape
        if len(blobs) != B:
            raise ValueError(f"{len(blobs)} wires for a conditioning of {B} images")
        _, L, _, seg = self._layout(B, h, w, self.sc)
        tier, words, off, esc_d, esc_r = _wire_inputs(
            blobs, self.N, seg, L, self.N * seg, means.device)
        (y_hats,) = self.graphs.run(self._key("decode", B, h, w, tier), self._program(False),
                                    [means, scales, words, off, esc_d, esc_r])
        return y_hats

    prefix = True  # prefix support (slot i, then frozen), else sliding
    Wc = 0  # conditioning window in zigzag blocks; 0: the whole of it

    def _key(self, *parts) -> tuple:
        """The graph cache's key of a chain program: "scan", its direction
        and shapes."""
        return ("scan",) + parts

    def _refine(self, tag: str, i: int, x: torch.Tensor) -> torch.Tensor:
        """Slice i's ``tag`` refiner ("mu", "sigma", "lrp") on x: none here."""
        return x

    def _program(self, is_enc: bool):
        """The step loop of both directions: (means, scales, y_stack) ->
        (y_hats, syms, idxs) on encode; (means, scales, words, off,
        esc_d, esc_r) -> (y_hats,) on decode. The conditioning is (B, C,
        h, w), the stacks (N, B, sc, h, w); only the symbol source depends
        on ``is_enc``."""
        W, N, sc, max_sup, Wc = self._stacked, self.N, self.sc, self.max_sup, self.Wc

        def program(cond_m, cond_s, *rest):
            B, _, h, w = cond_m.shape
            y_stack = rest[0] if is_enc else None
            dec = None if is_enc else [*rest, None, None]
            buf = cond_m.new_zeros((B, max_sup * sc, h, w))
            y_hats, syms, idxs = [], [], []
            for i in range(N):
                cm, cs = cond_m, cond_s
                if Wc:  # blocks [s, s + Wc), clamped at the tail
                    s = min(i, N - Wc)
                    cm, cs = cond_m[:, s * sc:(s + Wc) * sc], cond_s[:, s * sc:(s + Wc) * sc]
                mean_support = torch.cat([cm, buf], 1)
                mu = self._refine("mu", i, _cc_apply(W["cc_mean"], i, mean_support))
                scale = self._refine("sigma", i,
                                     _cc_apply(W["cc_scale"], i, torch.cat([cs, buf], 1)))
                index = build_indexes(scale, self.scale_table)
                sym = self._symbols(is_enc, i, index, mu, y_stack, dec, B)
                y_hat = sym.to(mu.dtype) + mu
                if "lrp" in W:  # of the CRC family, stf13's layers only
                    lrp = _cc_apply(W["lrp"], i, torch.cat([mean_support, y_hat], 1))
                    y_hat = y_hat + 0.5 * torch.tanh(self._refine("lrp", i, lrp))
                if not self.prefix:  # sliding support: newest last
                    buf = torch.cat([buf[:, sc:], y_hat], 1)
                elif i < max_sup:  # prefix support: slot i, then frozen
                    buf[:, i * sc:(i + 1) * sc] = y_hat
                y_hats.append(y_hat)
                syms.append(sym)
                idxs.append(index)
            if is_enc:
                return torch.stack(y_hats), torch.stack(syms), torch.stack(idxs)
            return (torch.stack(y_hats),)

        return program

    def _symbols(self, is_enc: bool, i: int, index, mu, y_stack, dec, B: int):
        """Slice i's int32 symbols (B, sc, h, w), standard strides: rounded
        from the latent on encode; on decode one lane-rANS launch
        continuing ``dec`` = [words, off, esc_d, esc_r, state, ptr] (the
        state and pointers updated in place) and its escapes."""
        if is_enc:
            sym = enc_round(y_stack[i] - mu, self.narrow).to(torch.int32)
        else:
            words, off, esc_d, esc_r, st, pt = dec
            _, sc, h, w = index.shape
            rows = self.kit.to_lanes(index, self.kit.n_lanes(h, w))
            vals, dec[4], dec[5] = decode_lanes(words, off, rows, self.kit.gauss_dev, st, pt)
            vals = fix_escapes(vals, esc_d[i], esc_r[i])
            sym = self.kit.from_lanes(vals, B, sc, h, w)
        return _canonical(sym)


class CharmScanWire(_StaticScanIO):
    """Scan-wire driver of a prefix-support ChARM model (``cnn``, ``stf``):
    the first ``max_support_slices`` reconstructed slices condition every
    later one, and the full-width hyper-decoder outputs enter every
    slice's context.

    ``kit``: the codec's ``DeviceWireKit``; ``scale_table`` on the model's
    device; ``graphs``: the codec's ``GraphCache``, through which both
    directions run (the same functions launch by launch on the CPU).
    :meth:`restack` builds the stacked weights again after the model's
    parameters changed."""

    def __init__(self, model, kit, scale_table: torch.Tensor, graphs, narrow: float = 1.0):
        if not hasattr(model, "max_support_slices"):
            raise ValueError("CharmScanWire drives prefix-support ChARM models (cnn, stf)")
        super().__init__(model, kit, scale_table, graphs, narrow)
        self.max_sup = int(model.max_support_slices)
        cc = model.cc_mean_0
        names = sorted((n for n, _ in cc.named_children() if n.startswith("Conv_")),
                       key=lambda n: int(n.split("_")[1]))
        self.sc = int(getattr(cc, names[-1]).weight.shape[0])
        self.cond_width = int(cc.Conv_0.weight.shape[1])
        self.restack()

    def restack(self) -> None:
        with torch.no_grad():
            self._stacked = stack_charm_params(self.model, self.N, self.sc, self.max_sup,
                                               self.cond_width)["charm_scan"]

    @staticmethod
    def conditioning(state: dict):
        """The model's ``ctx_prepare`` state -> (means, scales) (B, C, h, w)."""
        return state["means"], state["scales"]


class ZigzagSwinScanWire(_StaticScanIO):
    """The scan wire of the zigzag family (``stf_family.ZigzagSwinCodec``,
    ``stf5``-``stf8``): prefix or sliding support, full or window
    conditioning, and per-slice Swin refiners after the context
    convolutions. Port of the JAX package's ``ZigzagSwinScanWire`` with
    the step context it applies (``stf_family._ZigzagCodeCtx``, always
    deterministic).

    Per slice i the step concatenates the conditioning and the support
    buffer, applies slice i's zero-padded first convolution and the rest
    of its stack (:func:`stf_family.stack_zigzag_params`, convolutions
    only), then the model's own slice-i refiner modules: JAX's stacked
    refiner subtree holds the same values, so no second copy of the
    refiners' parameters is made. Conditioning: the hyper-decoders'
    outputs ("full"), or the window of ``mean_window`` zigzag blocks
    ``[s, s + mean_window)``, ``s = min(i, N - mean_window)``, of the
    blocks concatenated block-major (channel ``j * sc + c``, JAX's
    ``moveaxis(v, 0, 3).reshape``). The buffer holds ``max_support``
    slots: prefix support writes slot i while ``i < max_support``, then
    freezes; sliding support shifts left a slot and appends. The padded
    convolutions are rebuilt by :meth:`restack` when the weights change;
    the refiners are read where they are."""

    def __init__(self, model, kit, scale_table: torch.Tensor, graphs, narrow: float = 1.0):
        super().__init__(model, kit, scale_table, graphs, narrow)
        self.sc = int(model.slice_ch)
        self.max_sup = int(model.max_support)
        self.Wc = 0 if model.mean_mode == "full" else int(model.mean_window)
        self.prefix = model.support_mode == "prefix"
        self.restack()

    def restack(self) -> None:
        from .stf_family import stack_zigzag_params

        with torch.no_grad():
            self._stacked = stack_zigzag_params(self.model, self.model,
                                                refiners=False)["zigzag_scan"]

    @staticmethod
    def conditioning(state: dict):
        """The model's ``ctx_prepare`` state -> (means, scales) (B, C, h, w):
        the hyper-decoders' outputs, or their zigzag blocks concatenated
        block-major (C = N * sc)."""
        return torch.cat(state["means"], 1), torch.cat(state["scales"], 1)

    def _refine(self, tag: str, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.model.refine(tag, i, x)


class ZigzagScanWire(_StaticScanIO):
    """The scan wire of one ``zigzag_coder.ZigzagCharmCoder`` layer (a CRC
    model's machine layer, and stf13's segmentation layer). Port of the
    JAX package's ``ZigzagScanWire`` and its ``_zigzag_scan_program``:
    sliding support (the buffer shifts left a slot and appends the newest
    slice), a conditioning window of ``support_num`` zigzag blocks ``[s,
    s + Wc)``, ``s = min(i, N - Wc)``, of the hyper-decoders' blocks
    concatenated block-major, the stacked context convolutions of
    :func:`zigzag_coder.stack_zigzag_params`, and where the layer applies
    LRP (stf13) its step inside the chain: ``y_hat += 0.5 *
    tanh(lrp_i(cat(mean_support, y_hat)))`` on both sides, the mean
    support the conditioning and the whole buffer, as the padded ``lrp``
    kernels expect. ``coder``: the layer, which plays the model's part of
    :class:`_StaticScanIO`; ``layer``: its name, the last part of its
    programs' graph keys (a codec may drive two such layers)."""

    prefix = False

    def __init__(self, coder, kit, scale_table: torch.Tensor, graphs, layer: str,
                 narrow: float = 1.0):
        super().__init__(coder, kit, scale_table, graphs, narrow)
        self.layer = layer
        self.sc = int(coder.slice_ch)
        self.max_sup = int(coder.max_support)
        self.Wc = int(coder.cond_blocks)
        self.restack()

    def _key(self, *parts) -> tuple:
        return super()._key(*parts) + (self.layer,)

    def restack(self) -> None:
        from .zigzag_coder import stack_zigzag_params

        with torch.no_grad():
            self._stacked = stack_zigzag_params(self.model, self.model)["zz_scan"]

    @staticmethod
    def conditioning(state: dict):
        """The coder's ``ctx_prepare`` state -> (means, scales) (B, N * sc,
        h, w): its zigzag blocks concatenated block-major."""
        return torch.cat(state["means"], 1), torch.cat(state["scales"], 1)


class Stf2ScanWire:
    """The device wire of ``stf2`` (``masked_codec.Stf2Codec``): its token
    loop as one program a direction, run through the codec's
    ``GraphCache``. Port of the JAX package's ``Stf2ScanWire``, with the
    static signature of the other scan wires (``_wire_inputs``, the tier
    ladder) but none of :class:`_StaticScanIO`'s slice chain. Both
    directions run ``masked_codec.token_chain``, the encoder with the
    rounded residuals, the decoder with one lane-rANS launch a token;
    step 0's context order is the step's own (a Python branch of the
    unrolled loop, so one program holds both orders). Lanes: (image,
    token element), B * D of them, one step and one escape segment a
    token."""

    def __init__(self, model, kit, scale_table: torch.Tensor, graphs, narrow: float = 1.0):
        self.model = model
        self.kit = kit
        self.scale_table = scale_table
        self.graphs = graphs
        self.narrow = narrow
        self.D = int(model.token_dim)

    def encode(self, m_win: torch.Tensor, s_win: torch.Tensor, y_tok: torch.Tensor):
        """Hyper windows (B, N, s, D) and y's tokens (B, N, D) -> (tier-framed
        wire blobs, one an image; y_hat tokens (B, N, D), which the next
        encode overwrites)."""
        from .masked_codec import encode_token_lanes

        B, N, D = y_tok.shape
        toks, syms, idxs = self.graphs.run(("scan", "encode", B, N), self._program(True),
                                           [m_win, s_win, y_tok])
        return encode_token_lanes(self.kit, syms, idxs), toks

    def decode(self, blobs: List[bytes], m_win: torch.Tensor, s_win: torch.Tensor):
        """-> y_hat tokens (B, N, D), which the next decode overwrites."""
        B, N = m_win.shape[:2]
        if len(blobs) != B:
            raise ValueError(f"{len(blobs)} wires for windows of {B} images")
        L = B * self.D
        tier, words, off, esc_d, esc_r = _wire_inputs(blobs, N, L, L, N * L, m_win.device)
        (toks,) = self.graphs.run(("scan", "decode", B, N, tier), self._program(False),
                                  [m_win, s_win, words, off, esc_d, esc_r])
        return toks

    def _program(self, is_enc: bool):
        """(m_win, s_win, y_tok) -> (tokens, symbols, indexes) on encode,
        (m_win, s_win, words, off, esc_d, esc_r) -> (tokens,) on decode;
        only the symbol source depends on ``is_enc``."""
        from .masked_codec import encode_symbols, token_chain

        mdl = self.model

        def program(m_win, s_win, *rest):
            if is_enc:
                return token_chain(mdl, self.scale_table, m_win, s_win,
                                   encode_symbols(mdl, rest[0], self.narrow))
            words, off, esc_d, esc_r = rest
            B, D = m_win.shape[0], m_win.shape[-1]
            ws, Cp = mdl.mask_win_size, mdl.slice_ch
            lanes = [None, None]  # the lanes' state and pointers, step to step

            def symbols(i, _, index):
                rows = index.permute(0, 2, 3, 1).reshape(1, B * D)
                vals, lanes[0], lanes[1] = decode_lanes(words, off, rows, self.kit.gauss_dev,
                                                        *lanes)
                vals = fix_escapes(vals, esc_d[i], esc_r[i])
                return vals.reshape(B, ws, ws, Cp).permute(0, 3, 1, 2)

            return (token_chain(mdl, self.scale_table, m_win, s_win, symbols)[0],)

        return program
