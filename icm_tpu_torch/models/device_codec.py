"""The device wire: entropy coding on the card.

Port of ``icm_tpu/models/device_codec.py``. ``CharmCodec`` (``codec.py``)
codes on the host, so its decoder crosses to the host once per slice (the
slice's scale index down, rANS there, the symbols up). ``DeviceWireCodec``
codes with the lane-parallel rANS of ``coding/device_rans.py`` on the
card, in the same queue as the context convolutions:

- decompress: the bitstream (words, lane offsets, escape pairs) goes up
  once, from pinned memory without waiting; then every slice is context
  convolutions and one decode kernel, queued without a host round trip;
  nothing comes back until x_hat;
- compress: the forward and the symbols as on the host wire, then one
  encode kernel for y and one for z, and for each the lengths, the escape
  count and pairs, and the words come back.

Both directions run ``CharmCodec``'s float code (``_encode_symbols``, and
the decoder's ``_context``/``_reconstruct``/``_finish`` loop), so the
device wire's y_hat equals the host wire's bit for bit; the coder is
integer arithmetic, so encoder and decoder cannot disagree on it.

Wire layout per image, one bytes object per stream list entry, the same
bytes as the JAX package's device wire:
  magic "\\x93IW" | uint8 format 0xD2 |
  uint32 n_lanes | uint32 n_words | uint32 n_esc |
  uint16 lengths[n_lanes] | uint16 words[n_words] |
  int32 dest[n_esc] | int32 raw[n_esc]
``dest`` is the image-local step-major position (t * n_lanes + lane) of an
escaped symbol whose raw 32-bit value is ``raw``.

Layout: the port holds latents NCHW; a Gaussian-coded tensor goes to
lanes through NHWC, as the JAX package lays it out: (B, h, w, C) ->
(B, n_l, ppl, C) -> (ppl, C, B, n_l) -> (ppl * C, B * n_l), with ppl =
h * w / n_l pixels per lane; a slice-AR tensor concatenates each slice's
layout along the steps. A bottleneck-coded z takes lanes over pixels and
channel groups: (B * zh * zw, G, C / G) transposed to (C / G, pixels * G).

``scan_wire=True`` serves the scan wire instead (``scan_codec.py``): the
whole AR chain as one program both sides run, tagged ``WIRE_SCAN``. Its
four programs (the encode front: analysis, z's symbols and the latent
slices; the conditioning: z_hat and the hyper-decoders, and for the
zigzag family their blocks concatenated; the chain with the family's
refiners, one graph each way; assembly and synthesis) are captured as CUDA graphs on
the card (``graphs.py``) and replayed; ``cuda_graphs=False`` runs the
same functions launch by launch, as the CPU does. The JAX scan wire runs
in float32 only (its context convolutions raise under the bfloat16
policy), so this one raises under the policy too.

Left out on purpose: the JAX wire's bucket padding of words and escapes
(``_round_up``, ``esc_cap``), which keeps XLA from recompiling per shape
and never reaches the wire; PyTorch compiles nothing per shape.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np
import torch

from ..coding.device_rans import (
    assemble_streams,
    build_device_tables,
    decode_lanes,
    encode_lanes,
    fix_escapes,
    lane_offsets,
)
from ..coding.wire import WIRE_DEVICE, WIRE_MAGIC, wire_offset
from ..graphs import GraphCache, weights_version
from ..nn.layers import activation_dtype
from .base import nhwc_to_nchw
from .codec import CharmCodec, _canonical, enc_round

# channel groups of a bottleneck-coded tensor's lanes (lane = pixel x
# group, serial depth C / groups), the JAX package's default
Z_LANE_GROUPS = 8


def _pack_wire(lengths, words, dest, raw, fmt: int = WIRE_DEVICE) -> bytes:
    head = WIRE_MAGIC + bytes([fmt]) + struct.pack(
        "<III", lengths.shape[0], words.shape[0], dest.shape[0])
    return (head + lengths.astype("<u2").tobytes() + words.astype("<u2").tobytes()
            + dest.astype("<i4").tobytes() + raw.astype("<i4").tobytes())


def _unpack_wire(blob, expect: int = WIRE_DEVICE, skip: int = 0):
    """-> (lengths, words, dest, raw) of one image's wire; ``skip`` bytes
    after the tag are passed over (the scan wire's tier byte)."""
    o = wire_offset(blob, expect) + skip
    n_lanes, n_words, n_esc = struct.unpack_from("<III", blob, o)
    o += 12
    lengths = np.frombuffer(blob, "<u2", count=n_lanes, offset=o).astype(np.int64)
    o += 2 * n_lanes
    words = np.frombuffer(blob, "<u2", count=n_words, offset=o)
    o += 2 * n_words
    dest = np.frombuffer(blob, "<i4", count=n_esc, offset=o)
    o += 4 * n_esc
    raw = np.frombuffer(blob, "<i4", count=n_esc, offset=o)
    return lengths, words, dest, raw


class _Upload:
    """One wire batch on the device: the words, the lane offsets and the
    escape pairs (global step-major positions, ascending), each sent once
    from pinned memory without waiting. :meth:`segment` hands out the
    escapes of a range of positions as device views, rebased; the host
    finds the range in its own copy of the positions, so no segment costs
    a transfer or a wait."""

    def __init__(self, device, words, off, dest, raw):
        self.words = _to_device(words.view(np.int16), device)
        self.off = _to_device(off, device)
        self.dest = dest
        self._dest = _to_device(dest, device)
        self._raw = _to_device(raw, device)

    def segment(self, lo: int, hi: int):
        """Escapes at positions [lo, hi) -> (dest - lo, raw) on the
        device, or None where there are none."""
        a, b = np.searchsorted(self.dest, [lo, hi], side="left")
        if a == b:
            return None
        return self._dest[a:b] - lo, self._raw[a:b]


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceWireKit:
    """The device wire's entropy-coding stages over one Gaussian
    scale-table and any number of named bottleneck tables, with the
    host-side wire assembly. ``DeviceWireCodec`` drives its coding through
    one kit, so the wire format is defined in one place.

    ``lanes_per_image``: independent rANS streams per image for
    Gaussian-coded tensors; bottleneck-coded tensors take
    ``Z_LANE_GROUPS`` channel groups. Tensors are NCHW on ``device``.
    """

    def __init__(self, tables, lanes_per_image: int = 1024, device="cuda"):
        self.device = torch.device(device)
        self.lanes_per_image = lanes_per_image
        self.gauss_dev = build_device_tables(tables.gaussian, self.device)
        self.eb_dev = {k: build_device_tables(t, self.device)
                       for k, t in tables.bottlenecks.items()}

    # --- layout ---------------------------------------------------------
    def n_lanes(self, h: int, w: int) -> int:
        n_l = min(self.lanes_per_image, h * w)
        while (h * w) % n_l:
            n_l -= 1
        return n_l

    @staticmethod
    def z_groups(C: int) -> int:
        """Channel groups of a C-channel bottleneck-coded tensor: the most
        up to ``Z_LANE_GROUPS`` that divide C."""
        G = min(Z_LANE_GROUPS, C)
        while C % G:
            G -= 1
        return G

    @staticmethod
    def to_lanes(a: torch.Tensor, n_l: int) -> torch.Tensor:
        """(B, C, h, w) -> (ppl * C, B * n_l) step-major lane layout of its
        NHWC order."""
        B, C, h, w = a.shape
        ppl = (h * w) // n_l
        lanes = a.reshape(B, C, n_l, ppl).permute(3, 1, 0, 2)
        return lanes.reshape(ppl * C, B * n_l).contiguous()

    @staticmethod
    def from_lanes(vals: torch.Tensor, B: int, C: int, h: int, w: int) -> torch.Tensor:
        """(ppl * C, B * n_l) decoded values -> (B, C, h, w)."""
        n_l = vals.shape[1] // B
        ppl = (h * w) // n_l
        return vals.reshape(ppl, C, B, n_l).permute(2, 1, 3, 0).reshape(B, C, h, w)

    def z_rows(self, C: int, G: int, n_px: int) -> torch.Tensor:
        """(C / G, n_px * G) row map: lane (px, g) codes channels g * C / G
        .. (g + 1) * C / G - 1 in order."""
        r = torch.arange(C, dtype=torch.int32, device=self.device).reshape(G, C // G).t()
        return r[:, None, :].expand(C // G, n_px, G).reshape(C // G, n_px * G).contiguous()

    # --- encode side ------------------------------------------------------
    @staticmethod
    def fetch_encoded(enc_out, B: int):
        """(buf, lengths, dest, raw, n_esc) from ``encode_lanes`` -> per
        image (lengths, decode-order words, image-local dest, raw) host
        arrays. Two copies: the lengths with the escape pairs, then the
        words up to the longest lane."""
        buf, lengths, dest, raw, n_esc = enc_out
        lanes = buf.shape[0]
        n_l = lanes // B
        small = torch.cat([lengths, dest, raw]).cpu().numpy()
        len_h = small[:lanes].astype(np.int64)
        dest_h = small[lanes:lanes + n_esc].astype(np.int64)
        raw_h = small[lanes + n_esc:]
        buf_h = buf[:, :int(len_h.max())].cpu().numpy().view(np.uint16)
        # global t * (B * n_l) + b * n_l + l -> image b, local t * n_l + l
        t = dest_h // lanes
        lane = dest_h - t * lanes
        img = lane // n_l
        local = t * n_l + (lane - img * n_l)
        out = []
        for b in range(B):
            sel = img == b
            rows = slice(b * n_l, (b + 1) * n_l)
            out.append((len_h[rows], assemble_streams(buf_h[rows], len_h[rows]),
                        local[sel].astype(np.int32), raw_h[sel].astype(np.int32)))
        return out

    def encode_y_slices(self, syms: List[torch.Tensor], idxs: List[torch.Tensor]) -> List[bytes]:
        """Gaussian-coded AR tensor: per slice (B, c, h, w) int32 symbols and
        scale indexes, laid out slice by slice along the steps, one encode
        launch, one wire per image."""
        B, _, h, w = syms[0].shape
        n_l = self.n_lanes(h, w)
        vals_T = torch.cat([self.to_lanes(s, n_l) for s in syms])
        rows_T = torch.cat([self.to_lanes(i.to(torch.int32), n_l) for i in idxs])
        enc = encode_lanes(vals_T, rows_T, self.gauss_dev)
        return [_pack_wire(*p) for p in self.fetch_encoded(enc, B)]

    def encode_y_stack(self, syms: torch.Tensor, idxs: torch.Tensor,
                       fmt: int = WIRE_DEVICE) -> List[bytes]:
        """Stacked (N, B, c, h, w) int32 symbols and scale indexes (the scan
        wire's outputs) -> the lane layout of :meth:`encode_y_slices` (each
        slice's layout in slice order along the steps), one encode launch,
        one wire per image tagged ``fmt``."""
        N, B, C, h, w = syms.shape
        n_l = self.n_lanes(h, w)
        ppl = (h * w) // n_l

        def lay(a):  # (N, B, C, n_l, ppl) -> (N, ppl, C, B, n_l)
            a = a.reshape(N, B, C, n_l, ppl).permute(0, 4, 2, 1, 3)
            return a.reshape(N * ppl * C, B * n_l).contiguous()

        enc = encode_lanes(lay(syms), lay(idxs.to(torch.int32)), self.gauss_dev)
        return [_pack_wire(*p, fmt=fmt) for p in self.fetch_encoded(enc, B)]

    def encode_z(self, z_sym: torch.Tensor, key: str) -> List[bytes]:
        """Bottleneck-coded tensor: int32 (B, C, zh, zw) symbols."""
        B, C, zh, zw = z_sym.shape
        G = self.z_groups(C)
        n_px = B * zh * zw
        vals = z_sym.permute(0, 2, 3, 1).reshape(n_px, G, C // G).permute(2, 0, 1)
        vals_T = vals.reshape(C // G, n_px * G).contiguous()
        enc = encode_lanes(vals_T, self.z_rows(C, G, n_px), self.eb_dev[key])
        return [_pack_wire(*p) for p in self.fetch_encoded(enc, B)]

    def encode_gaussian(self, sym: torch.Tensor, index: torch.Tensor) -> List[bytes]:
        """One-shot Gaussian-coded tensor: (B, C, h, w) int32 symbols and
        scale indexes, one wire per image. Decode: :meth:`decode_gaussian`."""
        return self.encode_y_slices([sym], [index])

    # --- decode side ------------------------------------------------------
    def upload_words(self, blobs: List[bytes]) -> _Upload:
        """Per-image wires -> one flat word array, the lane offsets and the
        escape pairs merged at global positions, on the device."""
        words, offs, dests, raws = [], [], [], []
        base = 0
        B = len(blobs)
        for b, blob in enumerate(blobs):
            lengths, w, dest, raw = _unpack_wire(blob)
            if (lengths < 2).any() or int(lengths.sum()) != w.shape[0]:
                raise ValueError(f"wire {b}: lane lengths do not add up to its words")
            n_l = lengths.shape[0]
            offs.append(lane_offsets(lengths) + base)
            base += int(w.shape[0])
            words.append(w)
            # image-local t * n_l + l -> global t * (B * n_l) + b * n_l + l
            t = dest.astype(np.int64) // n_l
            dests.append(t * (B * n_l) + b * n_l + (dest - t * n_l))
            raws.append(raw)
        dest = np.concatenate(dests).astype(np.int64)
        order = np.argsort(dest, kind="stable")  # step-major across images
        return _Upload(self.device, np.concatenate(words), np.concatenate(offs).astype(np.int32),
                       dest[order], np.concatenate(raws).astype(np.int32)[order])

    def decode_z(self, blobs: List[bytes], zh: int, zw: int, key: str) -> torch.Tensor:
        """-> int32 symbols (B, C, zh, zw) on the device."""
        up = self.upload_words(blobs)
        edev = self.eb_dev[key]
        B, C = len(blobs), edev.num_rows
        G = self.z_groups(C)
        n_px = B * zh * zw
        vals, _, _ = decode_lanes(up.words, up.off, self.z_rows(C, G, n_px), edev)
        seg = up.segment(0, vals.numel())
        if seg is not None:
            vals = fix_escapes(vals, *seg)
        return vals.reshape(C // G, B, zh, zw, G).permute(1, 4, 0, 2, 3).reshape(B, C, zh, zw)

    def decode_gaussian(self, blobs: List[bytes], index: torch.Tensor) -> torch.Tensor:
        """One-shot Gaussian-coded tensor: scale indexes (B, C, h, w) ->
        int32 symbols of that shape."""
        return self.y_stream_decoder(blobs, 1).decode_slice(index)

    def y_stream_decoder(self, blobs: List[bytes], n_slices: int) -> "_YStreamDecoder":
        """Chain decoder for a slice-AR tensor coded by
        :meth:`encode_y_slices`."""
        return _YStreamDecoder(self, blobs, n_slices)


class _YStreamDecoder:
    """Carries each lane's decode state along the AR slice chain: a slice
    is one decode launch and its layout ops, queued with no round trip."""

    def __init__(self, kit: DeviceWireKit, blobs: List[bytes], n_slices: int):
        self.kit = kit
        self.n_slices = n_slices
        self.B = len(blobs)
        self.up = kit.upload_words(blobs)
        self.state = self.ptr = None
        self.lo = 0  # first global escape position of the next slice

    def decode_slice(self, index: torch.Tensor) -> torch.Tensor:
        """(B, c, h, w) scale indexes -> int32 symbols of that shape."""
        if self.n_slices <= 0:
            raise RuntimeError("every slice of the streams is decoded")
        B, C, h, w = index.shape
        rows = self.kit.to_lanes(index.to(torch.int32), self.kit.n_lanes(h, w))
        vals, self.state, self.ptr = decode_lanes(
            self.up.words, self.up.off, rows, self.kit.gauss_dev, self.state, self.ptr)
        seg = self.up.segment(self.lo, self.lo + vals.numel())
        if seg is not None:
            vals = fix_escapes(vals, *seg)
        self.lo += vals.numel()
        self.n_slices -= 1
        return self.kit.from_lanes(vals, B, C, h, w)

    def close(self):
        pass


class DeviceWireCodec(CharmCodec):
    """ChARM codec with the entropy coding on the card.

    ``lanes_per_image``: independent rANS streams per image for y (more
    lanes: a shorter chain per slice, +4 bytes of flushed state a lane);
    the serial depth of a slice is h * w / lanes * C_slice. z lanes split
    hyper-pixels and ``Z_LANE_GROUPS`` channel groups.

    ``scan_wire``: serve the scan wire (see the module docstring), float32
    only: ``CharmScanWire`` for the models whose context is
    ``ChannelCharm``'s (``cnn``, ``stf``), ``ZigzagSwinScanWire`` for the
    zigzag family; ``cuda_graphs``: on the card, replay its programs as
    captured graphs (False: launch by launch, for holding the two against
    each other). ``tables`` as ``CharmCodec``'s; the wire defines its own
    symbol order, so ``ref_layout`` raises, as in the JAX package.
    """

    def __init__(self, model, lanes_per_image: int = 1024, narrow: float = 1.0,
                 scan_wire: bool = False, cuda_graphs: bool = True, tables=None,
                 ref_layout: bool = False):
        if ref_layout:
            raise ValueError("DeviceWireCodec defines its own wire; ref_layout applies to "
                             "the host coder only")
        super().__init__(model, tables=tables, narrow=narrow)
        self.kit = DeviceWireKit(self.tables, lanes_per_image=lanes_per_image,
                                 device=self.device)
        self.scan_wire = scan_wire
        if scan_wire:
            from .cnn import ChannelCharm
            from .scan_codec import CharmScanWire, ZigzagSwinScanWire
            from .stf_family import ZigzagSwinCodec

            if isinstance(model, ChannelCharm):
                wire_cls = CharmScanWire
            elif isinstance(model, ZigzagSwinCodec):
                wire_cls = ZigzagSwinScanWire
            else:
                raise NotImplementedError(
                    f"no scan wire drives {type(model).__name__}: the port has CharmScanWire "
                    "(cnn, stf) and ZigzagSwinScanWire (stf5-stf8); serve the device wire "
                    "(scan_wire=False)")
            self._check_f32()
            self.graphs = GraphCache(enabled=cuda_graphs)
            self._scan = wire_cls(self.model, self.kit, self._scale_table, self.graphs,
                                  narrow=narrow)

    # --- the scan wire -------------------------------------------------------
    @staticmethod
    def _check_f32() -> None:
        if activation_dtype() is not None:
            raise ValueError(
                "the scan wire runs in float32 only, as the JAX package's does (its "
                "context convolutions take no bfloat16 activations); set the activation "
                "policy to None or serve the device wire")

    def _scan_sync(self) -> None:
        """Before each scan-wire call: float32 policy, and the stacked
        weights and captured programs of the current weights."""
        self._check_f32()
        if self.graphs.refresh(weights_version(self.model)):
            self._scan.restack()
            self._medians = None

    def _enc_front(self, x):
        """NHWC images -> (z's int32 symbols, the latent slices stacked
        (N, B, sc, h, w))."""
        mdl = self.model
        y, z = mdl.analyze(nhwc_to_nchw(x))
        z_sym = enc_round(z - self._z_offset(), self.narrow).to(torch.int32)
        return z_sym, torch.stack(mdl.latent_slices(y))

    def _scan_state(self, z_sym):
        """z's symbols -> the conditioning (means, scales) the scan wire
        takes."""
        return self._scan.conditioning(self.model.ctx_prepare(self._z_hat(z_sym)))

    def _assemble(self, y_hats):
        """y_hat stack -> (y_hat (B, M, h, w), x_hat NHWC in [0, 1])."""
        y_hat, x_hat = self._finish(list(y_hats))
        return y_hat, x_hat.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def compress(self, x, return_debug: bool = False):
        if not self.scan_wire:
            return super().compress(x, return_debug)
        self._scan_sync()
        run = self.graphs.run
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        z_sym, y_stack = run(("front",) + tuple(x.shape), self._enc_front, [x])
        z_sym = _canonical(z_sym)
        means, scales = run(("state",) + tuple(z_sym.shape), self._scan_state, [z_sym])
        # y first: its encode waits for the card, and z's (the JAX wire's
        # first) would make the chain's graph launch from an idle card
        y_strings, y_hats = self._scan.encode(means, scales, y_stack)
        z_strings = self.kit.encode_z(z_sym, "entropy_bottleneck")
        out = {"strings": [y_strings, z_strings], "shape": (z_sym.shape[2], z_sym.shape[3])}
        if return_debug:
            y_hat, x_hat = run(("assemble",) + tuple(y_hats.shape), self._assemble, [y_hats])
            out.update(y_hat=y_hat.clone(), z_hat=self._z_hat(z_sym), x_hat=x_hat.clone())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape):
        if not self.scan_wire:
            return super().decompress(strings, shape)
        self._scan_sync()
        y_strings, z_strings = strings
        run = self.graphs.run
        z_sym = _canonical(self._decode_z(z_strings, shape))
        means, scales = run(("state",) + tuple(z_sym.shape), self._scan_state, [z_sym])
        y_hats = self._scan.decode(y_strings, means, scales)
        y_hat, x_hat = run(("assemble",) + tuple(y_hats.shape), self._assemble, [y_hats])
        return {"x_hat": x_hat.clone(), "y_hat": y_hat.clone()}

    # --- the device wire -----------------------------------------------------
    def _encode_strings(self, enc) -> List[List[bytes]]:
        return [self.kit.encode_y_slices(enc["syms"], enc["idxs"]),
                self.kit.encode_z(enc["z_sym"], "entropy_bottleneck")]

    def _y_decoder(self, y_strings: List[bytes]) -> _YStreamDecoder:
        return self.kit.y_stream_decoder(y_strings, self.model.ctx_slices)

    def _decode_z(self, strings: List[bytes], shape_hw) -> torch.Tensor:
        zh, zw = shape_hw
        return self.kit.decode_z(strings, zh, zw, "entropy_bottleneck")
