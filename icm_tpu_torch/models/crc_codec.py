"""Real-bitstream compress/decompress for the CRC family (stf9, stf11, stf14).

Port of ``icm_tpu/models/crc_codec.py``'s ``CRCCodec`` and its
``_CharmLayerDriver`` (the device and scan wires' layer functions too).
The reference shipped no coder for these models; the JAX package's
design, kept here:

    strings = [machine_y, machine_z, human_y, human_z]

- the machine layer is the zigzag ChARM coder, coded slice by slice as
  ``CharmCodec`` codes its slices (:class:`_CharmLayerDriver`: the
  context of slice i, then one step that reconstructs slice i and
  computes slice i + 1's context, shared by both sides, so that the
  context is the same floats on both);
- the human layer is a one-shot conditional Gaussian: the scale indexes
  from its hyper-decoded scales, the means as quantization offsets. The
  decoder rebuilds the conditioning image and context from the machine
  latent, so only the residual layer's streams are sent.

Three wires, as in the JAX codec:

- ``wire="host"``: rANS on the host (``coding/``), one stream an image
  for each of the four; symbols in NHWC order, or with ``ref_layout``
  channel-major as ``CharmCodec`` lays them out;
- ``wire="device"``: the lane rANS on the card (``device_codec.
  DeviceWireKit``): the machine y one encode launch and one decode launch
  a slice, z and the human z as bottleneck lanes, the human y as one
  Gaussian-coded tensor (``encode_gaussian`` / ``decode_gaussian``);
  decompress makes no host round trip;
- ``wire="device", scan_wire=True``: the machine layer's chain on the
  scan wire (``scan_codec.ZigzagScanWire``). Its programs (encode front:
  analysis, z's symbols and the latent slices; conditioning; the chain,
  one program each way; assembly) and the human layer's three (encode
  front, hyper-decoders, synthesis) run through the codec's
  ``graphs.GraphCache``: captured as CUDA graphs on the card and
  replayed, launch by launch with ``cuda_graphs=False`` and on the CPU.
  It runs in float32 only, as the JAX scan wire does.

The machine y_hat and the human x_hat of the host and device wires are
the same floats (the same functions on the same symbols); the scan
wire's context convolutions are zero-padded to one width, which sums in
another order, so its streams are its own. Left out, as ``CharmCodec``
leaves them out: the JAX codec's threaded stream groups
(``pipeline_groups``), which worked around a remote TPU link.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import coding
from ..entropy import build_indexes
from ..graphs import GraphCache, weights_version
from .base import CodecTables, nhwc_to_nchw
from .codec import (
    _canonical,
    _eb_indexes,
    _flat,
    _HostYDecoder,
    _unflat,
    build_codec_tables,
    cuda_numerics,
    enc_round,
)

MACHINE_Z, HUMAN_Z = "entropy_bottleneck", "entropy_bottleneck_human"


class _CharmLayerDriver:
    """The stages of one ``ZigzagCharmCoder`` layer, shared by both coder
    sides: z's symbols and z_hat, the context of a slice, and
    :meth:`step`, which reconstructs slice i from its symbols and computes
    slice i + 1's context."""

    def __init__(self, coder, scale_table: torch.Tensor, narrow: float):
        self.coder = coder
        self.scale_table = scale_table
        self.narrow = narrow
        self._medians = None

    def reset(self) -> None:
        """Forget what was read from the weights (after they changed)."""
        self._medians = None

    def z_offset(self) -> torch.Tensor:
        if self._medians is None:
            self._medians = self.coder.eb_medians().detach().reshape(1, -1, 1, 1)
        return self._medians

    def z_sym(self, z: torch.Tensor) -> torch.Tensor:
        return _canonical(enc_round(z - self.z_offset(), self.narrow).to(torch.int32))

    def z_hat(self, z_sym: torch.Tensor) -> torch.Tensor:
        return z_sym.to(torch.float32) + self.z_offset()

    def context(self, i: int, state, decoded: List[torch.Tensor]):
        """Slice i's (mu, scale index)."""
        c = self.coder
        mu, scale = c.slice_context(i, state, c.ctx_support(i, decoded))
        return mu, build_indexes(scale, self.scale_table)

    def step(self, i: int, state, decoded: List[torch.Tensor], sym: torch.Tensor, ctx):
        """Slice i's y_hat from its int32 symbols and ``ctx`` (its context),
        appended to ``decoded``; -> slice i + 1's context, or None after
        the last."""
        decoded.append(self.coder.reconstruct(_canonical(sym), ctx[0]))
        if i + 1 >= self.coder.ctx_slices:
            return None
        return self.context(i + 1, state, decoded)

    def encode(self, y: torch.Tensor, z_sym: torch.Tensor):
        """The encoder's chain: -> (per slice int32 symbols and scale
        indexes, the y_hat slices)."""
        c = self.coder
        state = c.ctx_prepare(self.z_hat(z_sym))
        y_slices = c.latent_slices(y)
        decoded: List[torch.Tensor] = []
        syms, idxs = [], []
        ctx = self.context(0, state, decoded)
        for i in range(c.ctx_slices):
            sym = _canonical(enc_round(y_slices[i] - ctx[0], self.narrow).to(torch.int32))
            syms.append(sym)
            idxs.append(ctx[1])
            ctx = self.step(i, state, decoded, sym, ctx)
        return syms, idxs, decoded

    def decode(self, z_sym: torch.Tensor, ydec) -> List[torch.Tensor]:
        """The decoder's chain; ``ydec.decode_slice(index)`` gives each
        slice's symbols. -> the y_hat slices."""
        c = self.coder
        state = c.ctx_prepare(self.z_hat(z_sym))
        decoded: List[torch.Tensor] = []
        ctx = self.context(0, state, decoded)
        for i in range(c.ctx_slices):
            ctx = self.step(i, state, decoded, ydec.decode_slice(ctx[1]), ctx)
        return decoded


class CRCCodec:
    """compress()/decompress() for ``crc.ConditionalResidualCoding`` (stf9,
    stf11) and ``crc.ResidualCoding`` (stf14).

    ``tables``: coder tables in place of the model's own
    (``build_codec_tables`` over both bottlenecks); ``narrow``: see
    ``codec.enc_round``; ``wire``, ``scan_wire``, ``cuda_graphs``: the
    module docstring (the device wire codes a Gaussian-coded tensor on up
    to 1024 lanes an image, the JAX codec's default); ``ref_layout``: the
    host wire's channel-major symbol order (``CharmCodec``'s)."""

    def __init__(self, model, tables: Optional[CodecTables] = None, narrow: float = 1.0,
                 wire: str = "host", scan_wire: bool = False, cuda_graphs: bool = True,
                 ref_layout: bool = False):
        if wire not in ("host", "device"):
            raise ValueError(f"wire must be 'host' or 'device', got {wire!r}")
        if scan_wire and wire != "device":
            raise ValueError("scan_wire requires wire='device'")
        if ref_layout and wire != "host":
            raise ValueError("ref_layout applies to the host wire only")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            cuda_numerics()
        self.narrow = narrow
        self.wire = wire
        self.scan_wire = scan_wire
        self.ref_layout = ref_layout
        if tables is None:
            with torch.no_grad():
                tables = build_codec_tables(model)
        self.tables = tables
        self._scale_table = torch.from_numpy(tables.scale_table).to(self.device)
        self._machine = _CharmLayerDriver(model.coder, self._scale_table, narrow)
        self._human_medians = None
        self.graphs = GraphCache(enabled=cuda_graphs and scan_wire)
        if wire == "device":
            from .device_codec import DeviceWireKit

            self.kit = DeviceWireKit(tables, device=self.device)
        if scan_wire:
            from .device_codec import DeviceWireCodec
            from .scan_codec import ZigzagScanWire

            DeviceWireCodec._check_f32()
            self._scan = ZigzagScanWire(model.coder, self.kit, self._scale_table, self.graphs,
                                        narrow=narrow)

    # --- the human layer's stages, shared by both sides ------------------------
    def _human_offset(self) -> torch.Tensor:
        if self._human_medians is None:
            self._human_medians = self.model.human_eb_medians().detach().reshape(1, -1, 1, 1)
        return self._human_medians

    def _human_front(self, x, y_hat):
        """-> (human_y, its hyper-latent's int32 symbols)."""
        human_y, hz = self.model.human_encode(x, y_hat)
        return human_y, enc_round(hz - self._human_offset(), self.narrow).to(torch.int32)

    def _human_hyper(self, hz_sym):
        """The hyper-latent's symbols -> (means, scale indexes) of the human
        latent."""
        z_hat = hz_sym.to(torch.float32) + self._human_offset()
        hyper = self.model.human_hyper
        scales = hyper.h_scale_s(z_hat)
        return hyper.h_mean_s(z_hat), build_indexes(scales, self._scale_table)

    def _human_decode(self, hy_sym, means, y_hat):
        """-> x_hat (B, H, W, 3) in [0, 1]."""
        x_hat = self.model.human_synthesize(hy_sym.to(torch.float32) + means, y_hat)
        return (torch.clamp(x_hat, 0.0, 1.0).permute(0, 2, 3, 1).contiguous(),)

    # --- the scan wire's machine-layer programs ----------------------------------
    def _m_front(self, x):
        """Images (NCHW) -> (z's int32 symbols, the latent slices stacked
        (N, B, sc, h, w))."""
        y, z = self.model.machine_analyze(x)
        return self._machine.z_sym(z), torch.stack(self.model.coder.latent_slices(y))

    def _m_state(self, z_sym):
        return self._scan.conditioning(self.model.coder.ctx_prepare(self._machine.z_hat(z_sym)))

    def _m_assemble(self, y_hats):
        return (self.model.coder.ctx_assemble(list(y_hats)),)

    def _sync(self) -> None:
        """Before each scan-wire call: float32, and the stacked weights,
        programs and medians of the current weights."""
        from .device_codec import DeviceWireCodec

        DeviceWireCodec._check_f32()
        if self.graphs.refresh(weights_version(self.model)):
            self._scan.restack()
            self._machine.reset()
            self._human_medians = None

    def _run(self, name: str, fn, inputs):
        """A program through the graph cache, keyed by its input shapes."""
        return self.graphs.run((name,) + tuple(tuple(t.shape) for t in inputs), fn, inputs)

    # --- public API ------------------------------------------------------------
    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). -> {"strings":
        [machine_y, machine_z, human_y, human_z], "shape" (machine z's
        grid), "human_shape"}; with ``return_debug`` also the machine
        "y_hat" (NCHW) and the decoder's "x_hat" (NHWC, in [0, 1])."""
        x = nhwc_to_nchw(torch.as_tensor(x, dtype=torch.float32, device=self.device))
        if self.scan_wire:
            self._sync()
            z_sym, y_stack = self._run("m_front", self._m_front, [x])
            z_sym = _canonical(z_sym)
            means, scales = self._run("m_state", self._m_state, [z_sym])
            y_strings, y_hats = self._scan.encode(means, scales, y_stack)
            z_strings = self.kit.encode_z(z_sym, MACHINE_Z)
            (y_hat,) = self._run("m_assemble", self._m_assemble, [y_hats])
            y_hat = y_hat.clone()
        else:
            y, z = self.model.machine_analyze(x)
            z_sym = self._machine.z_sym(z)
            syms, idxs, decoded = self._machine.encode(y, z_sym)
            y_strings = self._encode_y(syms, idxs)
            z_strings = self._encode_z(z_sym, MACHINE_Z)
            y_hat = self.model.coder.ctx_assemble(decoded)

        human_y, hz_sym = self._run("h_front", self._human_front, [x, y_hat])
        hz_sym = _canonical(hz_sym)
        hz_strings = self._encode_z(hz_sym, HUMAN_Z)
        means, index = self._run("h_hyper", self._human_hyper, [hz_sym])
        hy_sym = _canonical(enc_round(human_y - means, self.narrow).to(torch.int32))
        hy_strings = self._encode_human_y(hy_sym, index)
        out: Dict[str, Any] = {
            "strings": [y_strings, z_strings, hy_strings, hz_strings],
            "shape": (z_sym.shape[2], z_sym.shape[3]),
            "human_shape": (hz_sym.shape[2], hz_sym.shape[3]),
        }
        if return_debug:
            (x_hat,) = self._run("h_decode", self._human_decode, [hy_sym, means, y_hat])
            out.update(y_hat=y_hat, x_hat=x_hat.clone())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, human_shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": the machine latent
        (B, M, h, w)}."""
        y_strings, z_strings, hy_strings, hz_strings = strings
        z_sym = _canonical(self._decode_z(z_strings, shape, MACHINE_Z))
        if self.scan_wire:
            self._sync()
            means, scales = self._run("m_state", self._m_state, [z_sym])
            y_hats = self._scan.decode(y_strings, means, scales)
            (y_hat,) = self._run("m_assemble", self._m_assemble, [y_hats])
            y_hat = y_hat.clone()
        else:
            ydec = self._y_decoder(y_strings)
            try:
                y_hat = self.model.coder.ctx_assemble(self._machine.decode(z_sym, ydec))
            finally:
                ydec.close()
        hz_sym = _canonical(self._decode_z(hz_strings, human_shape, HUMAN_Z))
        means, index = self._run("h_hyper", self._human_hyper, [hz_sym])
        hy_sym = _canonical(self._decode_human_y(hy_strings, index))
        (x_hat,) = self._run("h_decode", self._human_decode, [hy_sym, means, y_hat])
        return {"x_hat": x_hat.clone(), "y_hat": y_hat}

    # --- the wires' coders -----------------------------------------------------------
    def _encode_y(self, syms, idxs) -> List[bytes]:
        """The machine y, slice after slice along each image's stream."""
        if self.wire == "device":
            return self.kit.encode_y_slices(syms, idxs)
        sym_h = torch.cat(syms, 1).cpu().numpy()
        idx_h = torch.cat(idxs, 1).cpu().numpy()
        bounds = np.cumsum([0] + [s.shape[1] for s in syms])
        parts = list(zip(bounds[:-1], bounds[1:]))
        gt = self.tables.gaussian
        return coding.encode_batch(
            np.concatenate([_flat(sym_h[:, a:b], self.ref_layout) for a, b in parts], 1),
            np.concatenate([_flat(idx_h[:, a:b], self.ref_layout) for a, b in parts], 1),
            gt.quantized_cdf, gt.cdf_length, gt.offset)

    def _y_decoder(self, y_strings: List[bytes]):
        if self.wire == "device":
            return self.kit.y_stream_decoder(y_strings, self.model.coder.ctx_slices)
        return _HostYDecoder(y_strings, self.tables.gaussian, self.device, self.ref_layout)

    def _encode_human_y(self, sym, index) -> List[bytes]:
        if self.wire == "device":
            return self.kit.encode_gaussian(sym, index)
        gt = self.tables.gaussian
        return coding.encode_batch(_flat(sym.cpu().numpy(), self.ref_layout),
                                   _flat(index.cpu().numpy(), self.ref_layout),
                                   gt.quantized_cdf, gt.cdf_length, gt.offset)

    def _decode_human_y(self, strings: List[bytes], index) -> torch.Tensor:
        if self.wire == "device":
            return self.kit.decode_gaussian(strings, index)
        dec = _HostYDecoder(strings, self.tables.gaussian, self.device, self.ref_layout)
        try:
            return dec.decode_slice(index)
        finally:
            dec.close()

    def _encode_z(self, sym: torch.Tensor, key: str) -> List[bytes]:
        if self.wire == "device":
            return self.kit.encode_z(sym, key)
        B, C, h, w = sym.shape
        t = self.tables.bottlenecks[key]
        idx = np.broadcast_to(_eb_indexes((h, w), C, self.ref_layout), (B, h * w * C))
        return coding.encode_batch(_flat(sym.cpu().numpy(), self.ref_layout), idx,
                                   t.quantized_cdf, t.cdf_length, t.offset)

    def _decode_z(self, strings: List[bytes], shape_hw, key: str) -> torch.Tensor:
        """-> int32 symbols (B, C, zh, zw) on the codec's device."""
        h, w = shape_hw
        if self.wire == "device":
            return self.kit.decode_z(strings, h, w, key)
        t = self.tables.bottlenecks[key]
        C = t.num_distributions
        idx = np.broadcast_to(_eb_indexes((h, w), C, self.ref_layout),
                              (len(strings), h * w * C))
        dec = coding.BatchRansDecoder(strings)
        try:
            sym = dec.decode_stream(idx, t.quantized_cdf, t.cdf_length, t.offset,
                                    lut=t.symbol_lut())
        finally:
            dec.close()
        return torch.from_numpy(_unflat(sym, C, h, w, self.ref_layout)).to(self.device)
