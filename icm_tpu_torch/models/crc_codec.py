"""Real-bitstream compress/decompress for the CRC family (stf9, stf11,
stf12, stf14; stf13's three layers: :class:`CRC3Codec`), for seg_oj_ICM
(:class:`SegOjCodec`) and for czigzag (:class:`CzigzagCodec`).

Port of ``icm_tpu/models/crc_codec.py``'s ``CRCCodec``, ``CRC3Codec``,
``SegOjCodec``, ``CzigzagCodec`` and their ``_CharmLayerDriver`` (the
device and scan wires' layer functions too). The reference shipped no
coder for these models; the JAX package's design, kept here:

    strings = [machine_y, machine_z, human_y, human_z]
    stf13:    [machine_y, machine_z, seg_y, seg_z, human_y, human_z]
    seg_oj:   [y, z, seg_y, seg_z] (two zigzag layers, no human layer)

- each zigzag layer (the machine layer; stf13's segmentation layer after
  it, analysed from the images and the machine y_hat) is the zigzag ChARM
  coder, coded slice by slice as
  ``CharmCodec`` codes its slices (:class:`_CharmLayerDriver`: the
  context of slice i, then one step that reconstructs slice i, adds its
  LRP where the layer applies it (stf13) and computes slice i + 1's
  context, shared by both sides, so that the context is the same floats
  on both);
- the human layer is a one-shot conditional Gaussian: the scale indexes
  from its hyper-decoded scales, the means as quantization offsets. The
  decoder rebuilds the conditioning (stf13: its masks too) from the
  decoded latents, so only the residual layer's streams are sent.

Three wires, as in the JAX codec:

- ``wire="host"``: rANS on the host (``coding/``), one stream an image
  for each stream; symbols in NHWC order, or with ``ref_layout``
  channel-major as ``CharmCodec`` lays them out;
- ``wire="device"``: the lane rANS on the card (``device_codec.
  DeviceWireKit``): each zigzag layer's y one encode launch and one
  decode launch a slice, every z as bottleneck lanes, the human y as one
  Gaussian-coded tensor (``encode_gaussian`` / ``decode_gaussian``);
  decompress makes no host round trip;
- ``wire="device", scan_wire=True``: each zigzag layer's chain on a scan
  wire of its own (``scan_codec.ZigzagScanWire``). Its programs (encode front:
  analysis, z's symbols and the latent slices; conditioning; the chain,
  one program each way; assembly) and the human layer's three (encode
  front, hyper-decoders, synthesis) run through the codec's
  ``graphs.GraphCache``: captured as CUDA graphs on the card and
  replayed, launch by launch with ``cuda_graphs=False`` and on the CPU.
  It runs in float32 only, as the JAX scan wire does.

The zigzag layers' y_hat and the human x_hat of the host and device wires are
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

MACHINE_Z, SEG_Z, HUMAN_Z = ("entropy_bottleneck", "entropy_bottleneck_seg",
                             "entropy_bottleneck_human")
SEG_OJ_Z = "seg_entropy_bottleneck"  # seg_oj_ICM's: JAX's eb_dict key, not stf13's


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
        """Slice i's (mu, scale index, mean support)."""
        c = self.coder
        mu, scale, mean_support = c.slice_context(i, state, c.ctx_support(i, decoded))
        return mu, build_indexes(scale, self.scale_table), mean_support

    def step(self, i: int, state, decoded: List[torch.Tensor], sym: torch.Tensor, ctx):
        """Slice i's y_hat from its int32 symbols and ``ctx`` (its context),
        LRP added where the layer applies it, appended to ``decoded``; ->
        slice i + 1's context, or None after the last."""
        c = self.coder
        y_hat = c.reconstruct(_canonical(sym), ctx[0])
        if c.apply_lrp:
            y_hat = y_hat + c.slice_lrp(i, ctx[2], y_hat)
        decoded.append(y_hat)
        if i + 1 >= c.ctx_slices:
            return None
        return self.context(i + 1, state, decoded)

    def encode(self, y: torch.Tensor, z_sym: torch.Tensor, *cond):
        """The encoder's chain: -> (per slice int32 symbols and scale
        indexes, the y_hat slices). ``cond``: what the coder's
        ``ctx_prepare`` takes beside z_hat (czigzag's hyper contexts)."""
        c = self.coder
        state = c.ctx_prepare(self.z_hat(z_sym), *cond)
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

    def decode(self, z_sym: torch.Tensor, ydec, *cond) -> List[torch.Tensor]:
        """The decoder's chain; ``ydec.decode_slice(index)`` gives each
        slice's symbols. -> the y_hat slices."""
        c = self.coder
        state = c.ctx_prepare(self.z_hat(z_sym), *cond)
        decoded: List[torch.Tensor] = []
        ctx = self.context(0, state, decoded)
        for i in range(c.ctx_slices):
            ctx = self.step(i, state, decoded, ydec.decode_slice(ctx[1]), ctx)
        return decoded


class _Layer:
    """One zigzag ChARM layer of a codec: its stage driver, its bottleneck's
    table key, its analysis (``analyze(x, *latents)``: the images and the
    latents of the layers before it -> its latent y) and, on the scan
    wire, its ``ZigzagScanWire``; ``name`` prefixes its programs' keys in
    the codec's graph cache."""

    def __init__(self, name: str, driver: _CharmLayerDriver, z_key: str, analyze):
        self.name = name
        self.driver = driver
        self.z_key = z_key
        self.analyze = analyze
        self.scan = None

    @property
    def coder(self):
        return self.driver.coder

    # --- the scan wire's programs of this layer --------------------------------
    def front(self, x, *latents):
        """Images (NCHW) and earlier latents -> (z's int32 symbols, the
        latent slices stacked (N, B, sc, h, w))."""
        y = self.analyze(x, *latents)
        return self.driver.z_sym(self.coder.h_a(y)), torch.stack(self.coder.latent_slices(y))

    def state(self, z_sym):
        return self.scan.conditioning(self.coder.ctx_prepare(self.driver.z_hat(z_sym)))

    def assemble(self, y_hats):
        return (self.coder.ctx_assemble(list(y_hats)),)


class _WireCodec:
    """What the codecs of this module share: the wires' arguments, the
    coder tables, the graph cache, and each wire's coding of a zigzag
    layer's y (slice after slice) and of a bottleneck's z."""

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
        self.graphs = GraphCache(enabled=cuda_graphs and scan_wire)
        if wire == "device":
            from .device_codec import DeviceWireKit

            self.kit = DeviceWireKit(tables, device=self.device)
        if scan_wire:
            from .device_codec import DeviceWireCodec

            DeviceWireCodec._check_f32()

    def _sync(self) -> None:
        """Before each scan-wire call: float32, and the stacked weights,
        programs and medians of the current weights (:meth:`_reset`)."""
        from .device_codec import DeviceWireCodec

        DeviceWireCodec._check_f32()
        if self.graphs.refresh(weights_version(self.model)):
            self._reset()

    def _run(self, name: str, fn, inputs):
        """A program through the graph cache, keyed by its input shapes."""
        return self.graphs.run((name,) + tuple(tuple(t.shape) for t in inputs), fn, inputs)

    # --- the wires' coders -----------------------------------------------------------
    def _encode_y(self, syms, idxs) -> List[bytes]:
        """A zigzag layer's y, slice after slice along each image's stream."""
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

    def _y_decoder(self, y_strings: List[bytes], n_slices: int):
        if self.wire == "device":
            return self.kit.y_stream_decoder(y_strings, n_slices)
        return _HostYDecoder(y_strings, self.tables.gaussian, self.device, self.ref_layout)

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


class _LayersCodec(_WireCodec):
    """A codec of zigzag layers (``LAYERS``: per layer its name in the graph
    cache, its bottleneck's table key, the model's analysis of its latent
    and its coder), each coded slice by slice on the host and device wires
    (a ``_CharmLayerDriver`` each) or by a ``ZigzagScanWire`` of its own."""

    LAYERS: tuple = ()

    def __init__(self, model, tables: Optional[CodecTables] = None, narrow: float = 1.0,
                 wire: str = "host", scan_wire: bool = False, cuda_graphs: bool = True,
                 ref_layout: bool = False):
        super().__init__(model, tables, narrow, wire, scan_wire, cuda_graphs, ref_layout)
        self._layers = [
            _Layer(name, _CharmLayerDriver(coder(model), self._scale_table, narrow), z_key,
                   analyze(model))
            for name, z_key, analyze, coder in self.LAYERS]
        if scan_wire:
            from .scan_codec import ZigzagScanWire

            for layer in self._layers:
                layer.scan = ZigzagScanWire(layer.coder, self.kit, self._scale_table,
                                            self.graphs, layer.name, narrow=narrow)

    def _reset(self) -> None:
        for layer in self._layers:
            layer.scan.restack()
            layer.driver.reset()

    # --- one zigzag layer, each side ---------------------------------------------
    def _encode_layer(self, layer: _Layer, x, latents):
        """-> (y strings, z strings, y_hat, z's symbols) of ``layer`` from the
        images and the latents of the layers before it."""
        n = layer.name
        if self.scan_wire:
            z_sym, y_stack = self._run(f"{n}_front", layer.front, [x, *latents])
            z_sym = _canonical(z_sym)
            means, scales = self._run(f"{n}_state", layer.state, [z_sym])
            y_strings, y_hats = layer.scan.encode(means, scales, y_stack)
            z_strings = self.kit.encode_z(z_sym, layer.z_key)
            (y_hat,) = self._run(f"{n}_assemble", layer.assemble, [y_hats])
            return y_strings, z_strings, y_hat.clone(), z_sym
        syms, idxs, decoded, z_sym = self._chain(layer, x, latents)
        return (self._encode_y(syms, idxs), self._encode_z(z_sym, layer.z_key),
                layer.coder.ctx_assemble(decoded), z_sym)

    @staticmethod
    def _chain(layer: _Layer, x, latents):
        """The host and device wires' encoder chain of ``layer``: -> (its y
        symbols and scale indexes slice by slice, its y_hat slices, z's
        symbols)."""
        y = layer.analyze(x, *latents)
        z_sym = layer.driver.z_sym(layer.coder.h_a(y))
        return (*layer.driver.encode(y, z_sym), z_sym)

    def _decode_layer(self, layer: _Layer, y_strings, z_strings, shape):
        """-> ``layer``'s y_hat from its streams and z's grid ``shape``."""
        n = layer.name
        z_sym = _canonical(self._decode_z(z_strings, shape, layer.z_key))
        if self.scan_wire:
            means, scales = self._run(f"{n}_state", layer.state, [z_sym])
            y_hats = layer.scan.decode(y_strings, means, scales)
            (y_hat,) = self._run(f"{n}_assemble", layer.assemble, [y_hats])
            return y_hat.clone()
        ydec = self._y_decoder(y_strings, layer.coder.ctx_slices)
        try:
            return layer.coder.ctx_assemble(layer.driver.decode(z_sym, ydec))
        finally:
            ydec.close()


class CRCCodec(_LayersCodec):
    """compress()/decompress() for ``crc.ConditionalResidualCoding`` (stf9,
    stf11), ``crc.ConditionalResidualCoding2`` (stf12) and
    ``crc.ResidualCoding`` (stf14).

    ``tables``: coder tables in place of the model's own
    (``build_codec_tables`` over its bottlenecks); ``narrow``: see
    ``codec.enc_round``; ``wire``, ``scan_wire``, ``cuda_graphs``: the
    module docstring (the device wire codes a Gaussian-coded tensor on up
    to 1024 lanes an image, the JAX codec's default); ``ref_layout``: the
    host wire's channel-major symbol order (``CharmCodec``'s)."""

    # per zigzag layer: (its name in the graph cache, its bottleneck's table
    # key, the model's analysis of its latent, its coder); the shape keys of
    # compress and the latent keys of the debug output and decompress, in
    # its order; the keys of compress's output that decompress takes after
    # the strings, in its order
    LAYERS = (("m", MACHINE_Z, lambda m: m.machine.g_a, lambda m: m.coder),)
    SHAPE_KEYS = ("shape",)
    LATENT_KEYS = ("y_hat",)
    DECOMPRESS_KEYS = SHAPE_KEYS + ("human_shape",)
    STREAMS = ("machine_y", "machine_z", "human_y", "human_z")  # compress's "strings"

    def __init__(self, model, tables: Optional[CodecTables] = None, narrow: float = 1.0,
                 wire: str = "host", scan_wire: bool = False, cuda_graphs: bool = True,
                 ref_layout: bool = False):
        super().__init__(model, tables, narrow, wire, scan_wire, cuda_graphs, ref_layout)
        self._human_medians = None

    # --- the human layer's stages, shared by both sides ------------------------
    def _human_offset(self) -> torch.Tensor:
        if self._human_medians is None:
            self._human_medians = self.model.human_eb_medians().detach().reshape(1, -1, 1, 1)
        return self._human_medians

    def _human_front(self, x, *latents):
        """-> (human_y, its hyper-latent's int32 symbols)."""
        human_y, hz = self.model.human_encode(x, *latents)
        return human_y, enc_round(hz - self._human_offset(), self.narrow).to(torch.int32)

    def _human_hyper(self, hz_sym):
        """The hyper-latent's symbols -> (means, scale indexes) of the human
        latent."""
        z_hat = hz_sym.to(torch.float32) + self._human_offset()
        hyper = self.model.human_hyper
        scales = hyper.h_scale_s(z_hat)
        return hyper.h_mean_s(z_hat), build_indexes(scales, self._scale_table)

    def _human_decode(self, hy_sym, means, *latents):
        """-> x_hat (B, H, W, 3) in [0, 1]."""
        x_hat = self.model.human_synthesize(hy_sym.to(torch.float32) + means, *latents)
        return (torch.clamp(x_hat, 0.0, 1.0).permute(0, 2, 3, 1).contiguous(),)

    def _reset(self) -> None:
        super()._reset()
        self._human_medians = None

    # --- public API ------------------------------------------------------------
    @torch.no_grad()
    def symbols(self, x) -> Dict[str, List[torch.Tensor]]:
        """x as :meth:`compress` takes it. -> each zigzag layer's y symbols
        as the host and device wires code them (int32, slice by slice), by
        the layer's latent key (``LATENT_KEYS``)."""
        x = nhwc_to_nchw(torch.as_tensor(x, dtype=torch.float32, device=self.device))
        out, latents = {}, []
        for key, layer in zip(self.LATENT_KEYS, self._layers):
            syms, _, decoded, _ = self._chain(layer, x, latents)
            out[key] = syms
            latents.append(layer.coder.ctx_assemble(decoded))
        return out

    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). -> {"strings": [y, z]
        of each zigzag layer, then [human_y, human_z]; the z grid of each
        (``SHAPE_KEYS``: "shape", stf13's "seg_shape") and "human_shape"};
        with ``return_debug`` also each layer's y_hat (NCHW; ``LATENT_KEYS``)
        and the decoder's "x_hat" (NHWC, in [0, 1])."""
        x = nhwc_to_nchw(torch.as_tensor(x, dtype=torch.float32, device=self.device))
        if self.scan_wire:
            self._sync()
        strings, shapes, latents = [], [], []
        for layer in self._layers:
            y_strings, z_strings, y_hat, z_sym = self._encode_layer(layer, x, latents)
            strings += [y_strings, z_strings]
            shapes.append((z_sym.shape[2], z_sym.shape[3]))
            latents.append(y_hat)

        human_y, hz_sym = self._run("h_front", self._human_front, [x, *latents])
        hz_sym = _canonical(hz_sym)
        hz_strings = self._encode_z(hz_sym, HUMAN_Z)
        means, index = self._run("h_hyper", self._human_hyper, [hz_sym])
        hy_sym = _canonical(enc_round(human_y - means, self.narrow).to(torch.int32))
        hy_strings = self._encode_human_y(hy_sym, index)
        out: Dict[str, Any] = {"strings": strings + [hy_strings, hz_strings],
                               **dict(zip(self.SHAPE_KEYS, shapes)),
                               "human_shape": (hz_sym.shape[2], hz_sym.shape[3])}
        if return_debug:
            (x_hat,) = self._run("h_decode", self._human_decode, [hy_sym, means, *latents])
            out.update(zip(self.LATENT_KEYS, latents))
            out["x_hat"] = x_hat.clone()
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, human_shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": the machine latent
        (B, M, h, w)}."""
        return self._decompress(strings, (shape,), human_shape)

    def _decompress(self, strings, shapes, human_shape) -> Dict[str, Any]:
        if self.scan_wire:
            self._sync()
        latents = [self._decode_layer(layer, strings[2 * k], strings[2 * k + 1], shapes[k])
                   for k, layer in enumerate(self._layers)]
        hy_strings, hz_strings = strings[-2:]
        hz_sym = _canonical(self._decode_z(hz_strings, human_shape, HUMAN_Z))
        means, index = self._run("h_hyper", self._human_hyper, [hz_sym])
        hy_sym = _canonical(self._decode_human_y(hy_strings, index))
        (x_hat,) = self._run("h_decode", self._human_decode, [hy_sym, means, *latents])
        return {"x_hat": x_hat.clone(), **dict(zip(self.LATENT_KEYS, latents))}

    # --- the human layer's coders ------------------------------------------------------
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


class CRC3Codec(CRCCodec):
    """compress()/decompress() for ``crc.ConditionalResidualCoding3``
    (stf13): six streams, ``[y, z, seg_y, seg_z, human_y, human_z]``. The
    machine and segmentation layers are zigzag layers, each coded as
    :class:`CRCCodec` codes its machine layer (a ``_CharmLayerDriver``
    each, with LRP; on the scan wire a ``ZigzagScanWire`` each, their
    programs keyed by layer in the one graph cache); the segmentation
    layer's latent is analysed from the images and the machine y_hat. The
    human layer is :class:`CRCCodec`'s, its stages conditioned on both
    decoded latents (the decoder rebuilds the masks and conditioning
    signals from them, so the human layer needs no side information).
    Port of the JAX package's ``CRC3Codec``; arguments as
    :class:`CRCCodec`'s. compress adds "seg_shape" (and with
    ``return_debug`` "seg_y_hat"); :meth:`decompress` takes it."""

    LAYERS = CRCCodec.LAYERS + (("s", SEG_Z, lambda m: m.seg_encode, lambda m: m.seg_coder),)
    SHAPE_KEYS = ("shape", "seg_shape")
    LATENT_KEYS = ("y_hat", "seg_y_hat")
    DECOMPRESS_KEYS = SHAPE_KEYS + ("human_shape",)
    STREAMS = ("machine_y", "machine_z", "seg_y", "seg_z", "human_y", "human_z")

    @torch.no_grad()
    def decompress(self, strings, shape, seg_shape, human_shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat" and "seg_y_hat": the
        machine and segmentation latents (B, M, h, w)}."""
        return self._decompress(strings, (shape, seg_shape), human_shape)


class SegOjCodec(_LayersCodec):
    """compress()/decompress() for ``icm.MaskedRCNN_FasterRCNN_Coding``
    (seg_oj_ICM), port of the JAX package's ``SegOjCodec``: four streams,
    ``[y, z, seg_y, seg_z]``. The machine layer (``g_a``, ``coder``) and the
    segmentation layer (``seg_g_a`` of ``cat(x_hat, x)``, ``seg_coder``) are
    zigzag layers, each coded as :class:`CRCCodec` codes its machine layer
    (with LRP; on the scan wire a ``ZigzagScanWire`` each, their programs
    keyed by layer in the one graph cache). Between them the machine layer's
    reconstruction ``x_hat = g_s(y_hat)``: the encoder analyses the
    segmentation latent from it, and the decoder decodes both layers and adds
    it to ``seg_g_s(seg_y_hat)``; the images reach the encoder only. Arguments
    as :class:`CRCCodec`'s. compress gives "shape" and "seg_shape" (and with
    ``return_debug`` "y_hat", "seg_y_hat" and the decoder's "x_hat");
    :meth:`decompress` takes them.

    Both sides give x_hat in [0, 1]; JAX's debug compress leaves its x_hat
    unclipped where its decompress clips it."""

    LAYERS = (("m", MACHINE_Z, lambda m: m.g_a, lambda m: m.coder),
              ("s", SEG_OJ_Z, lambda m: m.seg_analyze, lambda m: m.seg_coder))
    SHAPE_KEYS = ("shape", "seg_shape")
    LATENT_KEYS = ("y_hat", "seg_y_hat")
    DECOMPRESS_KEYS = SHAPE_KEYS
    STREAMS = ("y", "z", "seg_y", "seg_z")

    def _machine_x_hat(self, y_hat):
        return (self.model.machine_synthesize(y_hat),)

    def _seg_decode(self, seg_y_hat, x_hat):
        """-> x_hat (B, H, W, 3) in [0, 1] from the segmentation latent and
        the machine layer's reconstruction."""
        x_hat = self.model.seg_synthesize(seg_y_hat, x_hat)
        return (torch.clamp(x_hat, 0.0, 1.0).permute(0, 2, 3, 1).contiguous(),)

    @torch.no_grad()
    def symbols(self, x) -> Dict[str, List[torch.Tensor]]:
        """x as :meth:`compress` takes it. -> each zigzag layer's y symbols
        as the host and device wires code them (int32, slice by slice),
        under "y_hat" and "seg_y_hat"."""
        x = nhwc_to_nchw(torch.as_tensor(x, dtype=torch.float32, device=self.device))
        machine, seg = self._layers
        syms, _, decoded, _ = self._chain(machine, x, [])
        (x_hat,) = self._machine_x_hat(machine.coder.ctx_assemble(decoded))
        return {"y_hat": syms, "seg_y_hat": self._chain(seg, x, [x_hat])[0]}

    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). -> {"strings": [y, z,
        seg_y, seg_z], "shape", "seg_shape": the z grids}; with
        ``return_debug`` also "y_hat", "seg_y_hat" (NCHW) and the decoder's
        "x_hat" (NHWC, in [0, 1])."""
        x = nhwc_to_nchw(torch.as_tensor(x, dtype=torch.float32, device=self.device))
        if self.scan_wire:
            self._sync()
        machine, seg = self._layers
        y_strings, z_strings, y_hat, z_sym = self._encode_layer(machine, x, [])
        (x_hat,) = self._run("m_synth", self._machine_x_hat, [y_hat])
        sy_strings, sz_strings, seg_y_hat, sz_sym = self._encode_layer(seg, x, [x_hat])
        out: Dict[str, Any] = {"strings": [y_strings, z_strings, sy_strings, sz_strings],
                               "shape": (z_sym.shape[2], z_sym.shape[3]),
                               "seg_shape": (sz_sym.shape[2], sz_sym.shape[3])}
        if return_debug:
            (dec,) = self._run("s_decode", self._seg_decode, [seg_y_hat, x_hat])
            out.update(y_hat=y_hat, seg_y_hat=seg_y_hat, x_hat=dec.clone())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, seg_shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat" and "seg_y_hat": the
        machine and segmentation latents (B, M, h, w)}."""
        if self.scan_wire:
            self._sync()
        machine, seg = self._layers
        y_hat = self._decode_layer(machine, strings[0], strings[1], shape)
        (x_hat,) = self._run("m_synth", self._machine_x_hat, [y_hat])
        seg_y_hat = self._decode_layer(seg, strings[2], strings[3], seg_shape)
        (dec,) = self._run("s_decode", self._seg_decode, [seg_y_hat, x_hat])
        return {"x_hat": dec.clone(), "y_hat": y_hat, "seg_y_hat": seg_y_hat}


class CzigzagCodec(_WireCodec):
    """compress()/decompress() for ``czigzag.conditionalZigzag``, port of the
    JAX package's ``CzigzagCodec``. ``up_x4`` conditions both sides: each
    derives the context pyramids from it (``ctx_pyramids``), so it is an
    argument of :meth:`compress` and of :meth:`decompress` and not a stream.
    ``strings = [y, z]``; y's 16 zigzag slices are coded as a CRC zigzag
    layer's (``_CharmLayerDriver``: slice i's context over its mean, scale
    and hyper-context windows and sliding support, then one step that
    reconstructs it, adds its LRP and computes slice i + 1's context, both
    sides alike), z as the bottleneck's.

    Arguments as :class:`CRCCodec`'s but ``ref_layout`` (the reference
    ships no coder for this model). On the scan wire (``scan_codec.
    CzigzagScanWire``) the programs, the pyramids, the encode front
    (analysis, z's symbols, the latent slices), the conditioning, the chain
    each way and the assembly with the synthesis, run through the codec's
    ``GraphCache``; in float32 only (JAX's scan wire fails under its
    bfloat16 policy)."""

    STREAMS = ("y", "z")
    LATENT_KEYS = ("y_hat",)
    DECOMPRESS_KEYS = ("shape",)  # decompress's arguments after the strings, before up_x4
    Z_KEY = "entropy_bottleneck"

    def __init__(self, model, tables: Optional[CodecTables] = None, narrow: float = 1.0,
                 wire: str = "host", scan_wire: bool = False, cuda_graphs: bool = True):
        super().__init__(model, tables, narrow, wire, scan_wire, cuda_graphs)
        self.driver = _CharmLayerDriver(model, self._scale_table, narrow)
        if scan_wire:
            from .scan_codec import CzigzagScanWire

            self.scan = CzigzagScanWire(model, self.kit, self._scale_table, self.graphs,
                                        narrow=narrow)

    def _reset(self) -> None:
        self.scan.restack()
        self.driver.reset()

    # --- the programs, shared by both sides ------------------------------------------
    def _pyramids(self, up):
        """-> the analysis contexts, hyper_ctx, hyper_ctx2 and the decoder's
        contexts, flat (:meth:`_unflat`)."""
        ctx_list, hctx, hctx2, dec = self.model.ctx_pyramids(up)
        return (*ctx_list, hctx, hctx2, *dec)

    def _unflat(self, pyr):
        n = self.model.n_stages
        return list(pyr[:n]), pyr[n], pyr[n + 1], list(pyr[n + 2:])

    def _front(self, x, *ctx):
        """Encode front: -> (z's int32 symbols, the latent slices stacked
        (N, B, sc, h, w)); ``ctx``: the analysis contexts, hyper_ctx and
        hyper_ctx2."""
        m = self.model
        y = m.analyze_cond(x, ctx[:-2])
        return (self.driver.z_sym(m.hyper_encode(y, *ctx[-2:])),
                torch.stack(m.latent_slices(y)))

    def _state(self, z_sym, hctx, hctx2):
        return self.scan.conditioning(self.model.ctx_prepare_cond(
            self.driver.z_hat(z_sym), hctx, hctx2))

    def _decode(self, y_hats, *dec):
        """The y_hat slices (a list, or stacked) -> (y_hat, x_hat (B, H, W,
        3) in [0, 1])."""
        y_hat = self.model.ctx_assemble(list(y_hats))
        x_hat = self.model.synthesize_cond(y_hat, list(dec))
        return y_hat, torch.clamp(x_hat, 0.0, 1.0).permute(0, 2, 3, 1).contiguous()

    def _inputs(self, *images):
        return [nhwc_to_nchw(torch.as_tensor(a, dtype=torch.float32, device=self.device))
                for a in images]

    # --- public API --------------------------------------------------------------
    @torch.no_grad()
    def symbols(self, x, up_x4) -> Dict[str, List[torch.Tensor]]:
        """-> {"y_hat": the y symbols as the host and device wires code
        them, int32, slice by slice}."""
        x, up = self._inputs(x, up_x4)
        ctx_list, hctx, hctx2, _ = self._unflat(self._pyramids(up))
        y = self.model.analyze_cond(x, ctx_list)
        z_sym = self.driver.z_sym(self.model.hyper_encode(y, hctx, hctx2))
        return {"y_hat": self.driver.encode(y, z_sym, hctx, hctx2)[0]}

    @torch.no_grad()
    def compress(self, x, up_x4, return_debug: bool = False) -> Dict[str, Any]:
        """x, up_x4: (B, H, W, 3) in [0, 1] (tensors or numpy). -> {"strings":
        [y, z], "shape": z's grid}; with ``return_debug`` also "y_hat" (NCHW)
        and the decoder's "x_hat" (NHWC, in [0, 1])."""
        x, up = self._inputs(x, up_x4)
        if x.shape != up.shape:
            raise ValueError(f"x {tuple(x.shape)} and up_x4 {tuple(up.shape)} differ")
        if self.scan_wire:
            self._sync()
        pyr = self._run("pyramids", self._pyramids, [up])
        ctx_list, hctx, hctx2, dec = self._unflat(pyr)
        if self.scan_wire:
            z_sym, y_stack = self._run("front", self._front, [x, *ctx_list, hctx, hctx2])
            z_sym = _canonical(z_sym)
            conds = self._run("state", self._state, [z_sym, hctx, hctx2])
            y_strings, decoded = self.scan.encode(*conds, y_stack)
        else:
            y = self.model.analyze_cond(x, ctx_list)
            z_sym = self.driver.z_sym(self.model.hyper_encode(y, hctx, hctx2))
            syms, idxs, decoded = self.driver.encode(y, z_sym, hctx, hctx2)
            y_strings = self._encode_y(syms, idxs)
        out: Dict[str, Any] = {"strings": [y_strings, self._encode_z(z_sym, self.Z_KEY)],
                               "shape": (z_sym.shape[2], z_sym.shape[3])}
        if return_debug:
            y_hat, x_hat = self._run("assemble", self._decode, [decoded, *dec]) \
                if self.scan_wire else self._decode(decoded, *dec)
            out.update(y_hat=y_hat.clone(), x_hat=x_hat.clone())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape, up_x4) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": (B, M, h, w)}."""
        (up,) = self._inputs(up_x4)
        y_strings, z_strings = strings
        if not len(y_strings) == len(z_strings) == up.shape[0]:
            raise ValueError(f"{len(y_strings)} and {len(z_strings)} wires for "
                             f"{up.shape[0]} images of up_x4")
        if self.scan_wire:
            self._sync()
        _, hctx, hctx2, dec = self._unflat(self._run("pyramids", self._pyramids, [up]))
        z_sym = _canonical(self._decode_z(z_strings, shape, self.Z_KEY))
        if self.scan_wire:
            conds = self._run("state", self._state, [z_sym, hctx, hctx2])
            y_hats = self.scan.decode(y_strings, *conds)
            y_hat, x_hat = self._run("assemble", self._decode, [y_hats, *dec])
        else:
            ydec = self._y_decoder(y_strings, self.model.ctx_slices)
            try:
                decoded = self.driver.decode(z_sym, ydec, hctx, hctx2)
            finally:
                ydec.close()
            y_hat, x_hat = self._decode(decoded, *dec)
        return {"x_hat": x_hat.clone(), "y_hat": y_hat.clone()}
