"""Real-bitstream compress/decompress for ChARM-protocol codecs.

Port of ``icm_tpu/models/codec.py::CharmCodec`` on the host wire, for one
group: z is coded by the factorized bottleneck with per-channel CDFs and
the medians as quantization offsets; y slice by slice by the conditional
Gaussian with scale-table CDFs, its context computed from the slices
already reconstructed, LRP applied the same way on both sides; one rANS
stream per image. Symbols are flattened in NHWC order, as the JAX codec's
default does; ``ref_layout=True`` takes the reference coder's order
instead (each slice and z flattened channel-major, z's bottleneck indexes
channel-major), so that with the tables a reference checkpoint stores
(``zoo.import_reference_tables``, passed as ``tables``) a one-image stream
is byte-identical to the reference coder's. The port holds NCHW tensors,
so the reference order is the one that flattens as it stands.

The autoregressive context must be bit-identical between encoder and
decoder, or the decoder reads the stream with the wrong CDFs. Both sides
run the same functions (:meth:`CharmCodec._context` and
:meth:`CharmCodec._reconstruct`) at the same shapes, and on the card the
codec fixes the numerics those functions depend on
(:func:`cuda_numerics`): no TF32 in convolutions or products (it would
also stray from the float32 reference), no reduced-precision sums in
bfloat16 products, deterministic cuDNN algorithms and no autotuning (a
different algorithm can round differently); the window-attention kernel
uses no atomics.

Under the bfloat16 activation policy (``nn.set_activation_dtype``) the
transforms and context stacks run in bfloat16 and the likelihoods and
indexes in float32, as in the JAX codec; y_hat takes mu's dtype
(``sym + mu``, ``icm_tpu/models/codec.py:238``). The wire does not
record the policy, as the JAX codec's does not: encoder and decoder must
run under the same one.

The float side of both directions (:meth:`CharmCodec._encode_symbols`
and the decoder's slice loop in :meth:`CharmCodec.decompress`) is shared
with the device wire (``device_codec.py``), which supplies only its own
coder.

Left out on purpose: the JAX codec's 2-bit/6-bit device-to-host packing,
its threaded batch groups (``pipelining.run_groups``) and its data
sharding. They worked around a remote TPU link; the card needs none.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import coding
from ..entropy import (
    EntropyTables,
    build_indexes,
    eb_tables_from_pmf_data,
    gc_build_tables,
    get_scale_table,
)
from .base import CodecTables, nhwc_to_nchw


def cuda_numerics() -> None:
    """Full-f32, deterministic numerics for cuDNN and cuBLAS (see the
    module docstring): bfloat16 products summed in float32, as XLA's
    ``preferred_element_type`` does. These are process-wide PyTorch
    switches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def enc_round(diff: torch.Tensor, narrow: float = 1.0) -> torch.Tensor:
    """Encoder-side symbol rounding. ``narrow < 1`` scales residuals before
    rounding so untrained weights give symbols concentrated in {-1, 0, 1}
    like a trained model's, instead of escape-heavy streams. The round
    trip stays exact, since both sides rebuild ``y_hat = sym + mu`` from
    the coded symbols; only the rate and distortion measured change.
    As JAX's ``diff * jnp.float32(narrow)``, a bfloat16 residual is scaled
    (and rounded) in float32."""
    if narrow != 1.0:
        diff = diff.to(torch.promote_types(diff.dtype, torch.float32)) * narrow
    return torch.round(diff)


def build_codec_tables(model) -> CodecTables:
    """Gaussian scale-table CDFs and every bottleneck's CDFs."""
    scale_table = get_scale_table()
    gaussian = gc_build_tables(scale_table)
    bottlenecks = {
        name: eb_tables_from_pmf_data(*eb.pmf_data())
        for name, eb in model.eb_dict().items()
    }
    return CodecTables(gaussian=gaussian, scale_table=scale_table,
                       bottlenecks=bottlenecks)


def _canonical(t: torch.Tensor) -> torch.Tensor:
    """A copy with the standard contiguous strides. The symbols enter the
    shared stages from the encoder's rounding on one side and from host
    arrays on the other; where a dimension has size 1 (z at 64 px, a
    1-image batch) the two can carry different strides, which PyTorch
    reads as different memory formats and answers with different
    convolution kernels, so the context would stop being bit-identical."""
    return t.clone(memory_format=torch.contiguous_format)


def _eb_indexes(shape_hw: tuple, C: int, ref_layout: bool) -> np.ndarray:
    """Channel-index map for a flattened (C, h, w) tensor, in the symbol
    order of :func:`_flat`."""
    h, w = shape_hw
    if ref_layout:
        return np.repeat(np.arange(C, dtype=np.int32), h * w)
    return np.tile(np.arange(C, dtype=np.int32), h * w)


def _flat(a: np.ndarray, ref_layout: bool) -> np.ndarray:
    """(B, c, h, w) host array -> (B, c*h*w) in NHWC order, or in NCHW
    order with ``ref_layout``."""
    a = np.asarray(a)
    if not ref_layout:
        a = np.transpose(a, (0, 2, 3, 1))
    return np.ascontiguousarray(a.reshape(a.shape[0], -1))


def _unflat(a: np.ndarray, c: int, h: int, w: int, ref_layout: bool) -> np.ndarray:
    """(B, c*h*w) symbols in the order of :func:`_flat` -> (B, c, h, w)."""
    if ref_layout:
        return np.ascontiguousarray(a.reshape(a.shape[0], c, h, w))
    return np.ascontiguousarray(
        np.transpose(a.reshape(a.shape[0], h, w, c), (0, 3, 1, 2))
    )


class CharmCodec:
    """compress()/decompress() over the ChARM protocol
    (see ``base.CompressionModel``) on the host wire.

    The float side of both directions is written once here; a wire
    supplies ``_encode_strings`` (symbols and indexes -> strings),
    ``_decode_z`` (z strings -> symbols) and ``_y_decoder`` (an object
    whose ``decode_slice(index)`` gives a slice's symbols, continuing the
    streams). ``device_codec.DeviceWireCodec`` is the other wire."""

    def __init__(self, model, tables: Optional[CodecTables] = None, ref_layout: bool = False,
                 narrow: float = 1.0):
        """``tables``: coder tables to use in place of the model's own
        (``build_codec_tables``), e.g. a reference checkpoint's;
        ``ref_layout``: the reference coder's symbol order (module
        docstring)."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            cuda_numerics()
        self.narrow = narrow
        self.ref_layout = ref_layout
        if tables is None:
            with torch.no_grad():
                tables = build_codec_tables(model)
        self.tables = tables
        self._scale_table = torch.from_numpy(self.tables.scale_table).to(self.device)
        self._medians = None

    # --- stages shared by the encoder and the decoder ------------------------
    def _z_offset(self) -> torch.Tensor:
        if self._medians is None:
            self._medians = self.model.eb_medians().detach().reshape(1, -1, 1, 1)
        return self._medians

    def _context(self, i: int, state, decoded: List[torch.Tensor]):
        """Slice i's (mu, scale index, mean support) from decoded slices."""
        mdl = self.model
        mu, scale, mean_support = mdl.slice_context(
            i, state, mdl.ctx_support(i, decoded)
        )
        return mu, build_indexes(scale, self._scale_table), mean_support

    def _reconstruct(self, i: int, sym: torch.Tensor, mu, mean_support):
        """y_hat of slice i from its integer symbols: sym + mu + LRP."""
        y_hat = sym.to(mu.dtype) + mu
        return y_hat + self.model.slice_lrp(i, mean_support, y_hat)

    def _finish(self, y_hat_slices):
        y_hat = self.model.ctx_assemble(y_hat_slices)
        return y_hat, torch.clamp(self.model.synthesize(y_hat), 0.0, 1.0)

    def _z_hat(self, z_sym: torch.Tensor) -> torch.Tensor:
        """z_hat from z's int32 symbols (standard strides)."""
        return z_sym.to(torch.float32) + self._z_offset()

    def _encode_symbols(self, x) -> Dict[str, Any]:
        """The encoder's float side, which every wire shares: analysis, z's
        symbols and the decoder's z_hat, then slice by slice the context,
        the int32 symbols and the reconstruction. -> {"z_sym", "z_hat",
        "syms", "idxs" (int32 scale indexes), "decoded" (y_hat slices),
        "shape" (zh, zw)}, NCHW tensors on the codec's device."""
        mdl = self.model
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y, z = mdl.analyze(nhwc_to_nchw(x))
        z_sym = _canonical(enc_round(z - self._z_offset(), self.narrow).to(torch.int32))
        z_hat = self._z_hat(z_sym)  # the decoder's z_hat
        state = mdl.ctx_prepare(z_hat)
        y_slices = mdl.latent_slices(y)
        decoded: List[torch.Tensor] = []
        syms, idxs = [], []
        for i in range(mdl.ctx_slices):
            mu, index, mean_support = self._context(i, state, decoded)
            sym = _canonical(enc_round(y_slices[i] - mu, self.narrow).to(torch.int32))
            syms.append(sym)
            idxs.append(index)
            decoded.append(self._reconstruct(i, sym, mu, mean_support))
        return dict(z_sym=z_sym, z_hat=z_hat, syms=syms, idxs=idxs, decoded=decoded,
                    shape=(z.shape[2], z.shape[3]))

    # --- public API ------------------------------------------------------------
    @torch.no_grad()
    def compress(self, x, return_debug: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1] (tensor or numpy). Returns
        {"strings": [y_strings, z_strings], "shape": (zh, zw)}; with
        ``return_debug`` also the encoder's "y_hat", "z_hat" (NCHW) and
        "x_hat" (NHWC)."""
        enc = self._encode_symbols(x)
        out: Dict[str, Any] = {"strings": self._encode_strings(enc), "shape": enc["shape"]}
        if return_debug:
            y_hat, x_hat = self._finish(enc["decoded"])
            out.update(y_hat=y_hat, z_hat=enc["z_hat"],
                       x_hat=x_hat.permute(0, 2, 3, 1).contiguous())
        return out

    @torch.no_grad()
    def decompress(self, strings, shape) -> Dict[str, Any]:
        """-> {"x_hat": (B, H, W, 3) in [0, 1], "y_hat": (B, M, h, w)}."""
        mdl = self.model
        y_strings, z_strings = strings
        ydec = self._y_decoder(y_strings)
        try:
            state = mdl.ctx_prepare(self._z_hat(_canonical(self._decode_z(z_strings, shape))))
            decoded: List[torch.Tensor] = []
            for i in range(mdl.ctx_slices):
                mu, index, mean_support = self._context(i, state, decoded)
                sym = _canonical(ydec.decode_slice(index))
                decoded.append(self._reconstruct(i, sym, mu, mean_support))
        finally:
            ydec.close()
        y_hat, x_hat = self._finish(decoded)
        return {"x_hat": x_hat.permute(0, 2, 3, 1).contiguous(), "y_hat": y_hat}

    # --- the host wire -----------------------------------------------------------
    def _encode_strings(self, enc) -> List[List[bytes]]:
        """One device->host copy of every symbol and index, then one rANS
        stream per image for y and for z."""
        syms = enc["syms"]
        host = [t.cpu().numpy() for t in (enc["z_sym"], torch.cat(syms, 1),
                                          torch.cat(enc["idxs"], 1))]
        z_sym_h, sym_h, idx_h = host
        bounds = np.cumsum([0] + [s.shape[1] for s in syms])
        symbols = np.concatenate([_flat(sym_h[:, a:b], self.ref_layout)
                                  for a, b in zip(bounds[:-1], bounds[1:])], 1)
        indexes = np.concatenate([_flat(idx_h[:, a:b], self.ref_layout)
                                  for a, b in zip(bounds[:-1], bounds[1:])], 1)
        gt = self.tables.gaussian
        y_strings = coding.encode_batch(
            symbols, indexes, gt.quantized_cdf, gt.cdf_length, gt.offset
        )
        return [y_strings, self._encode_z(z_sym_h)]

    def _y_decoder(self, y_strings: List[bytes]) -> "_HostYDecoder":
        return _HostYDecoder(y_strings, self.tables.gaussian, self.device, self.ref_layout)

    # --- z (factorized bottleneck) ---------------------------------------------
    def _z_tables(self) -> EntropyTables:
        return self.tables.bottlenecks["entropy_bottleneck"]

    def _encode_z(self, sym: np.ndarray) -> List[bytes]:
        B, C, h, w = sym.shape
        t = self._z_tables()
        idx = np.broadcast_to(_eb_indexes((h, w), C, self.ref_layout), (B, h * w * C))
        return coding.encode_batch(
            _flat(sym, self.ref_layout), idx, t.quantized_cdf, t.cdf_length, t.offset
        )

    def _decode_z(self, strings: List[bytes], shape_hw) -> torch.Tensor:
        """-> z's int32 symbols (B, C, zh, zw) on the codec's device."""
        h, w = shape_hw
        t = self._z_tables()
        C = t.num_distributions
        idx = np.broadcast_to(_eb_indexes((h, w), C, self.ref_layout),
                              (len(strings), h * w * C))
        dec = coding.BatchRansDecoder(strings)
        sym = dec.decode_stream(idx, t.quantized_cdf, t.cdf_length, t.offset,
                                lut=t.symbol_lut())
        dec.close()
        return torch.from_numpy(_unflat(sym, C, h, w, self.ref_layout)).to(self.device)


class _HostYDecoder:
    """The host wire's y decoder: per slice, the scale index to the host,
    rANS there (continuing each image's stream), the symbols back."""

    def __init__(self, strings: List[bytes], tables: EntropyTables, device, ref_layout: bool):
        self._dec = coding.BatchRansDecoder(strings)
        self._tables = tables
        self._lut = tables.symbol_lut()
        self._device = device
        self._ref_layout = ref_layout

    def decode_slice(self, index: torch.Tensor) -> torch.Tensor:
        """(B, c, h, w) scale indexes -> int32 symbols of that shape."""
        idx_np = index.cpu().numpy()
        _, c, h, w = idx_np.shape
        t = self._tables
        sym = self._dec.decode_stream(_flat(idx_np, self._ref_layout), t.quantized_cdf,
                                      t.cdf_length, t.offset, lut=self._lut)
        return torch.from_numpy(_unflat(sym, c, h, w, self._ref_layout)).to(self._device)

    def close(self):
        self._dec.close()
