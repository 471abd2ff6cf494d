"""Host rANS coder: ctypes bindings over the port's own ``csrc/rans.cpp``.

The subset of ``icm_tpu/coding/__init__.py`` that the host wire needs:
``encode_batch`` (one stream per image, threaded in C++),
``BatchRansDecoder.decode_stream`` (the AR slice loop's decoder, with the
bucket symbol LUT) and ``pmf_to_quantized_cdf_rows`` (the CDF builder).
The library is built from source at first use (``_native.build_rans``);
there is no pure-Python fallback. The device wire's lane-parallel coder
is the submodule ``device_rans``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Sequence

import numpy as np

from .. import _native
from .wire import WireFormatError, reject_framework_wire

__all__ = [
    "encode_batch",
    "BatchRansDecoder",
    "pmf_to_quantized_cdf_rows",
    "WireFormatError",
]

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_f32p = ctypes.POINTER(ctypes.c_float)

_bound = None
_bind_lock = threading.Lock()


def _lib():
    global _bound
    with _bind_lock:
        if _bound is not None:
            return _bound
        lib = _native.load("rans")
        lib.rans_free_buffer.argtypes = [_u8p]
        lib.rans_free_buffer.restype = None
        lib.rans_encode_batch.restype = ctypes.c_int64
        lib.rans_encode_batch.argtypes = [
            _i32p, _i32p, ctypes.c_int64, ctypes.c_int64, _i32p,
            ctypes.c_int64, _i32p, _i32p, ctypes.POINTER(_u8p), _i64p,
            ctypes.c_int,
        ]
        lib.rans_dec_batch_new.restype = ctypes.c_void_p
        lib.rans_dec_batch_new.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64]
        lib.rans_dec_batch_decode_lut.restype = None
        lib.rans_dec_batch_decode_lut.argtypes = [
            ctypes.c_void_p, _i32p, ctypes.c_int64, ctypes.c_int64, _i32p,
            ctypes.c_int64, _i32p, _i32p, _u16p, _i32p, ctypes.c_int,
        ]
        lib.rans_dec_batch_free.restype = None
        lib.rans_dec_batch_free.argtypes = [ctypes.c_void_p]
        lib.pmf_to_quantized_cdf_rows.restype = ctypes.c_int
        lib.pmf_to_quantized_cdf_rows.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _i32p, ctypes.c_int,
            _i32p, ctypes.c_int,
        ]
        _bound = lib
        return lib


def _as_i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).reshape(-1), dtype=np.int32)


def _ptr(a: np.ndarray, ptype=_i32p):
    return a.ctypes.data_as(ptype)


def _threads() -> int:
    return os.cpu_count() or 1


def encode_batch(symbols, indexes, cdfs, cdf_lengths, offsets) -> List[bytes]:
    """Encode a (B, N) symbol/index batch into B independent streams."""
    lib = _lib()
    symbols = np.ascontiguousarray(symbols, np.int32)
    indexes = np.ascontiguousarray(indexes, np.int32)
    if symbols.ndim != 2 or symbols.shape != indexes.shape:
        raise ValueError(
            f"symbols {symbols.shape} and indexes {indexes.shape} must be "
            "equal (B, N) arrays"
        )
    B, N = symbols.shape
    cdf = np.ascontiguousarray(cdfs, np.int32)
    lens, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    if indexes.size and (indexes.min() < 0 or indexes.max() >= cdf.shape[0]):
        raise ValueError("index out of range of the CDF table")
    out = _u8p()
    sizes = np.zeros(B, np.int64)
    lib.rans_encode_batch(
        _ptr(symbols), _ptr(indexes), B, N, _ptr(cdf), cdf.shape[1],
        _ptr(lens), _ptr(offs), ctypes.byref(out), _ptr(sizes, _i64p),
        _threads(),
    )
    blob = ctypes.string_at(out, int(sizes.sum()))
    lib.rans_free_buffer(out)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [blob[int(a):int(b)] for a, b in zip(bounds[:-1], bounds[1:])]


class BatchRansDecoder:
    """Stateful decoder over B parallel streams: each ``decode_stream``
    call decodes (B, ...) indexes into int32 symbols of the same shape in
    one threaded native call, continuing where the last call stopped."""

    def __init__(self, streams: Sequence[bytes]):
        for s in streams:
            reject_framework_wire(s, "host rANS")
        self._lib = _lib()
        self._n = len(streams)
        blob = b"".join(streams)
        self._arena = (ctypes.c_uint8 * max(len(blob), 1)).from_buffer_copy(
            blob or b"\0"
        )
        self._sizes = np.array([len(s) for s in streams], np.int64)
        self._offs = np.zeros(self._n, np.int64)
        np.cumsum(self._sizes[:-1], out=self._offs[1:])
        self._h = self._lib.rans_dec_batch_new(
            self._arena, _ptr(self._offs, _i64p), _ptr(self._sizes, _i64p),
            self._n,
        )

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets, lut) -> np.ndarray:
        """``lut``: the (n_dists, 256) uint16 bucket table of
        ``EntropyTables.symbol_lut``."""
        idx = np.ascontiguousarray(indexes, np.int32)
        shape = idx.shape
        if shape[0] != self._n:
            raise ValueError(f"{shape[0]} index rows for {self._n} streams")
        flat = idx.reshape(self._n, -1)
        cdf = np.ascontiguousarray(cdfs, np.int32)
        if flat.size and (flat.min() < 0 or flat.max() >= cdf.shape[0]):
            raise ValueError("index out of range of the CDF table")
        lens, offs = _as_i32(cdf_lengths), _as_i32(offsets)
        lut = np.ascontiguousarray(lut, np.uint16)
        out = np.empty_like(flat)
        self._lib.rans_dec_batch_decode_lut(
            self._h, _ptr(flat), self._n, flat.shape[1], _ptr(cdf),
            cdf.shape[1], _ptr(lens), _ptr(offs), _ptr(lut, _u16p),
            _ptr(out), _threads(),
        )
        return out.reshape(shape)

    def close(self):
        if self._h:
            self._lib.rans_dec_batch_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def pmf_to_quantized_cdf_rows(pmf, tail_mass, pmf_lengths, precision: int = 16):
    """Batched row CDF build: row i quantizes ``pmf[i, :len_i]`` plus its
    tail mass into a CDF of ``len_i + 2`` entries; -> (rows, max_len + 2)."""
    lib = _lib()
    pmf = np.ascontiguousarray(pmf, np.float32)
    tail = np.ascontiguousarray(tail_mass, np.float32)
    lens = _as_i32(pmf_lengths)
    rows, max_len = pmf.shape
    out = np.zeros((rows, max_len + 2), np.int32)
    rc = lib.pmf_to_quantized_cdf_rows(
        _ptr(pmf, _f32p), rows, max_len, _ptr(tail, _f32p), _ptr(lens),
        precision, _ptr(out), _threads(),
    )
    if rc != 0:
        raise ValueError(f"Invalid pmf rows (native rc={rc})")
    return out
