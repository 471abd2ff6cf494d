"""Lane-parallel rANS on the card: the device wire's entropy coder.

Port of ``icm_tpu/coding/device_rans.py``. Each lane is an independent
rANS stream (32-bit state, 16-bit words, 16-bit precision, the host
coder's table semantics); symbols that are independent given the context
(one ChARM slice) are laid out across lanes and coded step by step, so
the serial depth is the symbol count per lane. Out-of-range symbols are
coded as the row's bypass symbol (``cdf_length - 2``) and their raw
32-bit values travel beside the stream as ``(dest, raw)`` pairs: ``dest``
is the step-major position ``t * lanes + lane``.

- :func:`build_device_tables` builds the packed pair table ``lut2``, the
  encoder's ``fc`` and the ``(escape symbol, offset)`` pairs ``eo`` in
  numpy, as the JAX package does, and puts them on a device. 32-bit
  unsigned entries are held as int32 tensors of the same bits.
- :func:`decode_lanes` and :func:`encode_lanes` launch the CUDA kernels
  of ``csrc/rans_lanes.cu`` for CUDA tensors (:func:`decode_lanes_cuda`,
  :func:`encode_lanes_cuda` through :func:`encode_lanes_kernel`;
  ``DECODE_LAUNCHES`` and ``ENCODE_LAUNCHES`` count the launches) and
  run the plain versions for CPU tensors
  (:func:`decode_lanes_reference`, :func:`encode_lanes_reference`: a
  Python loop over the steps of tensor ops on int64 with explicit 32-bit
  masks). The card path never calls the plain versions.
- :func:`init_lanes` and :func:`fix_escapes` are plain tensor ops on
  either device: the decode kernel starts a lane itself when it is given
  no state, and the escape scatter is layout work, not the coder.
- :func:`assemble_streams` and :func:`lane_offsets` are host numpy.

Words are 16-bit: int16 tensors holding the words' bits. The encoder's
escape pairs come out compacted to their count (the JAX version returns
full-size buffers and a count, so that its shapes stay static); nothing
here pads to a bucket, since PyTorch compiles nothing per shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from .. import _native

PRECISION = 16
_L = 1 << 16  # renormalization interval lower bound
_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF
# decoded-value sentinel marking an escaped symbol; legit values are
# sym + offset with |value| < ~2k for every table the codecs build
# (build_device_tables checks it)
ESC_VAL = 0x7FFF

# launches of the CUDA kernels in this process; chip_smoke.py zeroes them
# before driving a path and reads them after
DECODE_LAUNCHES = 0
ENCODE_LAUNCHES = 0


# --------------------------------------------------------------------------
# Tables
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceCoderTables:
    """Coding tables on a device, built from host ``EntropyTables``.

    ``lut2[r * 65536 + peek] = (value & 0xFFFF, freq << 16 | (peek - low))``
    for the symbol whose CDF interval holds ``peek``; ``value`` is the
    offset value (``sym + offset[r]``) or :data:`ESC_VAL` for the bypass
    symbol. ``fc[r, s] = freq << 16 | low`` drives the encoder.
    """

    lut2: torch.Tensor  # int32 bits of uint32 (n * 65536, 2)
    fc: torch.Tensor  # int32 bits of uint32 (n, max_sym + 1)
    esc_sym: torch.Tensor  # int32 (n,) = cdf_length - 2 (bypass symbol)
    offset: torch.Tensor  # int32 (n,)
    eo: torch.Tensor  # int32 (n, 2) = (esc_sym, offset)

    @property
    def num_rows(self) -> int:
        return int(self.fc.shape[0])


def build_device_tables(t, device="cuda") -> DeviceCoderTables:
    """Host-side table build (numpy) from ``EntropyTables`` ``t``, put on
    ``device`` once."""
    cdf = np.asarray(t.quantized_cdf, np.int64)
    lens = np.asarray(t.cdf_length, np.int64)
    offs = np.asarray(t.offset, np.int64)
    n = cdf.shape[0]
    max_sym = int(lens.max()) - 1  # coded symbols 0 .. cdf_length-2
    fc = np.zeros((n, max_sym), np.uint32)
    lut2 = np.zeros((n, 1 << PRECISION, 2), np.uint32)
    peeks = np.arange(1 << PRECISION, dtype=np.int64)
    for r in range(n):
        L = int(lens[r])
        row = cdf[r, :L]
        freq = (row[1:] - row[:-1]).astype(np.int64)
        fc[r, : L - 1] = (freq.astype(np.uint32) << 16) | row[:-1].astype(np.uint32)
        s = np.clip(np.searchsorted(row, peeks, side="right") - 1, 0, L - 2)
        val = s + offs[r]
        legit = val[s < L - 2]
        if legit.size and int(np.abs(legit).max()) >= ESC_VAL:
            raise ValueError(
                f"row {r}: |value| {int(np.abs(legit).max())} >= escape sentinel")
        val = np.where(s == L - 2, ESC_VAL, val)
        start = peeks - row[s]
        lut2[r, :, 0] = (val & 0xFFFF).astype(np.uint32)
        lut2[r, :, 1] = (freq[s].astype(np.uint32) << 16) | start.astype(np.uint32)
    eo = np.stack([(lens - 2).astype(np.int32), offs.astype(np.int32)], axis=1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    return DeviceCoderTables(
        lut2=put(lut2.reshape(-1, 2)), fc=put(fc),
        esc_sym=put((lens - 2).astype(np.int32)), offset=put(offs.astype(np.int32)),
        eo=put(eo),
    )


# --------------------------------------------------------------------------
# Plain versions: int64 tensor ops, one step at a time
# --------------------------------------------------------------------------
def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 value in [0, 2**32)."""
    return t.to(torch.int64) & _MASK32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2**32) -> int32 of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _i16(t: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2**16) -> int16 of the same bits."""
    return torch.where(t >= 1 << 15, t - (1 << 16), t).to(torch.int16)


def init_lanes(words: torch.Tensor, off: torch.Tensor):
    """Per-lane decoder state from a flat word array: words int16 (W,),
    off int32 (lanes,) per-lane start. The first two words of each lane
    are the flushed final encoder state (hi, lo). -> (state int32 bits of
    uint32, ptr int32)."""
    w = words.to(torch.int64) & _MASK16
    last = max(w.numel() - 1, 0)
    base = off.to(torch.int64)
    state = (w[base.clamp(max=last)] << 16) | w[(base + 1).clamp(max=last)]
    return _i32(state), torch.full_like(off, 2)


def decode_lanes_reference(words, off, rows_T, tables: DeviceCoderTables,
                           state=None, ptr=None):
    """Plain version of :func:`decode_lanes` (int64 tensor ops)."""
    if state is None:
        state, ptr = init_lanes(words, off)
    w = words.to(torch.int64) & _MASK16
    last = max(w.numel() - 1, 0)
    base = off.to(torch.int64)
    s, p = _u32(state), ptr.to(torch.int64)
    T, lanes = rows_T.shape
    values = torch.empty((T, lanes), dtype=torch.int32, device=words.device)
    for t in range(T):
        e = tables.lut2[(rows_T[t].to(torch.int64) << PRECISION) + (s & _MASK16)]
        values[t] = (e[:, 0] ^ 0x8000) - 0x8000  # sign-extend 16 bits
        x = _u32(e[:, 1])
        s = (x >> 16) * (s >> 16) + (x & _MASK16)
        need = s < _L
        s = torch.where(need, (s << 16) | w[(base + p).clamp(max=last)], s)
        p = p + need.to(torch.int64)
    return values, _i32(s), p.to(torch.int32)


def encode_lanes_reference(values_T, rows_T, tables: DeviceCoderTables):
    """Plain version of :func:`encode_lanes` (int64 tensor ops)."""
    T, lanes = values_T.shape
    maxw = T + 2
    dev = values_T.device
    rows = rows_T.to(torch.int64)
    eo = tables.eo[rows].to(torch.int64)  # (T, lanes, 2)
    u = values_T.to(torch.int64) - eo[..., 1]
    es = eo[..., 0]
    esc = (u < 0) | (u >= es)
    x = _u32(tables.fc.reshape(-1)[rows * tables.fc.shape[1] + torch.where(esc, es, u)])
    f, c = x >> 16, x & _MASK16

    state = torch.full((lanes,), _L, dtype=torch.int64, device=dev)
    words, emits = [], []
    for t in range(T - 1, -1, -1):  # the encoder runs over symbols in reverse
        emit = state >= (f[t] << 16)
        words.append(state & _MASK16)
        emits.append(emit)
        state = torch.where(emit, state >> 16, state)
        q = state // f[t]
        state = (q << 16) + (state - q * f[t]) + c[t]

    # emission k (0 = first emitted) of a lane with K emissions goes to
    # decode position 2 + (K - 1 - k); column maxw collects the rest
    buf = torch.zeros((lanes, maxw + 1), dtype=torch.int64, device=dev)
    if T:
        em = torch.stack(emits).to(torch.int64)  # (T, lanes), emission order
        pos = torch.cumsum(em, 0) - em
        K = em.sum(0)
        col = torch.where(em.bool(), 1 + K - pos, maxw)
        buf.scatter_(1, col.t(), torch.stack(words).t())
    else:
        K = torch.zeros(lanes, dtype=torch.int64, device=dev)
    buf = buf[:, :maxw]
    buf[:, 0] = state >> 16
    buf[:, 1] = state & _MASK16
    dest = esc.reshape(-1).nonzero()[:, 0]
    raw = values_T.reshape(-1)[dest]
    return (_i16(buf), (K + 2).to(torch.int32), dest.to(torch.int32), raw,
            int(dest.numel()))


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------
_fns = None
_fns_lock = threading.Lock()


def _kernel_fns():
    global _fns
    with _fns_lock:
        if _fns is None:
            lib = _native.load("rans_lanes")
            p, i = ctypes.c_void_p, ctypes.c_int
            dec = lib.rans_decode_lanes
            dec.restype = i
            dec.argtypes = [p, ctypes.c_longlong] + [p] * 8 + [i, i, p]
            enc = lib.rans_encode_lanes
            enc.restype = i
            enc.argtypes = [p] * 4 + [i] + [p] * 3 + [i, i, p]
            _fns = (dec, enc)
        return _fns


def _check(device, **tensors):
    """Each (tensor, dtype, shape) on ``device``, of that dtype and
    shape (None: any length), contiguous."""
    for name, (t, dtype, shape) in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if len(shape) != t.dim() or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _table_args(tables: DeviceCoderTables):
    n = tables.num_rows
    return dict(lut2=(tables.lut2, torch.int32, (n << PRECISION, 2)),
                fc=(tables.fc, torch.int32, (n, None)),
                eo=(tables.eo, torch.int32, (n, 2)))


def decode_lanes_cuda(words, off, rows_T, tables: DeviceCoderTables,
                      state=None, ptr=None):
    """Launch the decode kernel: words int16 (W,), off int32 (lanes,),
    rows_T int32 (T, lanes) with every row in [0, num_rows), state/ptr
    int32 (lanes,) or both None (start from the flushed states); all
    contiguous CUDA tensors on one device. -> new (values int32 (T, lanes),
    state, ptr)."""
    global DECODE_LAUNCHES
    if rows_T.dim() != 2:
        raise ValueError(f"rows_T must be (T, lanes), got {tuple(rows_T.shape)}")
    T, lanes = rows_T.shape
    if lanes and words.numel() == 0:
        raise ValueError("no words to decode")
    dev = words.device
    args = dict(words=(words, torch.int16, (None,)), off=(off, torch.int32, (lanes,)),
                rows_T=(rows_T, torch.int32, (T, lanes)), **_table_args(tables))
    if (state is None) != (ptr is None):
        raise ValueError("pass both state and ptr, or neither")
    if state is not None:
        args.update(state=(state, torch.int32, (lanes,)), ptr=(ptr, torch.int32, (lanes,)))
    _check(dev, **args)
    values = torch.empty((T, lanes), dtype=torch.int32, device=dev)
    state_out = torch.empty(lanes, dtype=torch.int32, device=dev)
    ptr_out = torch.empty(lanes, dtype=torch.int32, device=dev)
    dec, _ = _kernel_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = dec(words.data_ptr(), words.numel(), off.data_ptr(), rows_T.data_ptr(),
                 tables.lut2.data_ptr(), 0 if state is None else state.data_ptr(),
                 0 if ptr is None else ptr.data_ptr(), values.data_ptr(),
                 state_out.data_ptr(), ptr_out.data_ptr(), T, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"rans decode kernel launch failed (code {rc})")
    if lanes:  # the C entry launches nothing for no lanes
        DECODE_LAUNCHES += 1
    return values, state_out, ptr_out


def encode_lanes_kernel(values_T, rows_T, tables: DeviceCoderTables):
    """Launch the encode kernel alone: values_T, rows_T int32 (T, lanes),
    every row in [0, num_rows); contiguous CUDA tensors on one device.
    -> (buf int16 (lanes, T + 2), lengths int32 (lanes,), escape marks
    bool (T, lanes)); :func:`encode_lanes_cuda` compacts the marks."""
    global ENCODE_LAUNCHES
    if values_T.dim() != 2:
        raise ValueError(f"values_T must be (T, lanes), got {tuple(values_T.shape)}")
    T, lanes = values_T.shape
    dev = values_T.device
    _check(dev, values_T=(values_T, torch.int32, (T, lanes)),
           rows_T=(rows_T, torch.int32, (T, lanes)), **_table_args(tables))
    buf = torch.empty((lanes, T + 2), dtype=torch.int16, device=dev)
    lengths = torch.empty(lanes, dtype=torch.int32, device=dev)
    esc = torch.empty((T, lanes), dtype=torch.bool, device=dev)
    _, enc = _kernel_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = enc(values_T.data_ptr(), rows_T.data_ptr(), tables.fc.data_ptr(),
                 tables.eo.data_ptr(), tables.fc.shape[1], buf.data_ptr(),
                 lengths.data_ptr(), esc.data_ptr(), T, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"rans encode kernel launch failed (code {rc})")
    if lanes:
        ENCODE_LAUNCHES += 1
    return buf, lengths, esc


def encode_lanes_cuda(values_T, rows_T, tables: DeviceCoderTables):
    """The encode kernel, then the escape marks compacted (``nonzero``,
    which waits for the kernel: the count sizes the outputs). -> see
    :func:`encode_lanes`."""
    buf, lengths, esc = encode_lanes_kernel(values_T, rows_T, tables)
    dest = esc.reshape(-1).nonzero()[:, 0]
    raw = values_T.reshape(-1)[dest]
    return buf, lengths, dest.to(torch.int32), raw, int(dest.numel())


# --------------------------------------------------------------------------
# The entry points
# --------------------------------------------------------------------------
def _on(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {what} path for device {t.device}")
    return False


def decode_lanes(words, off, rows_T, tables: DeviceCoderTables, state=None, ptr=None):
    """Decode ``rows_T.shape[0]`` symbols from each of ``lanes`` streams.

    words: int16 (W,) 16-bit words; off: int32 (lanes,) lane starts;
    rows_T: int32 (T, lanes) distribution row per step per lane. Returns
    (values int32 (T, lanes), state, ptr); pass state and ptr back in to
    continue the same streams (the ChARM slice loop does). Escaped
    positions decode to :data:`ESC_VAL`: :func:`fix_escapes` restores
    them. The kernel on a CUDA tensor, the plain version on a CPU one."""
    if _on(words, "rANS decode"):
        return decode_lanes_cuda(words, off, rows_T, tables, state, ptr)
    return decode_lanes_reference(words, off, rows_T, tables, state, ptr)


def encode_lanes(values_T, rows_T, tables: DeviceCoderTables):
    """Encode (T, lanes) int32 values with their rows into per-lane rANS
    streams. Returns ``(buf, lengths, dest, raw, n_esc)``:

      buf     int16 (lanes, T + 2): each lane's words in decode order
              (flushed state hi, lo, then the emissions reversed), zero
              past its length;
      lengths int32 (lanes,) words used per lane;
      dest    int32 (n_esc,) step-major positions ``t * lanes + lane`` of
              the escapes, ascending;
      raw     int32 (n_esc,) their values;
      n_esc   int, the number of escapes.

    The kernel on a CUDA tensor, the plain version on a CPU one."""
    if _on(values_T, "rANS encode"):
        return encode_lanes_cuda(values_T, rows_T, tables)
    return encode_lanes_reference(values_T, rows_T, tables)


def fix_escapes(values_T: torch.Tensor, dest: torch.Tensor, raw: torch.Tensor):
    """Overwrite escaped positions with their raw values: values_T (T,
    lanes) from :func:`decode_lanes`; dest (E,) step-major positions in
    that grid (no padding); raw int32 (E,). -> a new (T, lanes)."""
    flat = values_T.reshape(-1).scatter(0, dest.to(torch.int64), raw)
    return flat.reshape(values_T.shape)


# --------------------------------------------------------------------------
# Host-side wire assembly
# --------------------------------------------------------------------------
def assemble_streams(buf: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(lanes, maxw) decode-order rows -> flat uint16 word array (lane 0's
    words, then lane 1's, ...)."""
    buf = np.asarray(buf)
    lengths = np.asarray(lengths, np.int64)
    cols = np.arange(buf.shape[1], dtype=np.int64)[None, :]
    return buf[cols < lengths[:, None]].astype(np.uint16)


def lane_offsets(lengths: np.ndarray) -> np.ndarray:
    """Per-lane start offsets into the flat word array."""
    lengths = np.asarray(lengths, np.int64)
    off = np.zeros(lengths.shape[0], np.int64)
    np.cumsum(lengths[:-1], out=off[1:])
    return off.astype(np.int32)
