"""Lane-parallel rANS on the card: the device wire's entropy coder.

Port of ``icm_tpu/coding/device_rans.py``. Each lane is an independent
rANS stream (32-bit state, 16-bit words, 16-bit precision, the host
coder's table semantics); symbols that are independent given the context
(one ChARM slice) are laid out across lanes and coded step by step, so
the serial depth is the symbol count per lane. Out-of-range symbols are
coded as the row's bypass symbol (``cdf_length - 2``) and their raw
32-bit values travel beside the stream as ``(dest, raw)`` pairs: ``dest``
is the step-major position ``t * lanes + lane``.

- :func:`build_device_tables` builds what the kernels read and puts it on
  a device: ``ctab``, the rows' CDFs as 16-bit words with a coarse index
  per row (:func:`compact_tables`; the decode kernel searches it for the
  symbol), ``fcr``, each symbol's ``freq << 16 | low`` with the
  multiply-high reciprocal of its frequency beside it
  (:func:`reciprocals`; the encode kernel divides with it), and the
  ``(escape symbol, offset)`` pairs ``eo``. The plain versions read the
  JAX package's tables, the packed pair table ``lut2`` and the encoder's
  ``fc``; those are made at their first use. 32-bit unsigned entries are
  held as int32 tensors of the same bits.
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
import functools
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

# encode lanes a block: the fastest at both 2 and 32 images of the device
# wire (tools/torch_sweep_rans.py; PERF.md section 6)
ENCODE_THREADS = 16


# --------------------------------------------------------------------------
# Tables
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class DeviceCoderTables:
    """Coding tables on a device, built from host ``EntropyTables``.

    The kernels read ``ctab`` (:func:`compact_tables`), ``fcr`` and
    ``eo``. The plain versions read ``lut2[r * 65536 + peek] = (value &
    0xFFFF, freq << 16 | (peek - low))`` for the symbol whose CDF interval
    holds ``peek`` (``value`` is the offset value ``sym + offset[r]``, or
    :data:`ESC_VAL` for the bypass symbol) and ``fc[r, s] = freq << 16 |
    low``; both are made on the tables' device at their first use.
    """

    cdf: np.ndarray  # int64 (n, max_length) host CDF rows
    cdf_length: np.ndarray  # int64 (n,)
    esc_sym: torch.Tensor  # int32 (n,) = cdf_length - 2 (bypass symbol)
    offset: torch.Tensor  # int32 (n,)
    eo: torch.Tensor  # int32 (n, 2) = (esc_sym, offset)
    ctab: torch.Tensor  # int32 words of the compact decode tables (compact_tables)
    fcr: torch.Tensor  # int32 bits of uint32 (n, max_sym, 2): (fc, reciprocal of its freq)

    @property
    def num_rows(self) -> int:
        return int(self.fcr.shape[0])

    @functools.cached_property
    def lut2(self) -> torch.Tensor:
        """int32 bits of uint32 (n * 65536, 2)."""
        n = self.num_rows
        offs = self.offset.cpu().numpy().astype(np.int64)
        lut2 = np.zeros((n, 1 << PRECISION, 2), np.uint32)
        peeks = np.arange(1 << PRECISION, dtype=np.int64)
        for r in range(n):
            L = int(self.cdf_length[r])
            row = self.cdf[r, :L]
            freq = row[1:] - row[:-1]
            s = np.clip(np.searchsorted(row, peeks, side="right") - 1, 0, L - 2)
            val = np.where(s == L - 2, ESC_VAL, s + offs[r])
            lut2[r, :, 0] = (val & 0xFFFF).astype(np.uint32)
            lut2[r, :, 1] = (freq[s].astype(np.uint32) << 16) | (peeks - row[s]).astype(np.uint32)
        return _put(lut2.reshape(-1, 2), self.ctab.device)

    @functools.cached_property
    def fc(self) -> torch.Tensor:
        """int32 bits of uint32 (n, max_sym)."""
        return self.fcr[..., 0].contiguous()


def _put(a: np.ndarray, device) -> torch.Tensor:
    """uint32 or int32 numpy -> int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def build_device_tables(t, device="cuda") -> DeviceCoderTables:
    """Host-side table build (numpy) from ``EntropyTables`` ``t``, put on
    ``device`` once."""
    cdf = np.asarray(t.quantized_cdf, np.int64)
    lens = np.asarray(t.cdf_length, np.int64)
    offs = np.asarray(t.offset, np.int64)
    n = cdf.shape[0]
    max_sym = int(lens.max()) - 1  # coded symbols 0 .. cdf_length-2
    fc = np.zeros((n, max_sym), np.uint32)
    for r in range(n):
        L = int(lens[r])
        row = cdf[r, :L]
        # decoded values sym + offset, sym < L - 2, stay clear of the sentinel
        top = max(abs(int(offs[r])), abs(int(offs[r]) + L - 3)) if L > 2 else 0
        if top >= ESC_VAL:
            raise ValueError(f"row {r}: |value| {top} >= escape sentinel")
        fc[r, : L - 1] = ((row[1:] - row[:-1]).astype(np.uint32) << 16) | row[:-1].astype(np.uint32)
    eo = np.stack([(lens - 2).astype(np.int32), offs.astype(np.int32)], axis=1)
    return DeviceCoderTables(
        cdf=cdf, cdf_length=lens,
        esc_sym=_put((lens - 2).astype(np.int32), device),
        offset=_put(offs.astype(np.int32), device), eo=_put(eo, device),
        ctab=_put(compact_tables(cdf, lens, offs), device),
        fcr=_put(np.stack([fc, reciprocals(fc >> 16)], axis=-1), device),
    )


def index_bits(length: int) -> int:
    """Bits of the coarse index of a CDF row of ``length`` entries:
    ceil(log2 length), at least 1 and at most 12."""
    return min(max(int(length - 1).bit_length(), 1), 12)


def compact_tables(cdf: np.ndarray, lens: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """The decode kernel's tables, one flat little-endian block (uint8,
    a multiple of 16 bytes) of three parts:

      meta  int32 (n, 4) per row: (CDF start, index start, in 16-bit
            words from the block's start; esc | k << 16 with esc = L - 2
            and k the index bits; offset);
      index uint16, per row 2 ** k + 1 entries: entry b is the symbol
            ``lut2`` gives for peek ``b << (16 - k)`` (entry 2 ** k: for
            65536, i.e. esc);
      cdf   uint16, per row its L CDF entries, 65536 stored as 0.

    ``lut2[r, peek]``'s symbol is the rightmost s in [index[b], index[b+1]]
    (b = peek >> (16 - k)) with cdf[s] <= peek; its freq is
    (cdf[s+1] - cdf[s]) mod 65536 and its start peek - cdf[s]. That holds
    for rows with cdf[0] = 0, entries non-decreasing, cdf[L-2] < 65536 and
    cdf[L-1] = 65536, which :func:`pmf_to_quantized_cdf_np` gives; other
    rows raise."""
    n = cdf.shape[0]
    head = 8 * n  # meta, in 16-bit words
    index, rows, meta = [], [], np.zeros((n, 4), np.int32)
    at_index = head
    for r in range(n):
        L = int(lens[r])
        row = cdf[r, :L].astype(np.int64)
        if L < 3 or row[0] != 0 or row[-1] != 1 << PRECISION or row[-2] >= 1 << PRECISION \
                or np.any(np.diff(row) < 0):
            raise ValueError(f"row {r}: not a quantized CDF the decode kernel can search")
        k = index_bits(L)
        starts = np.append(np.arange(1 << k, dtype=np.int64) << (PRECISION - k), 1 << PRECISION)
        index.append(np.clip(np.searchsorted(row, starts, side="right") - 1, 0, L - 2))
        meta[r, 1] = at_index
        meta[r, 2] = (L - 2) | (k << 16)
        meta[r, 3] = offs[r]
        at_index += (1 << k) + 1
        rows.append(row & _MASK16)
    at_cdf = at_index
    for r in range(n):
        meta[r, 0] = at_cdf
        at_cdf += int(lens[r])
    words = np.concatenate([meta.view(np.uint16).reshape(-1), *index, *rows]).astype(np.uint16)
    out = np.zeros(-(-2 * words.size // 16) * 16, np.uint8)
    out[: 2 * words.size] = words.astype("<u2").view(np.uint8)
    return out


def reciprocals(f: np.ndarray) -> np.ndarray:
    """Multiply-high constants for exact division by ``f`` (1 .. 65535):
    -> uint32 m = ceil(2 ** (32 + s) / f) - 2 ** 32 with s = ceil(log2 f),
    so that for every 32-bit x

        x // f == (((x * m) >> 32) + x) >> s

    (Granlund and Montgomery's round-up method: m's 33rd bit is the ``+
    x``; the kernel takes s as 32 - clz(f - 1)). Entries where f is 0
    (padding) get 0."""
    f = np.asarray(f, np.uint64)
    g = np.maximum(f, 1)
    s = np.array([int(v - 1).bit_length() for v in g.ravel()], np.uint64).reshape(g.shape)
    m = ((np.uint64(1) << (32 + s)) + g - 1) // g - (1 << 32)
    return np.where(f == 0, 0, m).astype(np.uint32)


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
    """-> (decode, encode, decode_smem_bytes, encode_smem_bytes,
    smem_limit): the C entries of ``csrc/rans_lanes.cu``, which alone
    knows the kernels' shared-memory layout."""
    global _fns
    with _fns_lock:
        if _fns is None:
            lib = _native.load("rans_lanes")
            p, i = ctypes.c_void_p, ctypes.c_int
            dec = lib.rans_decode_lanes
            dec.restype = i
            dec.argtypes = [p, ctypes.c_longlong] + [p] * 3 + [i] + [p] * 5 + [i] * 4 + [p]
            enc = lib.rans_encode_lanes
            enc.restype = i
            enc.argtypes = [p] * 4 + [i, i] + [p] * 3 + [i] * 4 + [p]
            dec_bytes = lib.rans_decode_smem_bytes
            dec_bytes.restype = i
            dec_bytes.argtypes = [i] * 3
            enc_bytes = lib.rans_encode_smem_bytes
            enc_bytes.restype = i
            enc_bytes.argtypes = [i] * 4
            limit = lib.rans_smem_limit
            limit.restype = i
            limit.argtypes = []
            _fns = (dec, enc, dec_bytes, enc_bytes, limit)
        return _fns


@functools.lru_cache(maxsize=None)
def _smem_limit(device) -> int:
    """Shared memory a block of these kernels may take on ``device``."""
    with torch.cuda.device(device):
        limit = _kernel_fns()[4]()
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of {device}")
    return limit


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


def decode_launch_config(tables: DeviceCoderTables, lanes: int, device):
    """-> (threads a block, True to stage ctab in shared memory). Chosen
    before the launch from sizes alone: the tables go to shared memory
    when they fit beside 32 lanes, and the lanes are cut into at most one
    block an SM of ``device`` while the block fits (each block stages the
    tables once)."""
    smem_bytes, limit = _kernel_fns()[2], _smem_limit(device)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    nbytes = 4 * tables.ctab.numel()
    smem = smem_bytes(nbytes, 32, 1) <= limit
    threads = 32
    while (threads < 1024 and threads * sm_count < lanes
           and smem_bytes(nbytes, 2 * threads, int(smem)) <= limit):
        threads *= 2
    return threads, smem


def encode_launch_config(T: int, n_rows: int, device):
    """-> (threads a block, True to keep the emissions in shared memory):
    ``ENCODE_THREADS`` lanes a block, each lane's T + 2 words in shared
    memory of ``device`` while that many rows fit beside the codes' ring,
    else written straight to the output rows."""
    fits = _kernel_fns()[3](T, n_rows, ENCODE_THREADS, 1) <= _smem_limit(device)
    return ENCODE_THREADS, fits


def decode_lanes_cuda(words, off, rows_T, tables: DeviceCoderTables,
                      state=None, ptr=None):
    """Launch the decode kernel: words int16 (W,), off int32 (lanes,),
    rows_T int32 (T, lanes) with every row in [0, num_rows), state/ptr
    int32 (lanes,) or both None (start from the flushed states); all
    contiguous CUDA tensors on one device. -> new (values int32 (T,
    lanes), state, ptr)."""
    return _decode_launch(words, off, rows_T, tables, state, ptr)


def _decode_launch(words, off, rows_T, tables, state, ptr, config=None):
    """:func:`decode_lanes_cuda`, launched with ``config`` (threads, smem)
    when given, else with :func:`decode_launch_config`'s."""
    global DECODE_LAUNCHES
    if rows_T.dim() != 2:
        raise ValueError(f"rows_T must be (T, lanes), got {tuple(rows_T.shape)}")
    T, lanes = rows_T.shape
    if lanes and words.numel() == 0:
        raise ValueError("no words to decode")
    dev = words.device
    args = dict(words=(words, torch.int16, (None,)), off=(off, torch.int32, (lanes,)),
                rows_T=(rows_T, torch.int32, (T, lanes)),
                ctab=(tables.ctab, torch.int32, (None,)))
    if (state is None) != (ptr is None):
        raise ValueError("pass both state and ptr, or neither")
    if state is not None:
        args.update(state=(state, torch.int32, (lanes,)), ptr=(ptr, torch.int32, (lanes,)))
    _check(dev, **args)
    dec, _, smem_bytes, _, _ = _kernel_fns()
    threads, smem = config or decode_launch_config(tables, lanes, dev)
    if smem_bytes(4 * tables.ctab.numel(), threads, int(smem)) > _smem_limit(dev):
        raise ValueError(f"{threads} lanes with these tables do not fit in shared memory")
    values = torch.empty((T, lanes), dtype=torch.int32, device=dev)
    state_out = torch.empty(lanes, dtype=torch.int32, device=dev)
    ptr_out = torch.empty(lanes, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = dec(words.data_ptr(), words.numel(), off.data_ptr(), rows_T.data_ptr(),
                 tables.ctab.data_ptr(), 4 * tables.ctab.numel(),
                 0 if state is None else state.data_ptr(),
                 0 if ptr is None else ptr.data_ptr(), values.data_ptr(),
                 state_out.data_ptr(), ptr_out.data_ptr(), T, lanes, threads, int(smem),
                 stream)
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
    return _encode_launch(values_T, rows_T, tables)


def _encode_launch(values_T, rows_T, tables, config=None):
    """:func:`encode_lanes_kernel`, launched with ``config`` (threads,
    smem) when given, else with :func:`encode_launch_config`'s."""
    global ENCODE_LAUNCHES
    if values_T.dim() != 2:
        raise ValueError(f"values_T must be (T, lanes), got {tuple(values_T.shape)}")
    T, lanes = values_T.shape
    dev = values_T.device
    n, n_sym = tables.num_rows, tables.fcr.shape[1]
    _check(dev, values_T=(values_T, torch.int32, (T, lanes)),
           rows_T=(rows_T, torch.int32, (T, lanes)),
           fcr=(tables.fcr, torch.int32, (n, n_sym, 2)),
           eo=(tables.eo, torch.int32, (n, 2)))
    _, enc, _, smem_bytes, _ = _kernel_fns()
    threads, smem = config or encode_launch_config(T, n, dev)
    if smem_bytes(T, n, threads, int(smem)) > _smem_limit(dev):
        raise ValueError(f"{threads} lanes of {T} steps do not fit in shared memory")
    buf = torch.empty((lanes, T + 2), dtype=torch.int16, device=dev)
    lengths = torch.empty(lanes, dtype=torch.int32, device=dev)
    esc = torch.empty((T, lanes), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = enc(values_T.data_ptr(), rows_T.data_ptr(), tables.fcr.data_ptr(),
                 tables.eo.data_ptr(), n, n_sym,
                 buf.data_ptr(), lengths.data_ptr(), esc.data_ptr(), T, lanes, threads,
                 int(smem), stream)
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
    that grid; raw int32 (E,). Entries at or past ``T * lanes`` are
    padding and dropped (JAX's ``mode="drop"``): they land in one extra
    slot past the grid, which is cut. -> a new (T, lanes)."""
    n = values_T.numel()
    d = dest.to(torch.int64).clamp(max=n)
    flat = torch.cat([values_T.reshape(-1), values_T.new_zeros(1)]).scatter(0, d, raw)
    return flat[:n].reshape(values_T.shape)


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
