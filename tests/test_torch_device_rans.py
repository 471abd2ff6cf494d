"""The port's lane-parallel rANS (plain versions, on the CPU) against the
JAX package's ``coding/device_rans.py`` and its numpy oracle.

Same tables, same payloads: the port's ``build_device_tables`` equals the
JAX build array for array; its ``encode_lanes`` gives the words, lengths
and escape pairs of JAX's ``encode_lanes`` and of ``np_encode`` byte for
byte; each side's decoder reads the other's streams; a decode continues
across calls with its state and pointer; in-range symbols cost close to
their entropy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.coding import device_rans as jdr
from icm_tpu.entropy import EntropyTables as JaxEntropyTables
from icm_tpu.entropy.base import pmf_to_quantized_cdf_np
from icm_tpu_torch.coding import device_rans as tdr
from icm_tpu_torch.entropy import EntropyTables

INT32_EXTREMES = np.array([2 ** 31 - 1, -(2 ** 31), 2 ** 20, -12345678], np.int64)


def _random_tables(rng, n_rows=7, max_support=19):
    """CDF arrays with random row lengths and shapes, tiny rows included
    (``tests/test_device_rans.py``'s generator)."""
    cdf = np.zeros((n_rows, max_support + 2), np.int32)
    lengths = np.zeros(n_rows, np.int32)
    offsets = np.zeros(n_rows, np.int32)
    for r in range(n_rows):
        support = int(rng.integers(1, max_support))
        pmf = rng.random(support).astype(np.float32) + 1e-3
        pmf = pmf / pmf.sum() * (1.0 - 2 ** -8)
        row = pmf_to_quantized_cdf_np(
            np.concatenate([pmf, [1.0 - pmf.sum()]]).astype(np.float32))
        cdf[r, : row.shape[0]] = row
        lengths[r] = row.shape[0]
        offsets[r] = int(rng.integers(-9, 3))
    return cdf, lengths, offsets


@pytest.fixture(scope="module")
def tables():
    arrays = _random_tables(np.random.default_rng(0))
    jhost = JaxEntropyTables(*arrays)
    thost = EntropyTables(*arrays)
    return jhost, jdr.build_device_tables(jhost), thost, tdr.build_device_tables(thost, "cpu")


def _payload(rng, T, lanes, host, esc):
    """(values, rows) int32 (T, lanes): in-range values, then about 10%
    escapes ("some"), none, or every value an int32 extreme ("all")."""
    rows = rng.integers(0, host.num_distributions, size=(T, lanes)).astype(np.int32)
    support = host.cdf_length[rows] - 2
    offs = host.offset[rows]
    values = (rng.integers(0, 1 << 16, size=(T, lanes)) % np.maximum(support, 1) + offs)
    if esc == "some":
        wild = rng.integers(-(1 << 20), 1 << 20, size=(T, lanes))
        values = np.where(rng.random((T, lanes)) < 0.1, offs + support + wild, values)
    elif esc == "all":
        values = rng.choice(INT32_EXTREMES, size=(T, lanes))
    return values.astype(np.int32), rows


def _port_encode(values, rows, tdev):
    buf, lengths, dest, raw, n_esc = tdr.encode_lanes(
        torch.from_numpy(values), torch.from_numpy(rows), tdev)
    lengths = lengths.numpy()
    words = tdr.assemble_streams(buf.numpy().view(np.uint16), lengths)
    return words, lengths, dest.numpy(), raw.numpy(), n_esc, buf


def _jax_encode(values, rows, jdev):
    buf, lengths, dest, raw, n_esc = jax.jit(lambda v, r: jdr.encode_lanes(v, r, jdev))(
        jnp.asarray(values), jnp.asarray(rows))
    ne = int(n_esc)
    lengths = np.asarray(lengths)
    words = jdr.assemble_streams(np.asarray(buf), lengths)
    return words, lengths, np.asarray(dest)[:ne], np.asarray(raw)[:ne], ne, np.asarray(buf)


def test_build_device_tables_matches_jax(tables):
    _, jdev, _, tdev = tables
    for name in ("lut2", "fc", "esc_sym", "offset", "eo"):
        got = getattr(tdev, name).numpy()
        want = np.asarray(getattr(jdev, name))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("esc", ["none", "some", "all"])
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("T", [1, 40])
def test_encode_matches_jax_and_numpy_oracle(tables, T, lanes, esc):
    jhost, jdev, _, tdev = tables
    values, rows = _payload(np.random.default_rng([T, lanes, len(esc)]), T, lanes, jhost, esc)
    words, lengths, dest, raw, n_esc, buf = _port_encode(values, rows, tdev)
    j_words, j_lengths, j_dest, j_raw, j_n, j_buf = _jax_encode(values, rows, jdev)
    o_words, o_lengths, o_dest, o_raw = jdr.np_encode(values, rows, jhost)
    for want in ((j_words, j_lengths, j_dest, j_raw), (o_words, o_lengths, o_dest, o_raw)):
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(lengths, want[1])
        np.testing.assert_array_equal(dest, want[2])
        np.testing.assert_array_equal(raw, want[3])
    assert n_esc == j_n == len(o_dest)
    assert words.dtype == np.uint16 and dest.dtype == np.int32 and raw.dtype == np.int32
    # the whole buffer, zeros past each lane's length included
    np.testing.assert_array_equal(buf.numpy().view(np.uint16), j_buf.astype(np.uint16))
    if esc == "none":
        assert n_esc == 0
    if esc == "all":
        assert n_esc == T * lanes


def _port_decode(words, lengths, rows, tdev, dest, raw):
    off = torch.from_numpy(tdr.lane_offsets(lengths))
    vals, _, _ = tdr.decode_lanes(torch.from_numpy(words.view(np.int16)), off,
                                  torch.from_numpy(rows), tdev)
    return tdr.fix_escapes(vals, torch.tensor(dest), torch.tensor(raw)).numpy()


def _jax_decode(words, lengths, rows, jdev, dest, raw):
    vals, _, _ = jax.jit(lambda w, o, r: jdr.decode_lanes(w, o, r, jdev))(
        jnp.asarray(words.astype(np.int32)), jnp.asarray(jdr.lane_offsets(lengths)),
        jnp.asarray(rows))
    return np.asarray(jdr.fix_escapes(vals, jnp.asarray(dest), jnp.asarray(raw)))


@pytest.mark.parametrize("esc", ["none", "some", "all"])
def test_port_decodes_jax_streams(tables, esc):
    jhost, jdev, _, tdev = tables
    values, rows = _payload(np.random.default_rng(len(esc)), 23, 17, jhost, esc)
    words, lengths, dest, raw, _, _ = _jax_encode(values, rows, jdev)
    np.testing.assert_array_equal(_port_decode(words, lengths, rows, tdev, dest, raw), values)


@pytest.mark.parametrize("esc", ["none", "some", "all"])
def test_jax_decodes_port_streams(tables, esc):
    jhost, jdev, _, tdev = tables
    values, rows = _payload(np.random.default_rng(10 + len(esc)), 23, 17, jhost, esc)
    words, lengths, dest, raw, _, _ = _port_encode(values, rows, tdev)
    np.testing.assert_array_equal(_jax_decode(words, lengths, rows, jdev, dest, raw), values)


def test_decode_continues_across_calls(tables):
    """Two calls with (state, ptr) carried decode what one call decodes:
    the ChARM slice loop continues each lane's stream per slice."""
    jhost, _, _, tdev = tables
    T, lanes, cut = 20, 3, 8
    values, rows = _payload(np.random.default_rng(5), T, lanes, jhost, "some")
    words, lengths, dest, raw, _, _ = _port_encode(values, rows, tdev)
    w = torch.from_numpy(words.view(np.int16))
    off = torch.from_numpy(tdr.lane_offsets(lengths))
    out1, state, ptr = tdr.decode_lanes(w, off, torch.from_numpy(rows[:cut]), tdev)
    out2, state2, ptr2 = tdr.decode_lanes(w, off, torch.from_numpy(rows[cut:]), tdev,
                                          state=state, ptr=ptr)
    _, state_all, ptr_all = tdr.decode_lanes(w, off, torch.from_numpy(rows), tdev)
    assert torch.equal(state2, state_all) and torch.equal(ptr2, ptr_all)
    assert torch.equal(ptr_all, torch.from_numpy(lengths))  # every word read
    first = dest < cut * lanes
    out1 = tdr.fix_escapes(out1, torch.from_numpy(dest[first]), torch.from_numpy(raw[first]))
    out2 = tdr.fix_escapes(out2, torch.from_numpy(dest[~first] - cut * lanes),
                           torch.from_numpy(raw[~first]))
    np.testing.assert_array_equal(torch.cat([out1, out2]).numpy(), values)


def test_rate_is_close_to_the_entropy(tables):
    """In-range symbols cost close to their entropy (16 bits a symbol
    would mean no compression): ``tests/test_device_rans.py``'s check."""
    jhost, _, _, tdev = tables
    T, lanes = 512, 8
    base = int(jhost.offset[0])
    spice = np.random.default_rng(6).random((T, lanes)) < 0.05
    values = np.where(spice, base + 1, base).astype(np.int32)
    _, lengths, _, _, _, _ = _port_encode(values, np.zeros((T, lanes), np.int32), tdev)
    cdf = jhost.quantized_cdf[0]
    p0, p1 = (cdf[1] - cdf[0]) / 65536.0, (cdf[2] - cdf[1]) / 65536.0
    ideal_bits = T * -(0.95 * np.log2(p0) + 0.05 * np.log2(p1))
    assert float(lengths.mean() - 2) * 16 < ideal_bits * 1.35 + 64


def test_cuda_wrappers_refuse_cpu_tensors(tables):
    _, _, _, tdev = tables
    rows = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdr.encode_lanes_cuda(rows, rows, tdev)
    with pytest.raises(ValueError, match="CUDA"):
        tdr.decode_lanes_cuda(torch.zeros(8, dtype=torch.int16),
                              torch.zeros(3, dtype=torch.int32), rows, tdev)


# --- the kernels' own tables: compact CDFs for the decode, reciprocals for
# the encode. The CUDA kernels run only on the card; here a numpy replay of
# the decode kernel's lookup and of the encode kernel's division is held
# against lut2 and integer division.
def _length3_tables():
    """The card fixture's kind of rows: two of one coded symbol (length 3),
    the rest 2 to 40."""
    rng = np.random.default_rng(0)
    supports = [1, 1] + [int(s) for s in rng.integers(2, 41, size=7)]
    cdf = np.zeros((len(supports), max(supports) + 2), np.int32)
    for r, n in enumerate(supports):
        pmf = rng.random(n).astype(np.float32) + 1e-3
        pmf = pmf / pmf.sum() * (1.0 - 2 ** -8)
        row = pmf_to_quantized_cdf_np(np.concatenate([pmf, [1.0 - pmf.sum()]]).astype(np.float32))
        cdf[r, : row.shape[0]] = row
    return EntropyTables(cdf, np.array(supports, np.int32) + 2,
                         rng.integers(-9, 3, size=len(supports)).astype(np.int32))


def _gaussian_tables():
    from icm_tpu_torch.entropy import gc_build_tables, get_scale_table

    return gc_build_tables(get_scale_table())


def _replay_compact_lookup(ctab: np.ndarray, r: int, peek: np.ndarray):
    """The decode kernel's lookup, in numpy: row record, index bucket,
    then the binary search in it -> (value, freq, start) for every peek."""
    words = ctab.view("<u2").astype(np.int64)
    meta = ctab[: 16 * (r + 1)].view("<i4").reshape(-1, 4)[r]
    cdf0, idx0, esc, k, offset = (int(meta[0]), int(meta[1]), int(meta[2]) & 0xFFFF,
                                  int(meta[2]) >> 16, int(meta[3]))
    b = peek >> (16 - k)
    lo, hi = words[idx0 + b], words[idx0 + b + 1]
    while np.any(lo < hi):
        go = lo < hi
        mid = (lo + hi + 1) >> 1
        le = words[cdf0 + np.where(go, mid, lo)] <= peek
        lo = np.where(go & le, mid, lo)
        hi = np.where(go & ~le, mid - 1, hi)
    c0, c1 = words[cdf0 + lo], words[cdf0 + lo + 1]
    value = np.where(lo == esc, tdr.ESC_VAL, lo + offset)
    return value, (c1 - c0) & 0xFFFF, peek - c0


@pytest.mark.parametrize("which", ["gaussian", "random", "length3"])
def test_compact_tables_give_lut2_answer_for_every_peek(which, tables):
    """For every (row, peek), index then search give lut2's (value, freq,
    start): the real Gaussian table (64 rows, lengths 5 to 3133), the
    module's random tables and rows of one coded symbol."""
    host = {"gaussian": _gaussian_tables, "random": lambda: tables[2],
            "length3": _length3_tables}[which]()
    dev = tdr.build_device_tables(host, "cpu")
    ctab = dev.ctab.numpy().view(np.uint8)
    assert ctab.size % 16 == 0
    lut2 = dev.lut2.numpy().view(np.uint32).reshape(host.num_distributions, 1 << 16, 2)
    peek = np.arange(1 << 16, dtype=np.int64)
    for r in range(host.num_distributions):
        value, freq, start = _replay_compact_lookup(ctab, r, peek)
        want = lut2[r].astype(np.int64)
        np.testing.assert_array_equal(value, (want[:, 0] ^ 0x8000) - 0x8000, err_msg=f"row {r}")
        np.testing.assert_array_equal(freq, want[:, 1] >> 16, err_msg=f"row {r}")
        np.testing.assert_array_equal(start, want[:, 1] & 0xFFFF, err_msg=f"row {r}")


def test_compact_tables_are_small():
    """The Gaussian table's compact form is a few hundred times smaller
    than its lut2 (33.6 MB) and fits a block's shared memory (an H100
    block may take 227 KB; 1 KB of it is left for the lanes)."""
    dev = tdr.build_device_tables(_gaussian_tables(), "cpu")
    nbytes = 4 * dev.ctab.numel()
    assert nbytes <= 232448 - 1024 and nbytes * 200 < 4 * dev.lut2.numel()


def test_compact_tables_refuse_a_row_they_cannot_search():
    host = _length3_tables()
    bad = host.quantized_cdf.copy()
    bad[2, host.cdf_length[2] - 1] = (1 << 16) - 1  # the row does not end at 2^16
    with pytest.raises(ValueError, match="row 2"):
        tdr.build_device_tables(EntropyTables(bad, host.cdf_length, host.offset), "cpu")


def test_reciprocals_divide_exactly():
    """x // f == (((x * m) >> 32) + x) >> shift for every f in 1 .. 65535,
    at the states f << 16 - 1, f - 1, f, 2^16 and 0, and at 64 seeded
    random states below f << 16 (the encoder divides only after its
    renormalisation has brought the state under f << 16)."""
    f = np.arange(1, 1 << 16, dtype=np.uint64)
    m = tdr.reciprocals(f)
    assert m.dtype == np.uint32
    # ceil(log2 f), as the kernel takes it: 32 - clz(f - 1)
    shift = np.array([int(v - 1).bit_length() for v in f], np.uint64)
    rng = np.random.default_rng(0)
    edges = np.stack([(f << np.uint64(16)) - np.uint64(1), f - np.uint64(1), f,
                      np.full_like(f, 1 << 16), np.zeros_like(f)], axis=1)
    rand = (rng.random((f.size, 64)) * (f << np.uint64(16))[:, None].astype(np.float64))
    x = np.concatenate([edges, rand.astype(np.uint64)], axis=1)
    assert int(x.max()) < 1 << 32
    m64, s64 = m.astype(np.uint64)[:, None], shift.astype(np.uint64)[:, None]
    q = (((x * m64) >> np.uint64(32)) + x) >> s64
    np.testing.assert_array_equal(q, x // f[:, None])


def test_device_tables_make_lut2_and_fc_at_first_use(tables):
    """A build puts on the device only what the kernels read; the plain
    versions' lut2 and fc are made at their first use, fc from fcr."""
    _, _, thost, _ = tables
    dev = tdr.build_device_tables(thost, "cpu")
    assert "lut2" not in vars(dev) and "fc" not in vars(dev)
    values, rows = _payload(np.random.default_rng(5), 6, 4, thost, "some")
    buf, lengths, _, _, _ = tdr.encode_lanes(torch.from_numpy(values), torch.from_numpy(rows),
                                             dev)
    assert "fc" in vars(dev) and "lut2" not in vars(dev)
    assert torch.equal(dev.fc, dev.fcr[..., 0])
    words = torch.from_numpy(tdr.assemble_streams(buf.numpy().view(np.uint16),
                                                  lengths.numpy()).view(np.int16))
    tdr.decode_lanes(words, torch.from_numpy(tdr.lane_offsets(lengths.numpy())),
                     torch.from_numpy(rows), dev)
    assert "lut2" in vars(dev) and dev.lut2 is dev.lut2
