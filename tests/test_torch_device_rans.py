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
