"""icm_tpu_torch entropy models and host rANS against the JAX package.

The port builds its own copy of rans.cpp; its streams must be
byte-identical to ``icm_tpu.coding``'s and decode back. CDF tables must
be identical: the Gaussian scale tables are built from the same numpy
and scipy code, the bottleneck tables from the port's own density MLP.
"""

import ast
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu import coding as jcoding
from icm_tpu import entropy as jent
from icm_tpu import ops as jops
from icm_tpu.coding import wire as jwire
from icm_tpu_torch import coding as tcoding
from icm_tpu_torch import entropy as tent
from icm_tpu_torch import ops as tops
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def gaussian_tables():
    table = tent.get_scale_table()
    np.testing.assert_array_equal(table, jent.get_scale_table())
    return tent.gc_build_tables(table), jent.gc_build_tables(table)


def test_gaussian_tables_identical(gaussian_tables):
    port, ref = gaussian_tables
    np.testing.assert_array_equal(port.quantized_cdf, ref.quantized_cdf)
    np.testing.assert_array_equal(port.cdf_length, ref.cdf_length)
    np.testing.assert_array_equal(port.offset, ref.offset)
    np.testing.assert_array_equal(port.symbol_lut(), ref.symbol_lut())


def _symbols(tables, B, N, seed, spread):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, tables.num_distributions, (B, N)).astype(np.int32)
    # spread > the table's support exercises the bypass escapes
    sym = np.round(rng.standard_normal((B, N)) * spread).astype(np.int32)
    return sym, idx


@pytest.mark.parametrize("spread", [1.0, 40.0])
def test_rans_bytes_identical_and_decode(gaussian_tables, spread):
    port, _ = gaussian_tables
    sym, idx = _symbols(port, 3, 2000, seed=int(spread), spread=spread)
    args = (port.quantized_cdf, port.cdf_length, port.offset)
    streams = tcoding.encode_batch(sym, idx, *args)
    assert streams == jcoding.encode_batch(sym, idx, *args)
    # decode in two AR-style calls, as the codec's slice loop does
    dec = tcoding.BatchRansDecoder(streams)
    lut = port.symbol_lut()
    first = dec.decode_stream(idx[:, :1200], *args, lut=lut)
    rest = dec.decode_stream(idx[:, 1200:], *args, lut=lut)
    np.testing.assert_array_equal(np.concatenate([first, rest], 1), sym)
    # the JAX package's decoder reads the port's streams too
    np.testing.assert_array_equal(
        jcoding.decode_batch(streams, idx, *args), sym)


def test_cdf_rows_native_matches_numpy():
    rng = np.random.default_rng(5)
    lens = rng.integers(3, 30, 12).astype(np.int32)
    pmf = rng.random((12, 30)).astype(np.float32)
    pmf /= pmf.sum(1, keepdims=True) * 1.01
    tail = np.full(12, 0.0099, np.float32)
    rows = tent.pmf_to_cdf_rows(pmf, tail, lens)
    for i, L in enumerate(lens):
        row = tent.pmf_to_quantized_cdf_np(np.append(pmf[i, :L], tail[i]))
        np.testing.assert_array_equal(rows[i, : L + 2], row)
        np.testing.assert_array_equal(
            row, jent.pmf_to_quantized_cdf_np(np.append(pmf[i, :L], tail[i])))


@pytest.fixture(scope="module")
def bottlenecks():
    C = 16
    x = np.random.default_rng(0).standard_normal((2, 4, 4, C)).astype(np.float32) * 3
    m = jent.EntropyBottleneck(C)
    params = m.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                    jnp.asarray(x))["params"]
    rng = np.random.default_rng(1)
    # a trained-looking density: perturbed weights, spread quantiles
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(params))
    params["quantiles"] = params["quantiles"] * np.float32(0.7)
    port = tent.EntropyBottleneck(C)
    sd = from_jax_params({"eb": params})
    port.load_state_dict({k[3:]: v for k, v in sd.items()}, strict=True)
    return m, params, port.eval(), x


def test_bottleneck_likelihood(bottlenecks):
    m, params, port, x = bottlenecks
    _, ref = m.apply({"params": params}, jnp.asarray(x), training=False)
    with torch.no_grad():
        _, lik = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    # f32 density MLP, same ops in another order: relative to O(0.1) values
    np.testing.assert_allclose(lik.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_bottleneck_tables_identical(bottlenecks):
    m, params, port, _ = bottlenecks
    ref = jent.eb_build_tables(m, {"params": params})
    got = tent.eb_tables_from_pmf_data(*port.pmf_data())
    np.testing.assert_array_equal(got.cdf_length, ref.cdf_length)
    np.testing.assert_array_equal(got.offset, ref.offset)
    np.testing.assert_array_equal(got.quantized_cdf, ref.quantized_cdf)


def test_gaussian_likelihood_and_indexes():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 6, 5, 4)).astype(np.float32) * 4
    mu = rng.standard_normal(y.shape).astype(np.float32)
    scale = np.abs(rng.standard_normal(y.shape)).astype(np.float32) * 10
    _, ref = jent.GaussianConditional().apply({}, jnp.asarray(y), jnp.asarray(scale),
                                              jnp.asarray(mu), training=False)
    t = torch.from_numpy
    _, lik = tent.GaussianConditional()(t(y), t(scale), t(mu))
    np.testing.assert_allclose(lik.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    table = tent.get_scale_table()
    np.testing.assert_array_equal(
        tent.build_indexes(t(scale), t(table)).numpy(),
        np.asarray(jent.build_indexes(jnp.asarray(scale), table)))


def test_ops_match_jax():
    x = np.linspace(-2, 2, 41).astype(np.float32)
    g = np.where(np.arange(41) % 2, 1.0, -1.0).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tops.lower_bound(tx, 0.5)
    out.backward(torch.from_numpy(g))
    ref, vjp = jax.vjp(lambda a: jops.lower_bound(a, jnp.float32(0.5)), jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(tops.ste_round(torch.from_numpy(halves)).numpy(),
                                  np.asarray(jops.ste_round(jnp.asarray(halves))))
    p, jp = tops.NonNegativeParametrizer(1e-6), jops.NonNegativeParametrizer(1e-6)
    v = np.abs(x) + 0.01
    np.testing.assert_allclose(p(p.init(torch.from_numpy(v))).numpy(),
                               np.asarray(jp(jp.init(jnp.asarray(v)))), rtol=1e-6)


def test_host_decoder_rejects_tagged_streams():
    n_lanes, n_words, n_esc = 2, 3, 1
    payload = struct.pack("<III", n_lanes, n_words, n_esc)
    blob = (jwire.WIRE_MAGIC + bytes([jwire.WIRE_DEVICE]) + payload
            + b"\0" * (2 * n_lanes + 2 * n_words + 8 * n_esc))
    assert jwire.looks_like_framework_wire(blob) == jwire.WIRE_DEVICE
    assert tcoding.wire.looks_like_framework_wire(blob) == jwire.WIRE_DEVICE
    with pytest.raises(tcoding.WireFormatError):
        tcoding.BatchRansDecoder([blob])


def test_rans_source_is_the_jax_packages_code():
    """The copy differs only in its leading comment."""
    def code(path):
        text = path.read_text()
        return text[text.index("#include"):]

    assert code(REPO / "icm_tpu_torch/csrc/rans.cpp") == code(
        REPO / "icm_tpu/coding/cpp/rans.cpp")


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "icm_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SCANNED = sorted(
    [p.relative_to(REPO).as_posix() for p in (REPO / "icm_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "tools/torch_profile_codec.py", "tools/torch_ab_rans.py",
       "tools/torch_sweep_rans.py", "tools/torch_ab_gdn.py", "tools/torch_smoke_models.py",
       "tools/probe_stf2_narrow.py", "tools/probe_czigzag_narrow.py",
       "tools/torch_mma_peak.py"])


def test_import_scan_covers_the_port_modules():
    """Every module of the package is scanned, the reference-checkpoint,
    zigzag-family, CRC-family, masked-family, czigzag and cnn2 ones among
    them (the scan wires and stacked weights too, stf2's token scan,
    czigzag's codec, cnn2's task networks and detection evaluators, the two
    probes and the tensor-core rate probe)."""
    for path in ("icm_tpu_torch/zoo.py", "icm_tpu_torch/scan/zigzag.py",
                 "icm_tpu_torch/models/stf_family.py", "icm_tpu_torch/models/codec.py",
                 "icm_tpu_torch/models/scan_codec.py", "icm_tpu_torch/convert.py",
                 "icm_tpu_torch/graphs.py", "icm_tpu_torch/nn/factories.py",
                 "icm_tpu_torch/models/zigzag_coder.py", "icm_tpu_torch/models/crc.py",
                 "icm_tpu_torch/models/crc_codec.py", "icm_tpu_torch/models/masked_ctx.py",
                 "icm_tpu_torch/models/masked_codec.py", "icm_tpu_torch/models/czigzag.py",
                 "icm_tpu_torch/models/icm.py", "icm_tpu_torch/tasks/anchors.py",
                 "icm_tpu_torch/tasks/resnet.py", "icm_tpu_torch/tasks/fpn.py",
                 "icm_tpu_torch/tasks/retinanet.py", "icm_tpu_torch/tasks/losses.py",
                 "icm_tpu_torch/eval/metrics.py",
                 "tools/torch_smoke_models.py", "tools/probe_stf2_narrow.py",
                 "tools/probe_czigzag_narrow.py", "tools/torch_mma_peak.py"):
        assert path in SCANNED


@pytest.mark.parametrize("path", SCANNED)
def test_port_imports_nothing_of_jax_or_icm_tpu(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"
