"""The port's device wire (``DeviceWireCodec``, plain rANS versions on the
CPU) on the narrow WACNN twins, against the JAX package's device wire.

Same weights and input as ``test_torch_cnn_codec.py``: the port's round
trip is bit-exact at 4 lanes an image (4 pixels a lane, so the pixel and
channel interleave is exercised) and at 1024 (clamped to the 16 pixels of
the 4 x 4 latent); its y and z wires are byte-identical with the JAX
``DeviceWireCodec``'s; each side decodes the other's strings; its y_hat
equals the host wire's; a wire fed to the wrong decoder raises.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL, twins  # noqa: F401  (fixture)

from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu_torch import models as tmodels
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.models.device_codec import _unpack_wire


@pytest.fixture(scope="module")
def port_wire(twins):  # noqa: F811
    _, _, tm, x = twins
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=4)
    return codec, codec.compress(torch.from_numpy(x), return_debug=True)


@pytest.fixture(scope="module")
def jax_wire(twins):  # noqa: F811
    jm, variables, _, x = twins
    jc = JaxDeviceWireCodec(jm, variables, lanes_per_image=4)
    return jc, jc.compress(jnp.asarray(x), return_debug=True)


@pytest.mark.parametrize("lanes", [4, 1024])
def test_roundtrip_bitexact(twins, lanes):  # noqa: F811
    _, _, tm, x = twins
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=lanes)
    assert codec.kit.n_lanes(16, 16) == min(lanes, 256)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    assert len(enc["strings"][0]) == 2 and len(enc["strings"][1]) == 2
    assert all(_unpack_wire(b)[0].shape[0] == min(lanes, 16) for b in enc["strings"][0])
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert dec["x_hat"].shape == x.shape


@pytest.mark.parametrize("stream", ["y", "z"])
def test_wire_bytes_match_jax(port_wire, jax_wire, stream):
    _, enc = port_wire
    _, jenc = jax_wire
    k = "yz".index(stream)
    for b, (got, want) in enumerate(zip(enc["strings"][k], jenc["strings"][k])):
        n_diff = sum(p != q for p, q in zip(got, want)) + abs(len(got) - len(want))
        assert got == want, f"{stream} wire of image {b}: {n_diff} bytes differ"


def test_port_decodes_the_jax_wire(twins, port_wire, jax_wire):  # noqa: F811
    _, _, _, x = twins
    codec, _ = port_wire
    _, jenc = jax_wire
    dec = codec.decompress(jenc["strings"], jenc["shape"])
    np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)
    assert dec["x_hat"].shape == x.shape


def test_jax_decodes_the_port_wire(twins, port_wire, jax_wire):  # noqa: F811
    _, _, _, x = twins
    _, enc = port_wire
    jc, _ = jax_wire
    dec = jc.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(np.asarray(dec["y_hat"]),
                               enc["y_hat"].permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=CROSS_TOL)
    assert np.asarray(dec["x_hat"]).shape == x.shape


def test_y_hat_equals_the_host_wire(twins, port_wire):  # noqa: F811
    """Both wires run the same float code: the same y_hat bit for bit."""
    _, _, tm, x = twins
    _, enc = port_wire
    host = tmodels.CharmCodec(tm).compress(torch.from_numpy(x), return_debug=True)
    assert torch.equal(enc["y_hat"], host["y_hat"])
    assert torch.equal(enc["x_hat"], host["x_hat"])


def test_escape_heavy_roundtrip(twins):  # noqa: F811
    """Residuals scaled up 16 times: most symbols leave their tables and
    travel as escape pairs, and the round trip stays bit-exact."""
    _, _, tm, x = twins
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=4, narrow=16.0)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    n_esc = [_unpack_wire(b)[2].shape[0] for b in enc["strings"][0]]
    n_sym = enc["y_hat"][0].numel()
    assert min(n_esc) > n_sym // 10, (n_esc, n_sym)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])


def test_one_shot_gaussian_roundtrip(port_wire):
    """``encode_gaussian``/``decode_gaussian``: one Gaussian-coded tensor,
    4 lanes of 4 pixels, a tenth of its values escaping."""
    codec, _ = port_wire
    rng = np.random.default_rng(2)
    sym = rng.integers(-3, 4, size=(2, 5, 4, 4))
    sym = np.where(rng.random(sym.shape) < 0.1, rng.integers(-2 ** 31, 2 ** 31 - 1, sym.shape), sym)
    sym = torch.from_numpy(sym.astype(np.int32))
    index = torch.from_numpy(rng.integers(0, 64, size=sym.shape).astype(np.int32))
    blobs = codec.kit.encode_gaussian(sym, index)
    assert len(blobs) == 2 and _unpack_wire(blobs[0])[0].shape[0] == 4
    assert torch.equal(codec.kit.decode_gaussian(blobs, index), sym)


def test_wire_header_parses(port_wire):
    """Each image's wire says its lanes, words and escapes; the escape
    positions lie in the grid, ascending."""
    _, enc = port_wire
    for blob in enc["strings"][0]:
        lengths, words, dest, raw = _unpack_wire(blob)
        assert lengths.shape[0] == 4
        assert int(lengths.sum()) == words.shape[0]
        assert (lengths >= 2).all()
        assert dest.shape == raw.shape
        assert (np.diff(dest) > 0).all()


def _scan_tagged(blob: bytes) -> bytes:
    """The same payload under the scan wire's tag (and its tier byte)."""
    return blob[:3] + bytes([WIRE_SCAN, 0]) + blob[4:]


@pytest.mark.parametrize("case", ["host_into_device", "device_into_host", "scan_into_device"])
def test_wrong_wire_raises(twins, port_wire, case):  # noqa: F811
    _, _, tm, x = twins
    codec, enc = port_wire
    if case == "device_into_host":
        decoder, strings = tmodels.CharmCodec(tm), enc["strings"]
    elif case == "host_into_device":
        host = tmodels.CharmCodec(tm).compress(torch.from_numpy(x))
        decoder, strings = codec, host["strings"]
    else:
        decoder = codec
        strings = [[_scan_tagged(b) for b in s] for s in enc["strings"]]
        assert struct.unpack_from("<I", strings[0][0], 5)[0] == 4  # lanes after the tier
    with pytest.raises(WireFormatError):
        decoder.decompress(strings, enc["shape"])
