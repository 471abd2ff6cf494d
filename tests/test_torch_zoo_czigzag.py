"""Reference checkpoints of ``czigzag``: the checks of ``test_torch_zoo.py``
at narrow widths with the published depths (2, 2, 6, 2; hyper (2, 6)) and
context (4 slices x 2x2 = 16 steps, support 6 and windows of 6): the
converters are written for them.

The synthetic reference dict carries the reference's module names
(czigzag.py: ``patch_embed``, the cross Swin stages ``layers`` /
``syn_layers`` with ``attn.q`` / ``attn.kv``, the pyramids
``encoder_context`` / ``hyper_context``, the hyper stacks
``hyper_encoder_layers`` / ``hyper_decoder_{mean,scale}`` and their
convolutions, ``end_conv``, the ``*_transforms2`` context stacks and the
bottleneck) and the modules its forward never runs (``patch_embed_up``,
``decoder_context``, each pyramid's fourth conv, a ``mu_Swin2`` refiner,
the conv hyper-codec ``h_a``), filled with seeded values. Held: the JAX
converter's tree has the JAX model's init specs; the port's conversion
equals ``from_jax_params`` of the JAX conversion bit for bit and loads
strictly; the dead modules are dropped and ``decoder_context_{i}`` take
``hyper_context.{i}``'s weights; the stored tables import as the JAX
package imports them, and with them the host wire round-trips.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_zoo import _RefDict, assert_same_state_dict, fill, tree_specs

from icm_tpu import zoo as jzoo
from icm_tpu.models import models as jax_models
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc_codec import CzigzagCodec

torch.set_num_threads(2)

# narrow widths, the published depths and context: M = 64, 16 slices of 16
CZ_NARROW = dict(embed_dim=8, num_heads=(1, 2, 4, 8), cc_widths=(24, 20, 16, 12))


def _cross_blocks(sd: _RefDict, prefix: str, dim: int, depth: int, heads: int, ws: int = 4):
    for j in range(depth):
        b = f"{prefix}.blocks.{j}"
        sd.ln(f"{b}.norm1", dim)
        sd.lin(f"{b}.attn.q", dim, dim)
        sd.lin(f"{b}.attn.kv", 2 * dim, dim)
        sd.lin(f"{b}.attn.proj", dim, dim)
        sd[f"{b}.attn.relative_position_bias_table"] = np.zeros(((2 * ws - 1) ** 2, heads),
                                                                np.float32)
        sd[f"{b}.attn.relative_position_index"] = np.zeros((ws * ws, ws * ws), np.float32)
        sd.ln(f"{b}.norm2", dim)
        sd.lin(f"{b}.mlp.fc1", 4 * dim, dim)
        sd.lin(f"{b}.mlp.fc2", dim, 4 * dim)


def czigzag_sd() -> _RefDict:
    e, heads, cc = CZ_NARROW["embed_dim"], CZ_NARROW["num_heads"], CZ_NARROW["cc_widths"]
    depths, n = (2, 2, 6, 2), 4
    M, sc, cond = 8 * e, e * 2, 6 * e * 2
    sd = _RefDict()
    for p in ("patch_embed", "patch_embed_up"):  # the second: dead
        sd.conv(f"{p}.proj", e, 3, 2)
        sd.ln(f"{p}.norm", e)
    for i in range(n):
        dim, rdim = e * 2 ** i, e * 2 ** (n - 1 - i)
        _cross_blocks(sd, f"layers.{i}", dim, depths[i], heads[i])
        _cross_blocks(sd, f"syn_layers.{i}", rdim, depths[n - 1 - i], heads[n - 1 - i])
        if i < n - 1:
            sd.lin(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            sd.ln(f"layers.{i}.downsample.norm", 4 * dim)
            sd.lin(f"syn_layers.{i}.downsample.reduction", 2 * rdim, rdim, bias=False)
            sd.ln(f"syn_layers.{i}.downsample.norm", rdim)
        for tag in ("encoder_context", "hyper_context", "decoder_context"):  # the 4th: dead
            sd.conv(f"{tag}.{i}", 2 * dim, dim, 3)
    _cross_blocks(sd, "hyper_encoder_layers.0", M, 2, 4)
    _cross_blocks(sd, "hyper_encoder_layers.1", M // 2, 6, 4)
    sd.conv("hyper_encoder_Conv1", M // 2, M, 3)
    sd.conv("hyper_encoder_Conv1_2", M // 2, M, 3)
    sd.conv("hyper_encoder_Conv2", M // 2, M // 2, 3)
    for tag in ("mean", "scale"):
        _cross_blocks(sd, f"hyper_decoder_{tag}.0", M // 2, 2, 4)
        _cross_blocks(sd, f"hyper_decoder_{tag}.1", M, 6, 4)
        sd.conv(f"hyper_decoder_conv_{tag}1.0", 2 * M, M // 2, 3)
        sd.conv(f"hyper_decoder_conv_{tag}2", M, M // 2, 3)
    sd.conv("end_conv.0", 4 * e, e, 5)
    sd.conv("end_conv.2", 3, e, 3)
    for i in range(16):
        for tag, extra in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                           ("lrp_transforms2", sc)):
            cin = [2 * cond + sc * min(i, 6) + extra] + list(cc)
            for j in range(4):
                sd.conv(f"{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            sd.conv(f"{tag}.{i}.8", sc, cc[-1], 3)
    sd.bottleneck(M // 2)
    # dead: a never-called refiner and the stale coder's conv hyper-codec
    _cross_blocks(sd, "mu_Swin2.0.0", sc, 1, 4)
    sd.conv("h_a.0", M, M, 3)
    return sd


@functools.lru_cache(maxsize=None)
def converted():
    """-> (the filled reference dict, the JAX conversion, the port's)."""
    sd = fill(czigzag_sd(), seed=17)
    return sd, jzoo.convert_czigzag_checkpoint(sd), tzoo.convert_reference_state_dict("czigzag",
                                                                                      sd)


def test_converter_tree_matches_init():
    jcls, jkw = jax_models["czigzag"]
    jm = jcls(**{**jkw, **CZ_NARROW})
    x = jnp.zeros((1, 64, 64, 3))
    want = tree_specs(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, x, x,
        training=False))["params"])
    got = tree_specs(converted()[1])
    assert got == want, (sorted(set(want) - set(got))[:5], sorted(set(got) - set(want))[:5])


def test_port_conversion_matches_jax():
    sd, jax_tree, port = converted()
    assert_same_state_dict(port, from_jax_params(jax_tree))
    assert_same_state_dict(tzoo.convert_czigzag_checkpoint(sd), port)


def test_port_conversion_loads_strictly():
    model = tmodels.create_model("czigzag", device="cpu", **CZ_NARROW)
    port = converted()[2]
    model.load_state_dict(port, strict=True)
    assert all(torch.equal(p, port[k]) for k, p in model.state_dict().items())


def test_dead_reference_groups_are_dropped():
    """The modules the reference forward never runs are dropped, and the
    decoder's pyramid takes the hyper pyramid's weights (its forward
    applies ``hyper_context`` to both)."""
    sd, _, port = converted()
    for dead in ("patch_embed_up.", "decoder_context.", "mu_Swin2.", "h_a."):
        assert any(k.startswith(dead) for k in sd) and not any(k.startswith(dead) for k in port)
    assert not any(k.startswith(("encoder_context_3", "hyper_context_3", "decoder_context_3"))
                   for k in port)
    for i in range(3):
        for leaf in ("weight", "bias"):
            assert torch.equal(port[f"decoder_context_{i}.{leaf}"],
                               port[f"hyper_context_{i}.{leaf}"])
            assert not np.array_equal(sd[f"decoder_context.{i}.{leaf}"],
                                      sd[f"hyper_context.{i}.{leaf}"])


def test_stored_tables_serve_the_host_wire():
    """A reference dict with the bottleneck's and the Gaussian's CDF
    buffers: the tables import as the JAX package imports them, and the
    converted model serves the host wire with them (x and up_x4), round
    trip bit for bit."""
    sd, _, port = converted()
    model = tmodels.create_model("czigzag", device="cpu", **CZ_NARROW)
    model.load_state_dict(port, strict=True)
    built = tmodels.build_codec_tables(model)
    stored = dict(sd)
    for prefix, t in (("gaussian_conditional", built.gaussian), *built.bottlenecks.items()):
        stored[f"{prefix}._quantized_cdf"] = t.quantized_cdf
        stored[f"{prefix}._cdf_length"] = t.cdf_length
        stored[f"{prefix}._offset"] = t.offset
    stored["gaussian_conditional.scale_table"] = built.scale_table
    tables = tzoo.import_reference_tables(stored)
    jt = jzoo.import_reference_tables(stored)
    assert set(tables.bottlenecks) == set(jt.bottlenecks) == {"entropy_bottleneck"}
    eb = "entropy_bottleneck"
    for got, want in ((tables.gaussian, jt.gaussian), (tables.bottlenecks[eb], jt.bottlenecks[eb])):
        for field in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(tables.scale_table, np.asarray(jt.scale_table))
    rng = np.random.default_rng(2)
    x, up = (torch.from_numpy(rng.random((1, 64, 64, 3)).astype(np.float32)) for _ in range(2))
    codec = CzigzagCodec(model, tables=tables)
    enc = codec.compress(x, up, return_debug=True)
    dec = codec.decompress(enc["strings"], enc["shape"], up)
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert sum(int(s.count_nonzero()) for s in codec.symbols(x, up)["y_hat"]) > 0
