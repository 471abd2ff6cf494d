"""Reference checkpoints of the masked family's ``stf2``, ``stf3`` and
``stf4``: the checks of ``test_torch_zoo.py`` at narrow widths with the
published depths (2, 2, 6, 2: the converters are written for them) and
each model's slices and mask window (stf3 and stf4: 8 and 4; stf2: 4 and
8, with its sliding window of 6).

The synthetic reference dict carries the reference's module names
(stf2.py, stf3.py, stf4.py: stf's ``patch_embed``, ``layers``,
``syn_layers``, ``end_conv``, ``h_a``, ``h_mean_s``, ``h_scale_s`` and
bottleneck; stf2's ``muContextModel.qkv``, ``sigmaContextModel.qkv``,
``cc_mean_transforms``, ``cc_scale_transforms``, ``lrp_transforms`` and
two of its forward-dead conv transforms' layers, ``g_a.0`` and ``g_s.0``; stf3's
``maskedContextModel_{mu,sigma}.context{i}`` / ``.norm{i}`` /
``.mlp{i}.fc1`` / ``.fc2``; stf4's ``maskedContextModel_mu.0.qkv``, its
never-called ``maskedContextModel_sigma.0.qkv``, ``cc_mean_transforms`` and
``cc_scale_transforms``; both models' ``lrp_transforms``), filled with
seeded values. Held: the JAX converter's tree has the JAX model's init
specs; the port's conversion equals ``from_jax_params`` of the JAX
conversion bit for bit and loads strictly; stf4's dead sigma context and
stf2's conv transforms are dropped; the stored tables import as the JAX
package imports them, and with them the host wire round-trips; the whole
family converts.
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_zoo import _RefDict, assert_same_state_dict, fill, init_specs, tree_specs

from icm_tpu import zoo as jzoo
from icm_tpu.models import models as jax_models
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.masked_codec import Stf2Codec, Stf3Codec

torch.set_num_threads(2)

# narrow widths, the published depths, slices and mask window: M = 64; stf3
# and stf4: 8 slices of 8, tokens of D = 128; stf2: 4 slices of 16, tokens
# of D = 1024
MASKED_NARROW = dict(embed_dim=8, depths=(2, 2, 6, 2), num_heads=(1, 2, 4, 8), window_size=4,
                     hyper_enc_widths=(64, 56, 48, 40, 32), hyper_dec_widths=(40, 48, 56, 64, 64))
NAMES = ["stf2", "stf3", "stf4"]


def masked_sd(name: str) -> _RefDict:
    c = MASKED_NARROW
    enc, dec = c["hyper_enc_widths"], c["hyper_dec_widths"]
    M = c["embed_dim"] * 8
    Cp = M // 8
    D = 16 * Cp
    sd = _RefDict()
    sd.swin_transforms(c["embed_dim"], c["depths"], c["num_heads"], c["window_size"])
    sd.hyper(M, enc, dec)
    sd.bottleneck(enc[-1])
    if name == "stf2":
        Cp, s = M // 4, 6
        D = 64 * Cp
        for tag in ("muContextModel", "sigmaContextModel"):
            sd.lin(f"{tag}.qkv", 3 * D, D)
        for tag, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0),
                           ("lrp_transforms", Cp)):
            for j, (o, i) in enumerate(zip((s * Cp, 15 * Cp, 8 * Cp, Cp),
                                           (2 * s * Cp + extra, s * Cp, 15 * Cp, 8 * Cp))):
                sd.conv(f"{tag}.{2 * j}", o, i, 3)
        # the conv transforms, which no forward runs
        sd.conv("g_a.0", 8, 3, 5)
        sd.conv("g_s.0", 3, 8, 5)
        return sd
    if name == "stf3":
        for tag in ("maskedContextModel_mu", "maskedContextModel_sigma"):
            for i in range(1, 6):
                sd.lin(f"{tag}.context{i}.qkv", 3 * D, D)
                sd.ln(f"{tag}.norm{i}", D)
                sd.lin(f"{tag}.mlp{i}.fc1", 2 * D, D)
                sd.lin(f"{tag}.mlp{i}.fc2", D, 2 * D)
    else:
        w = 27
        for tag in ("maskedContextModel_mu", "maskedContextModel_sigma"):
            sd.lin(f"{tag}.0.qkv", 3 * D, D)
        for tag in ("cc_mean_transforms", "cc_scale_transforms"):
            for j, (o, i) in enumerate(zip((w * Cp, 15 * Cp, 8 * Cp, Cp),
                                           (2 * w * Cp, w * Cp, 15 * Cp, 8 * Cp))):
                sd.conv(f"{tag}.{2 * j}", o, i, 3)
    for j, (o, i) in enumerate(zip((2 * M, M, M, M), (M + 2 * dec[-1], 2 * M, M, M))):
        sd.conv(f"lrp_transforms.{2 * j}", o, i, 3)
    return sd


@functools.lru_cache(maxsize=None)
def converted(name: str):
    """-> (the filled reference dict, the JAX conversion, the port's)."""
    sd = fill(masked_sd(name), seed=len(name) + 7)
    return (sd, jzoo.convert_masked_ctx_checkpoint(sd, name),
            tzoo.convert_reference_state_dict(name, sd))


@pytest.mark.parametrize("name", NAMES)
def test_converter_tree_matches_init(name):
    jcls, jkw = jax_models[name]
    want = init_specs(jcls(**{**jkw, **MASKED_NARROW}))
    got = tree_specs(converted(name)[1])
    assert got == want, (sorted(set(want) - set(got))[:5], sorted(set(got) - set(want))[:5])


@pytest.mark.parametrize("name", NAMES)
def test_port_conversion_matches_jax(name):
    _, jax_tree, port = converted(name)
    assert_same_state_dict(port, from_jax_params(jax_tree))
    assert_same_state_dict(tzoo.convert_masked_ctx_checkpoint(converted(name)[0], name), port)


@pytest.mark.parametrize("name", NAMES)
def test_port_conversion_loads_strictly(name):
    model = tmodels.create_model(name, device="cpu", **MASKED_NARROW)
    port = converted(name)[2]
    model.load_state_dict(port, strict=True)
    assert all(torch.equal(p, port[k]) for k, p in model.state_dict().items())


def test_stf4_dead_sigma_context_is_dropped():
    sd, _, port = converted("stf4")
    assert any(k.startswith("maskedContextModel_sigma.") for k in sd)
    assert not any(k.startswith("maskedContextModel_sigma.") for k in port)
    assert any(k.startswith("cc_scale_head.") for k in port)


def test_stf2_dead_conv_transforms_are_dropped():
    sd, _, port = converted("stf2")
    assert {"g_a.0.weight", "g_s.0.weight"} <= set(sd)
    assert not any(k.startswith(("g_a.0.", "g_s.0.")) for k in port)
    assert any(k.startswith("g_a.layer0.") for k in port)


def test_only_stf2_of_the_family_is_refused():
    """Once the family's one refused name: now none of it is refused (nor is
    czigzag: the one refused name is stf10, which cnn2, oj_ICM and
    seg_oj_ICM leave), and the family's converter names its members for any
    other."""
    assert not {"stf2", "stf3", "stf4", "czigzag", "cnn2", "oj_ICM", "seg_oj_ICM"} & set(
        tzoo._NOT_PORTED)
    assert set(tzoo._NOT_PORTED) == {"stf10"}
    assert tzoo.convert_reference_state_dict("stf2", converted("stf2")[0]).keys() == \
        converted("stf2")[2].keys()
    with pytest.raises(ValueError, match="stf2"):
        tzoo.convert_masked_ctx_checkpoint({}, "oj_ICM")


@pytest.mark.parametrize("name", NAMES)
def test_stored_tables_serve_the_host_wire(name):
    """A reference dict with the bottleneck's and the Gaussian's CDF
    buffers: the tables import as the JAX package imports them, and the
    converted model (stf4 built with ``causal=True``, which its codec
    needs: the same parameters) serves the host wire with them, round
    trip bit for bit."""
    sd, _, port = converted(name)
    model = tmodels.create_model(name, device="cpu", **MASKED_NARROW,
                                 **({"causal": True} if name == "stf4" else {}))
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
    for got, want in ((tables.gaussian, jt.gaussian),
                      (tables.bottlenecks["entropy_bottleneck"], jt.bottlenecks["entropy_bottleneck"])):
        for field in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(tables.scale_table, np.asarray(jt.scale_table))
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    codec = (Stf2Codec if name == "stf2" else Stf3Codec)(model, tables=tables)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    dec = codec.decompress(enc["strings"], *(enc[k] for k in codec.DECOMPRESS_KEYS))
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert int(codec.symbols(torch.from_numpy(x)).count_nonzero()) > 0
