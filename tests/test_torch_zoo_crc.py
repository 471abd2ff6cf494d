"""Reference checkpoints of the CRC family (``stf9``, ``stf11``, ``stf12``,
``stf13``, ``stf14``):
the checks of ``test_torch_zoo.py`` at narrow widths with the published
slices (6 x 2x2 zigzag = 24, sliding support 12, a conditioning window of
24 blocks, 5-conv context stacks; stf13's 3-conv).

The synthetic reference dict carries the reference's module names
(stf9.py, stf12.py, stf14.py: the machine layer's ``g_a`` and inline
coder with its ``cc_*_transforms2`` and ``lrp_transforms2`` stacks,
``g_s1``, ``g_s2``, the human hyperprior; stf9's and stf14's
``human_g_s2``, ``human_g_a``, ``human_g_s`` and ``human_context_decoder``;
stf12's ``human_g_enc2`` / ``human_g_enc3`` conditioning decoders, its
two-stage ``human_g_a1`` / ``_a2`` / ``_s1`` / ``_s2`` and its two context
decoders; stf13's (stf13.py) ``g_s``, the segmentation layer with its
``seg_``-prefixed coder, the four conditioning decoders, the mask nets and
the rest of its human layer, both coders' ``lrp_transforms2``, which it
applies, and the split decoder ``g_s1`` / ``g_s2`` it never runs),
filled with seeded values. Held: the JAX converter's tree has the JAX
model's init specs; the port's conversion equals ``from_jax_params`` of
the JAX conversion bit for bit (for stf13 also of the JAX conversion's
``scan_charm`` tree, both coders stacked) and loads strictly; the dead
groups are dropped; the stored tables of every bottleneck import, and
with them the host wire round-trips in both symbol orders; the
architectures not ported yet are refused by their queue items.
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_zoo import (_RefDict, _win_noshift, assert_same_state_dict, fill, init_specs,
                            tree_specs)

from icm_tpu import zoo as jzoo
from icm_tpu.models import models as jax_models
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc_codec import CRC3Codec, CRCCodec

torch.set_num_threads(2)

# narrow widths, the published slices and context (the converters are
# written for 24 slices of 5-conv stacks)
CRC_NARROW = dict(N=16, M=24, mid=32, num_slices=6, max_support=12, support_num=24,
                  hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(14, 16, 20, 24, 24),
                  cc_widths=(16, 12, 12, 8))
NAMES = ["stf9", "stf11", "stf12", "stf13", "stf14"]
# stf13's 3-conv context stacks
STF13_NARROW = {**CRC_NARROW, "cc_widths": (16, 8)}


def narrow(name: str) -> dict:
    return STF13_NARROW if name == "stf13" else CRC_NARROW


def _hyper_dec(sd, prefix, z, dec, extra=0):
    sd.conv(f"{prefix}.0", dec[0], z, 3)
    sd.conv(f"{prefix}.2.0", dec[1] * 4, dec[0], 3)
    sd.conv(f"{prefix}.4", dec[2], dec[1], 3)
    sd.conv(f"{prefix}.6.0", dec[3] * 4, dec[2], 3)
    sd.conv(f"{prefix}.8", dec[4], dec[3], 3)
    for j in range(extra):
        sd.conv(f"{prefix}.{10 + 2 * j}", dec[4], dec[4], 3)


def _bottleneck(sd, prefix, C):
    sd[f"{prefix}.quantiles"] = np.zeros((C, 1, 3), np.float32)
    fdims = (1, 3, 3, 3, 3, 1)
    for i in range(5):
        sd[f"{prefix}._matrix{i}"] = np.zeros((C, fdims[i + 1], fdims[i]), np.float32)
        sd[f"{prefix}._bias{i}"] = np.zeros((C, fdims[i + 1], 1), np.float32)
        if i < 4:
            sd[f"{prefix}._factor{i}"] = np.zeros((C, fdims[i + 1], 1), np.float32)


def _decoder(sd, prefix, N, M, mid, part=None):
    if part != 2:
        _win_noshift(sd, f"{prefix}.0", M, 8, 4)
        sd.deconv(f"{prefix}.1", M, N, 5)
        sd.gdn(f"{prefix}.2", N)
        sd.deconv(f"{prefix}.3", N, mid, 5)
        sd.gdn(f"{prefix}.4", mid)
        _win_noshift(sd, f"{prefix}.5", mid, 8, 8)
    if part != 1:
        o = 0 if part == 2 else 6
        sd.deconv(f"{prefix}.{o}", mid, N, 5)
        sd.gdn(f"{prefix}.{o + 1}", N)
        sd.deconv(f"{prefix}.{o + 2}", N, 3, 5)


def _coder(sd, c, prefix: str = "") -> None:
    """An inline zigzag coder: its hyper-encoder and decoders and its
    ``cc_*_transforms2`` and ``lrp_transforms2`` stacks (``len(cc) + 1``
    convs a slice)."""
    M, enc, dec, cc = c["M"], c["hyper_enc_widths"], c["hyper_dec_widths"], c["cc_widths"]
    widths = [M] + list(enc)
    for i in range(5):
        sd.conv(f"{prefix}h_a.{2 * i}", enc[i], widths[i], 3)
    for tag in ("h_mean_s", "h_scale_s"):
        _hyper_dec(sd, f"{prefix}{tag}", enc[-1], dec)
    sc, n = M // c["num_slices"], 4 * c["num_slices"]
    for i in range(n):
        for tag, extra in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                           ("lrp_transforms2", sc)):
            cin = [c["support_num"] * sc + sc * min(i, c["max_support"]) + extra] + list(cc)
            for j in range(len(cc)):
                sd.conv(f"{prefix}{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            sd.conv(f"{prefix}{tag}.{i}.{2 * len(cc)}", sc, cc[-1], 3)


def _context_scale2(sd, prefix, N, M):
    _win_noshift(sd, f"{prefix}.0", M, 8, 4)
    sd.deconv(f"{prefix}.1", M, N, 3)
    sd.gdn(f"{prefix}.2", N)
    sd.deconv(f"{prefix}.3", N, N, 3)


def stf13_sd() -> _RefDict:
    """stf13.py's names at ``STF13_NARROW``'s widths: the machine layer
    (``g_a``, the coder with LRP, ``g_s``, and the split decoder the
    reference builds and never runs), the segmentation layer and the human
    layer of the module docstring."""
    c = STF13_NARROW
    N, M, mid = c["N"], c["M"], c["mid"]
    enc, dec = c["hyper_enc_widths"], c["hyper_dec_widths"]
    sd = _RefDict()
    _g_a(sd, N, M)
    _coder(sd, c)
    _coder(sd, c, "seg_")
    for j, (o, i) in enumerate(zip(enc, [M] + list(enc))):
        sd.conv(f"human_h_a.{2 * j}", o, i, 3)
    for tag in ("human_h_mean_s_2", "human_h_scale_s_2"):
        sd.conv(f"{tag}.0", dec[0], enc[-1], 3)
        sd.deconv(f"{tag}.2", dec[0], dec[1], 3)
        sd.deconv(f"{tag}.4", dec[1], dec[-1], 3)
    for prefix in ("entropy_bottleneck", "entropy_bottleneck_seg", "entropy_bottleneck_human"):
        _bottleneck(sd, prefix, enc[-1])
    for prefix in ("g_s", "seg_g_enc2", "seg_g_s", "human_g_enc2", "human_g_enc4"):
        _decoder(sd, prefix, N, M, mid)
    _decoder(sd, "g_s1", N, M, mid, part=1)
    _decoder(sd, "g_s2", N, M, mid, part=2)
    for prefix in ("seg_g_enc3", "human_g_enc3", "human_g_enc5"):
        _context_scale2(sd, prefix, N, M)
    for prefix in ("human_context_decoder", "human_context_decoder3"):
        sd.conv(f"{prefix}.0", M, M, 3)
        sd.conv(f"{prefix}.2", M, M, 3)
    sd.conv("seg_g_a1.0", N, 6, 3)
    sd.conv("seg_g_a1.2", N, N, 3)
    sd.conv("seg_g_a2.0", N, 2 * N, 5)
    sd.conv("seg_g_a2.2", M, N, 5)
    _win_noshift(sd, "seg_g_a2.4", M, 8, 4)
    sd.conv("human_g_a1_2.0", N, 9, 3)
    sd.conv("human_g_a1_2.2", N, N, 3)
    sd.conv("human_g_a2_2.0", N, 3 * N, 5)
    sd.conv("human_g_a2_2.2", M, N, 5)
    for prefix, (i0, widths) in (("generate_mask_scale1", (6, (12, 12, 9))),
                                 ("generate_mask_scale2", (2 * N, (4 * N, 4 * N, 3 * N)))):
        for j, (o, i) in enumerate(zip(widths, (i0,) + widths)):
            sd.conv(f"{prefix}.{2 * j}", o, i, 3)
    for prefix in ("human_context_decoder2_2", "human_context_decoder4"):
        sd.conv(f"{prefix}.0", N, M, 3)
        sd.deconv(f"{prefix}.2", N, N, 3)
        sd.deconv(f"{prefix}.4", N, N, 3)
    sd.deconv("human_g_s1_2.0", 3 * M, N, 3)
    sd.deconv("human_g_s1_2.2", N, N, 3)
    sd.deconv("human_g_s2_2.0", 3 * N, N, 3)
    sd.conv("human_g_s2_2.2", N, N, 3)
    sd.deconv("human_g_s2_2.4", N, 3, 3)
    return sd


def _g_a(sd, N, M):
    sd.conv("g_a.0", N, 3, 5)
    sd.gdn("g_a.1", N)
    sd.conv("g_a.2", N, N, 5)
    sd.gdn("g_a.3", N)
    _win_noshift(sd, "g_a.4", N, 8, 8)
    sd.conv("g_a.5", N, N, 5)
    sd.gdn("g_a.6", N)
    sd.conv("g_a.7", M, N, 5)
    _win_noshift(sd, "g_a.8", M, 8, 4)


def crc_sd(name: str) -> _RefDict:
    """Reference stf9 / stf12 / stf14 names at ``CRC_NARROW``'s widths
    (stf13's: :func:`stf13_sd`)."""
    if name == "stf13":
        return stf13_sd()
    c = CRC_NARROW
    N, M, mid = c["N"], c["M"], c["mid"]
    enc, dec, cc = c["hyper_enc_widths"], c["hyper_dec_widths"], c["cc_widths"]
    sd = _RefDict()
    sd.conv("g_a.0", N, 3, 5)
    sd.gdn("g_a.1", N)
    sd.conv("g_a.2", N, N, 5)
    sd.gdn("g_a.3", N)
    _win_noshift(sd, "g_a.4", N, 8, 8)
    sd.conv("g_a.5", N, N, 5)
    sd.gdn("g_a.6", N)
    sd.conv("g_a.7", M, N, 5)
    _win_noshift(sd, "g_a.8", M, 8, 4)
    for prefix in ("", "human_"):
        widths = [M] + list(enc)
        for i in range(5):
            sd.conv(f"{prefix}h_a.{2 * i}", enc[i], widths[i], 3)
        for tag in ("h_mean_s", "h_scale_s"):
            _hyper_dec(sd, f"{prefix}{tag}", enc[-1], dec, extra=5 if prefix else 0)
    sc, n = M // c["num_slices"], 4 * c["num_slices"]
    for i in range(n):
        # the reference builds LRP stacks whose output its forward discards
        for tag, extra in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                           ("lrp_transforms2", sc)):
            cin = [c["support_num"] * sc + sc * min(i, c["max_support"]) + extra] + list(cc)
            for j in range(4):
                sd.conv(f"{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            sd.conv(f"{tag}.{i}.8", sc, cc[-1], 3)
    _bottleneck(sd, "entropy_bottleneck", enc[-1])
    _bottleneck(sd, "entropy_bottleneck_human", enc[-1])
    _decoder(sd, "g_s1", N, M, mid, part=1)
    _decoder(sd, "g_s2", N, M, mid, part=2)
    if name == "stf12":
        _stf12_human(sd, N, M, mid)
        return sd
    _decoder(sd, "human_g_s2", N, M, mid)
    residual = name == "stf14"
    g_a_in = [3 if residual else 6, N, N, N]
    for j, (i, o) in enumerate(zip(g_a_in, [N, N, N, M])):
        sd.conv(f"human_g_a.{2 * j}", o, i, 5)
    g_s_in = [M if residual else 2 * M, N, N, N]
    for j, (i, o) in enumerate(zip(g_s_in, [N, N, N, 3])):
        sd.deconv(f"human_g_s.{2 * j}", i, o, 5)
    for j in range(5):  # stf14's is built and never run
        sd.conv(f"human_context_decoder.{2 * j}", M, M, 3)
    return sd


def _stf12_human(sd, N, M, mid):
    """stf12.py's human layer: mainCNNdecoder and mainCNNcontextScale2 as
    conditioning, the 3-conv context decoder, the two-stage encoder
    (conv pair; conv, conv, Win) and decoder (Win at 2M, deconv pair;
    deconv, conv, deconv), the sub-pixel context decoder."""
    _decoder(sd, "human_g_enc2", N, M, mid)
    _win_noshift(sd, "human_g_enc3.0", M, 8, 4)
    sd.deconv("human_g_enc3.1", M, N, 3)
    sd.gdn("human_g_enc3.2", N)
    sd.deconv("human_g_enc3.3", N, N, 3)
    for j in range(3):
        sd.conv(f"human_context_decoder.{2 * j}", M, M, 3)
    sd.conv("human_g_a1.0", N, 6, 3)
    sd.conv("human_g_a1.2", N, N, 3)
    sd.conv("human_g_a2.0", N, 2 * N, 5)
    sd.conv("human_g_a2.2", M, N, 5)
    _win_noshift(sd, "human_g_a2.4", M, 8, 4)
    _win_noshift(sd, "human_g_s1.0", 2 * M, 8, 4)
    sd.deconv("human_g_s1.2", 2 * M, N, 3)
    sd.deconv("human_g_s1.4", N, N, 3)
    sd.deconv("human_g_s2.0", 2 * N, N, 3)
    sd.conv("human_g_s2.2", N, N, 3)
    sd.deconv("human_g_s2.4", N, 3, 3)
    sd.conv("human_context_decoder2.0", M, M, 3)
    sd.conv("human_context_decoder2.2", M, M, 3)
    sd.conv("human_context_decoder2.4.0", 4 * N, M, 3)
    sd.conv("human_context_decoder2.6.0", 4 * N, N, 3)


@functools.lru_cache(maxsize=None)
def converted(name: str):
    """-> (the filled reference dict, the JAX conversion, the port's)."""
    sd = fill(crc_sd(name), seed=len(name))
    return sd, jzoo.convert_crc_checkpoint(sd, name), tzoo.convert_reference_state_dict(name, sd)


@pytest.mark.parametrize("name", ["stf9", "stf12", "stf13", "stf14"])
def test_converter_tree_matches_init(name):
    """The synthetic dict is complete: the JAX converter's tree has the JAX
    model's init specs."""
    jcls, jkw = jax_models[name]
    want = init_specs(jcls(**{**jkw, **narrow(name)}))
    got = tree_specs(converted(name)[1])
    assert got == want, (sorted(set(want) - set(got))[:5], sorted(set(got) - set(want))[:5])


@pytest.mark.parametrize("name", NAMES)
def test_port_conversion_matches_jax(name):
    _, jax_tree, port = converted(name)
    assert_same_state_dict(port, from_jax_params(jax_tree))


@pytest.mark.parametrize("name", NAMES)
def test_port_conversion_loads_strictly(name):
    model = tmodels.create_model(name, device="cpu", **narrow(name))
    port = converted(name)[2]
    model.load_state_dict(port, strict=True)
    assert all(torch.equal(p, port[k]) for k, p in model.state_dict().items())


def test_dead_reference_groups_are_dropped():
    sd, _, port = converted("stf14")
    assert any(k.startswith("lrp_transforms2.") for k in sd)
    assert any(k.startswith("human_context_decoder.") for k in sd)
    assert not any(".lrp_" in k or k.startswith("human_context_decoder.") for k in port)
    assert any(k.startswith("human_context_decoder.") for k in converted("stf9")[2])


@pytest.mark.parametrize("arch,item", [("stf10", "1"), ("oj_ICM", "1")])
def test_rest_of_the_family_is_refused_by_its_queue_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        tzoo.convert_reference_state_dict(arch, {})


@pytest.mark.parametrize("ref_layout", [False, True])
def test_stored_tables_serve_the_host_wire(ref_layout):
    """A stf9 reference dict with both bottlenecks' and the Gaussian's CDF
    buffers: the tables import as the JAX package imports them, and the
    converted model serves the host wire with them, round trip bit for
    bit, in either symbol order."""
    sd, _, port = converted("stf9")
    model = tmodels.create_model("stf9", device="cpu", **CRC_NARROW)
    model.load_state_dict(port, strict=True)
    built = tmodels.build_codec_tables(model)
    stored = dict(sd)
    for prefix, t in (("gaussian_conditional", built.gaussian),
                      ("entropy_bottleneck", built.bottlenecks["entropy_bottleneck"]),
                      ("entropy_bottleneck_human", built.bottlenecks["entropy_bottleneck_human"])):
        stored[f"{prefix}._quantized_cdf"] = t.quantized_cdf
        stored[f"{prefix}._cdf_length"] = t.cdf_length
        stored[f"{prefix}._offset"] = t.offset
    stored["gaussian_conditional.scale_table"] = built.scale_table
    tables = tzoo.import_reference_tables(stored)
    jt = jzoo.import_reference_tables(stored)
    assert set(tables.bottlenecks) == set(jt.bottlenecks) == {"entropy_bottleneck",
                                                               "entropy_bottleneck_human"}
    for k, t in tables.bottlenecks.items():
        np.testing.assert_array_equal(t.quantized_cdf, np.asarray(jt.bottlenecks[k].quantized_cdf))
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    codec = CRCCodec(model, tables=tables, ref_layout=ref_layout, narrow=0.2)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    dec = codec.decompress(enc["strings"], enc["shape"], enc["human_shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])


def test_stf13_dead_groups_are_dropped_and_lrp_kept():
    """stf13's split decoder g_s1 / g_s2 is in the reference dict and not in
    the conversion; both coders' LRP stacks, which it applies, are."""
    sd, _, port = converted("stf13")
    assert any(k.startswith(("g_s1.", "g_s2.")) for k in sd)
    assert not any(k.startswith(("g_s1.", "g_s2.")) for k in port)
    for prefix in ("machine.coder.lrp_", "seg_coder.lrp_"):
        assert len({k[len(prefix):].split(".")[0] for k in port if k.startswith(prefix)}) == 24


def test_stf13_conversion_matches_jax_scan_charm_tree():
    """The port's stf13 conversion equals ``from_jax_params`` of the JAX
    conversion with both coders' context stacks (LRP included) stacked
    into their ``zz_scan`` subtrees, as a ``scan_charm=True`` model holds
    them, bit for bit."""
    from icm_tpu.models.zigzag_coder import stack_zigzag_params as jax_stack

    _, jax_tree, port = converted("stf13")
    model = tmodels.create_model("stf13", device="cpu", **STF13_NARROW)
    tree = dict(jax_tree)
    for path, coder in ((("machine", "coder"), model.coder), (("seg_coder",), model.seg_coder)):
        node = tree
        for p in path[:-1]:
            node[p] = dict(node[p])
            node = node[p]
        c = node[path[-1]]
        scanned = {k: v for k, v in c.items() if k.rsplit("_", 1)[0] not in coder.tags}
        scanned.update(jax_stack(c, coder.ctx_slices, coder.slice_ch, coder.max_support,
                                 coder.cond_width, apply_lrp=True))
        node[path[-1]] = scanned
    jcls, jkw = jax_models["stf13"]
    assert tree_specs(tree) == init_specs(jcls(**{**jkw, **STF13_NARROW}, scan_charm=True))
    assert_same_state_dict(from_jax_params(tree, model=model), port)


@pytest.mark.parametrize("ref_layout", [False, True])
def test_stf13_stored_tables_serve_the_host_wire(ref_layout):
    """A stf13 reference dict with its three bottlenecks' and the
    Gaussian's CDF buffers: the tables import as the JAX package imports
    them, and the converted model serves the host wire with them (six
    streams), round trip bit for bit, in either symbol order."""
    sd, _, port = converted("stf13")
    model = tmodels.create_model("stf13", device="cpu", **STF13_NARROW)
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
    assert set(tables.bottlenecks) == set(jt.bottlenecks) == {
        "entropy_bottleneck", "entropy_bottleneck_seg", "entropy_bottleneck_human"}
    for k, t in tables.bottlenecks.items():
        np.testing.assert_array_equal(t.quantized_cdf, np.asarray(jt.bottlenecks[k].quantized_cdf))
        np.testing.assert_array_equal(t.quantized_cdf, built.bottlenecks[k].quantized_cdf)
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    codec = CRC3Codec(model, tables=tables, ref_layout=ref_layout, narrow=0.2)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    assert len(enc["strings"]) == 6
    dec = codec.decompress(enc["strings"], enc["shape"], enc["seg_shape"], enc["human_shape"])
    for k in ("y_hat", "seg_y_hat", "x_hat"):
        assert torch.equal(dec[k], enc[k]), k
