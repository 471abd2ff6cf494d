"""Reference checkpoints: icm_tpu_torch.zoo against icm_tpu.zoo.

Synthetic reference state dicts (the reference's module names and
shapes, as ``tests/test_zoo_convert.py`` builds them, with its WACNN and
zigzag-family counterparts), filled with seeded values. Held: the JAX
converter's tree has the JAX model's init specs (``jax.eval_shape``),
which shows the synthetic dict complete; the port's conversion equals
``from_jax_params`` of the JAX conversion key for key and bit for bit,
and loads strictly into the port's model; the key cleanup; the stored CDF
tables imported as JAX imports them; with them and the reference symbol
order, one image's host-wire streams byte for byte with the JAX codec's,
each side decoding the other's; the default order's streams still the
JAX codec's default ones; the device wire refusing the reference order;
the zoo's other architectures refused by name. The zigzag presets'
conversions are in ``test_torch_zoo_zigzag*.py`` (their JAX init specs
take a while to trace).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL

from icm_tpu import zoo as jzoo
from icm_tpu.models import CharmCodec as JaxCharmCodec
from icm_tpu.models import SymmetricalTransFormer as JaxSTF
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu.models import ZigzagSwinCodec as JaxZigzag
from icm_tpu.models import build_codec_tables as jax_build_tables
from icm_tpu.models import models as jax_models
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)

HYPER = (64, 56, 48, 40, 32)
CC = (24, 20, 16, 12)
# the narrow configs: the JAX model's kwargs, and the port's
WACNN_NARROW = dict(N=32, M=48, num_slices=6, max_support_slices=3,
                    hyper_enc_widths=(48, 44, 40, 36, 32),
                    hyper_dec_widths=(32, 36, 40, 44, 48), cc_widths=(32, 24, 20, 16))
STF_NARROW = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window_size=4, patch_size=2,
                  num_slices=2, drop_path_rate=0.0, hyper_enc_widths=HYPER,
                  hyper_dec_widths=(40, 48, 56, 64, 64), cc_widths=CC)
# the zigzag presets at narrow widths: M = 48 (12 slices of 4, 6 of 8), the
# refiners' 4 heads over the slice, the presets' slices and refiner depths
ZIG_NARROW = dict(embed_dim=24, depths=(1, 1), num_heads=(1, 2), window_size=4, patch_size=2,
                  hyper_enc_widths=(32, 32, 32, 32, 32), hyper_dec_widths=(32, 32, 40, 48, 48),
                  cc_widths=(16, 12, 12, 8))


# --- synthetic reference state dicts ---------------------------------------------

class _RefDict(dict):
    """A reference state dict being built: name -> zeros of the shape."""

    def conv(self, name, o, i, k):
        self[f"{name}.weight"] = np.zeros((o, i, k, k), np.float32)
        self[f"{name}.bias"] = np.zeros((o,), np.float32)

    def deconv(self, name, i, o, k):
        self[f"{name}.weight"] = np.zeros((i, o, k, k), np.float32)
        self[f"{name}.bias"] = np.zeros((o,), np.float32)

    def lin(self, name, o, i, bias=True):
        self[f"{name}.weight"] = np.zeros((o, i), np.float32)
        if bias:
            self[f"{name}.bias"] = np.zeros((o,), np.float32)

    def ln(self, name, c):
        self[f"{name}.weight"] = np.zeros((c,), np.float32)
        self[f"{name}.bias"] = np.zeros((c,), np.float32)

    def gdn(self, name, c):
        self[f"{name}.beta"] = np.zeros((c,), np.float32)
        self[f"{name}.gamma"] = np.zeros((c, c), np.float32)

    def swin_blocks(self, prefix, dim, depth, heads, ws):
        for j in range(depth):
            b = f"{prefix}.blocks.{j}"
            self.ln(f"{b}.norm1", dim)
            self.lin(f"{b}.attn.qkv", 3 * dim, dim)
            self.lin(f"{b}.attn.proj", dim, dim)
            self[f"{b}.attn.relative_position_bias_table"] = np.zeros(
                ((2 * ws - 1) ** 2, heads), np.float32)
            # a buffer of the reference's Swin blocks the converters skip
            self[f"{b}.attn.relative_position_index"] = np.zeros((ws * ws, ws * ws), np.float32)
            self.ln(f"{b}.norm2", dim)
            self.lin(f"{b}.mlp.fc1", 4 * dim, dim)
            self.lin(f"{b}.mlp.fc2", dim, 4 * dim)

    def hyper(self, M, enc, dec):
        widths = [M] + list(enc)
        for i in range(5):
            self.conv(f"h_a.{2 * i}", enc[i], widths[i], 3)
        for tag in ("h_mean_s", "h_scale_s"):
            self.conv(f"{tag}.0", dec[0], enc[-1], 3)
            self.conv(f"{tag}.2.0", dec[1] * 4, dec[0], 3)
            self.conv(f"{tag}.4", dec[2], dec[1], 3)
            self.conv(f"{tag}.6.0", dec[3] * 4, dec[2], 3)
            self.conv(f"{tag}.8", dec[4], dec[3], 3)

    def context(self, n, sc, cond, max_support, cc, suffix=""):
        for i in range(n):
            for tag, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0),
                               ("lrp_transforms", sc)):
                cin = [cond + sc * min(i, max_support) + extra] + list(cc)
                for j in range(4):
                    self.conv(f"{tag}{suffix}.{i}.{2 * j}", cc[j], cin[j], 3)
                self.conv(f"{tag}{suffix}.{i}.8", sc, cc[-1], 3)

    def bottleneck(self, C):
        self["entropy_bottleneck.quantiles"] = np.zeros((C, 1, 3), np.float32)
        fdims = (1, 3, 3, 3, 3, 1)
        for i in range(5):
            self[f"entropy_bottleneck._matrix{i}"] = np.zeros((C, fdims[i + 1], fdims[i]),
                                                              np.float32)
            self[f"entropy_bottleneck._bias{i}"] = np.zeros((C, fdims[i + 1], 1), np.float32)
            if i < 4:
                self[f"entropy_bottleneck._factor{i}"] = np.zeros((C, fdims[i + 1], 1),
                                                                  np.float32)

    def swin_transforms(self, embed, depths, heads, ws):
        self.conv("patch_embed.proj", embed, 3, 2)
        self.ln("patch_embed.norm", embed)
        n = len(depths)
        for i in range(n):
            dim = embed * 2 ** i
            self.swin_blocks(f"layers.{i}", dim, depths[i], heads[i], ws)
            if i < n - 1:
                self.lin(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
                self.ln(f"layers.{i}.downsample.norm", 4 * dim)
        rdepths, rheads = tuple(reversed(depths)), tuple(reversed(heads))
        for i in range(n):
            dim = embed * 2 ** (n - 1 - i)
            self.swin_blocks(f"syn_layers.{i}", dim, rdepths[i], rheads[i], ws)
            if i < n - 1:
                self.lin(f"syn_layers.{i}.downsample.reduction", 2 * dim, dim, bias=False)
                self.ln(f"syn_layers.{i}.downsample.norm", dim)
        self.conv("end_conv.0", embed * 4, embed, 5)
        self.conv("end_conv.2", 3, embed, 3)


def _win_noshift(sd, prefix, dim, heads, ws):
    def unit(p):
        sd.conv(f"{p}.conv.0", dim // 2, dim, 1)
        sd.conv(f"{p}.conv.2", dim // 2, dim // 2, 3)
        sd.conv(f"{p}.conv.4", dim, dim // 2, 1)

    for i in range(3):
        unit(f"{prefix}.conv_a.{i}")
        unit(f"{prefix}.conv_b.{i + 1}")
    sd.lin(f"{prefix}.conv_b.0.attn.qkv", 3 * dim, dim)
    sd.lin(f"{prefix}.conv_b.0.attn.proj", dim, dim)
    sd[f"{prefix}.conv_b.0.attn.relative_position_bias_table"] = np.zeros(
        ((2 * ws - 1) ** 2, heads), np.float32)
    sd.conv(f"{prefix}.conv_b.4", dim, dim, 1)


def wacnn_sd(N=32, M=48, slices=6, K=3, enc=WACNN_NARROW["hyper_enc_widths"],
             dec=WACNN_NARROW["hyper_dec_widths"], cc=WACNN_NARROW["cc_widths"]) -> _RefDict:
    """Reference WACNN names (reference cnn.py: g_a conv, GDN, conv, GDN,
    Win, conv, GDN, conv, Win; g_s the mirror with transposed convs)."""
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
    _win_noshift(sd, "g_s.0", M, 8, 4)
    sd.deconv("g_s.1", M, N, 5)
    sd.gdn("g_s.2", N)
    sd.deconv("g_s.3", N, N, 5)
    sd.gdn("g_s.4", N)
    _win_noshift(sd, "g_s.5", N, 8, 8)
    sd.deconv("g_s.6", N, N, 5)
    sd.gdn("g_s.7", N)
    sd.deconv("g_s.8", N, 3, 5)
    sd.hyper(M, enc, dec)
    sd.context(slices, M // slices, dec[-1], K, cc)
    sd.bottleneck(enc[-1])
    return sd


def stf_sd(embed=8, depths=(1, 1), heads=(1, 2), ws=4, slices=2, enc=HYPER,
           dec=(40, 48, 56, 64, 64), cc=CC) -> _RefDict:
    """Reference stf names (reference stf.py), as ``test_zoo_convert.py``
    makes them."""
    sd = _RefDict()
    sd.swin_transforms(embed, depths, heads, ws)
    M = embed * 2 ** (len(depths) - 1)
    sd.hyper(M, enc, dec)
    sd.context(slices, M // slices, dec[-1], slices // 2, cc)
    sd.bottleneck(enc[-1])
    return sd


# the refiner tensors the reference stf6 builds and never runs
_STF6_DISABLED = {"sigma_Swin": (2, 6, 2, 2), "LRP_Swin": (2, 6, 2, 2)}


def zigzag_sd(name: str) -> _RefDict:
    """Reference stf5-stf8 names at ``ZIG_NARROW``'s widths and the
    preset's context (reference stf5.py-stf8.py: the stf transforms, the
    ``cc_*_transforms{2}`` stacks, the per-slice ``*_Swin{2}`` refiners)."""
    cfg = jax_models[name][1]
    conv = jzoo.ZIGZAG_CONVERT_CONFIGS[name]
    z = ZIG_NARROW
    sd = _RefDict()
    sd.swin_transforms(z["embed_dim"], z["depths"], z["num_heads"], z["window_size"])
    M = z["embed_dim"] * 2 ** (len(z["depths"]) - 1)
    sd.hyper(M, z["hyper_enc_widths"], z["hyper_dec_widths"])
    sc = M // cfg["num_slices"]
    n = conv["ctx_slices"]
    cond = (z["hyper_dec_widths"][-1] if cfg["mean_mode"] == "full"
            else cfg.get("mean_window", 1) * sc)
    sd.context(n, sc, cond, cfg["max_support"], z["cc_widths"], conv.get("cc_suffix", ""))
    tags = {"mu_refine": "mu_Swin", "sigma_refine": "sigma_Swin", "lrp_refine": "LRP_Swin"}
    refiners = {tags[t]: d for t, d in conv["refiners"].items()}
    if name in ("stf6", "stf6_2"):
        refiners.update(_STF6_DISABLED)
    for tag, depths in refiners.items():
        for i in range(n):
            for j, d in enumerate(depths):
                sd.swin_blocks(f"{tag}{conv.get('refiner_suffix', '')}.{i}.{j}", sc, d, 4,
                               cfg["refine_window"])
    sd.bottleneck(z["hyper_enc_widths"][-1])
    return sd


def fill(sd: dict, seed: int) -> dict:
    """Seeded values of a trained model's scale: fan-in scaled kernels,
    small biases, LayerNorm near one, GDN near its init, ordered bottleneck
    quantiles."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        n = rng.standard_normal(v.shape).astype(np.float32)
        leaf = k.rsplit(".", 1)[-1]
        if leaf.startswith("relative_position"):
            out[k] = 0.02 * n  # bias tables, and the index buffers the converters skip
        elif k.endswith("quantiles"):
            q = np.array([-8.0, 0.0, 8.0], np.float32) + 0.2 * n
            out[k] = np.sort(q, axis=-1)
        elif leaf == "gamma":
            out[k] = np.sqrt(0.1 * np.eye(v.shape[0], dtype=np.float32) + 0.005 * np.abs(n))
        elif leaf == "beta":
            out[k] = 1.0 + 0.05 * np.abs(n)
        elif "norm" in k and leaf == "weight":
            out[k] = 1.0 + 0.1 * n
        elif leaf == "weight":
            out[k] = n / np.sqrt(np.prod(v.shape[1:]))
        elif leaf == "bias" or "_bias" in leaf:
            out[k] = 0.01 * n if "norm" not in k else 0.05 * n
        else:  # the bottleneck's matrices and factors
            out[k] = 0.5 * n
    return out


# --- helpers ------------------------------------------------------------------------

def tree_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_specs(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = tuple(np.shape(v))
    return out


def init_specs(jm, size=64) -> dict:
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3)), training=False))
    return tree_specs(shapes["params"])


def assert_same_state_dict(got: dict, want: dict):
    assert sorted(got) == sorted(want), (sorted(set(want) - set(got))[:5],
                                         sorted(set(got) - set(want))[:5])
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


ARCHS = {
    # name -> (JAX model, synthetic dict, JAX converter, port converter, port config)
    "cnn": (lambda: JaxWACNN(**WACNN_NARROW), wacnn_sd,
            lambda sd: jzoo.convert_wacnn_checkpoint(sd, num_slices=6),
            lambda sd: tzoo.convert_wacnn_checkpoint(sd, num_slices=6), WACNN_NARROW),
    "stf": (lambda: JaxSTF(**STF_NARROW), stf_sd,
            lambda sd: jzoo.convert_stf_checkpoint(sd, depths=(1, 1), num_slices=2),
            lambda sd: tzoo.convert_stf_checkpoint(sd, depths=(1, 1), num_slices=2), STF_NARROW),
}


@functools.lru_cache(maxsize=None)
def converted(name: str):
    """-> (the filled reference dict, the JAX conversion, the port's)."""
    if name in ARCHS:
        _, build, jconv, tconv, _ = ARCHS[name]
        sd = fill(build(), seed=len(name))
        return sd, jconv(sd), tconv(sd)
    sd = fill(zigzag_sd(name), seed=len(name))
    conv = jzoo.ZIGZAG_CONVERT_CONFIGS[name]
    return (sd, jzoo.convert_zigzag_checkpoint(sd, depths=ZIG_NARROW["depths"], **conv),
            tzoo.convert_zigzag_checkpoint(sd, depths=ZIG_NARROW["depths"], **conv))


def port_model(name: str):
    """The port's model of ``name`` at its narrow config, on the CPU."""
    if name in ARCHS:
        return tmodels.create_model(name, device="cpu", **ARCHS[name][4])
    return tmodels.create_model(name, device="cpu", **ZIG_NARROW)


@functools.lru_cache(maxsize=None)
def zigzag_init_specs(config: tuple) -> dict:
    """The JAX zigzag model's init specs at ``ZIG_NARROW`` and a preset's
    config (its sorted items), traced once for presets that share one."""
    return init_specs(JaxZigzag(**ZIG_NARROW, **dict(config)))


def check_converter_tree_matches_init(name: str):
    if name in ARCHS:
        want = init_specs(ARCHS[name][0]())
    else:
        want = zigzag_init_specs(tuple(sorted(jax_models[name][1].items())))
    got = tree_specs(converted(name)[1])
    assert got == want, (sorted(set(want) - set(got))[:5], sorted(set(got) - set(want))[:5],
                         [k for k in want if k in got and want[k] != got[k]][:5])


def check_port_conversion_matches_jax(name: str):
    _, jax_tree, port = converted(name)
    assert_same_state_dict(port, from_jax_params(jax_tree))


def check_port_conversion_loads_strictly(name: str):
    model = port_model(name)
    model.load_state_dict(converted(name)[2], strict=True)
    assert all(torch.equal(p, converted(name)[2][k]) for k, p in model.state_dict().items())


# --- cnn and stf ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_converter_tree_matches_init(name):
    check_converter_tree_matches_init(name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_port_conversion_matches_jax(name):
    check_port_conversion_matches_jax(name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_port_conversion_loads_strictly(name):
    check_port_conversion_loads_strictly(name)


def test_load_pretrained_cleans_the_keys():
    sd = {"module.g_a.0.weight": 1, "module.h_s.0.weight": 2, "h_s.1.bias": 3,
          "entropy_bottleneck._matrices.2": 4, "entropy_bottleneck._biases.0": 5,
          "entropy_bottleneck._factors.3": 6, "module.entropy_bottleneck.quantiles": 7}
    want = {"g_a.0.weight": 1, "entropy_bottleneck._matrix2": 4,
            "entropy_bottleneck._bias0": 5, "entropy_bottleneck._factor3": 6,
            "entropy_bottleneck.quantiles": 7}
    assert tzoo.load_pretrained(sd) == want == jzoo.load_pretrained(sd)


def test_legacy_and_parallel_keys_convert_as_clean_ones():
    """A DataParallel checkpoint with the legacy bottleneck ParameterList
    keys and a stray ``h_s`` converts to the clean dict's state dict."""
    sd, _, want = converted("cnn")
    legacy = {}
    for k, v in sd.items():
        k = re.sub(r"\._(matrix|bias|factor)(\d)$",
                   lambda m: f"._{ {'matrix': 'matrices', 'bias': 'biases', 'factor': 'factors'}[m[1]]}.{m[2]}",
                   k)
        legacy["module." + k] = torch.from_numpy(v)
    assert "module.entropy_bottleneck._biases.0" in legacy
    legacy["module.h_s.0.weight"] = torch.zeros(3)
    assert_same_state_dict(tzoo.convert_wacnn_checkpoint(legacy, num_slices=6), want)


def test_load_reference_checkpoint_reads_a_saved_file(tmp_path, monkeypatch):
    sd, _, want = converted("stf")
    path = tmp_path / "stf.pth.tar"
    torch.save({"epoch": 3, "state_dict": {"module." + k: torch.from_numpy(v)
                                           for k, v in sd.items()}}, path)
    monkeypatch.setattr(tzoo, "convert_reference_state_dict",
                        lambda arch, d: tzoo.convert_stf_checkpoint(d, depths=(1, 1),
                                                                    num_slices=2))
    assert_same_state_dict(tzoo.load_reference_checkpoint("stf", str(path)), want)


@pytest.mark.parametrize("arch", ["czigzag2", "stf10", "stf1", "seg_oj_ICM", "cnn3", "oj_ICM",
                                  "nope"])
def test_architectures_not_ported_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tzoo.convert_reference_state_dict(arch, {})


# --- stored tables and the reference symbol order --------------------------------------

@pytest.fixture(scope="module")
def ref_codecs():
    """The narrow WACNN from its reference dict in both packages, the dict
    given the CDF buffers the reference's ``update()`` stores (the JAX
    model's own tables), each package's import of them, and one image."""
    sd, jax_tree, port_sd = converted("cnn")
    jm = ARCHS["cnn"][0]()
    variables = {"params": jax_tree}
    built = jax_build_tables(jm, variables)
    sd = dict(sd)
    for prefix, t in (("entropy_bottleneck", built.bottlenecks["entropy_bottleneck"]),
                      ("gaussian_conditional", built.gaussian)):
        sd[f"{prefix}._quantized_cdf"] = np.asarray(t.quantized_cdf)
        sd[f"{prefix}._offset"] = np.asarray(t.offset)
        sd[f"{prefix}._cdf_length"] = np.asarray(t.cdf_length)
    sd["gaussian_conditional.scale_table"] = np.asarray(built.scale_table)
    tm = port_model("cnn")
    tm.load_state_dict(port_sd, strict=True)
    # 128 px: z has 2 x 2 positions, so the two symbol orders differ in z too
    x = np.random.default_rng(5).random((1, 128, 128, 3)).astype(np.float32)
    return dict(sd=sd, jm=jm, variables=variables, tm=tm.eval(), x=x,
                jtables=jzoo.import_reference_tables(sd), ttables=tzoo.import_reference_tables(sd))


def test_import_reference_tables_matches_jax(ref_codecs):
    jt, tt = ref_codecs["jtables"], ref_codecs["ttables"]
    assert set(tt.bottlenecks) == set(jt.bottlenecks) == {"entropy_bottleneck"}
    pairs = [(tt.gaussian, jt.gaussian), (tt.bottlenecks["entropy_bottleneck"],
                                          jt.bottlenecks["entropy_bottleneck"])]
    for t, j in pairs:
        for f in ("quantized_cdf", "cdf_length", "offset"):
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert a.dtype == np.int32 and a.shape == b.shape and (a == b).all(), f
    assert tt.scale_table.dtype == np.float32
    np.testing.assert_array_equal(tt.scale_table, np.asarray(jt.scale_table))


def test_import_reference_tables_without_buffers_is_none(ref_codecs):
    assert tzoo.import_reference_tables(converted("cnn")[0]) is None
    empty = {"entropy_bottleneck._quantized_cdf": np.zeros((0,), np.int32)}
    assert tzoo.import_reference_tables(empty) is None is jzoo.import_reference_tables(empty)


@pytest.fixture(scope="module")
def ref_layout_streams(ref_codecs):
    r = ref_codecs
    port = tmodels.CharmCodec(r["tm"], tables=r["ttables"], ref_layout=True)
    jc = JaxCharmCodec(r["jm"], r["variables"], tables=r["jtables"], ref_layout=True)
    return (port, port.compress(torch.from_numpy(r["x"]), return_debug=True),
            jc, jc.compress(jnp.asarray(r["x"]), return_debug=True))


def test_ref_layout_streams_match_jax_byte_for_byte(ref_layout_streams):
    _, enc, _, jenc = ref_layout_streams
    flipped = np.abs(enc["y_hat"].permute(0, 2, 3, 1).numpy() - np.asarray(jenc["y_hat"])) > 0.5
    assert flipped.sum() == 0
    assert enc["strings"] == jenc["strings"]


def test_ref_layout_streams_decode_across(ref_layout_streams):
    port, enc, jc, jenc = ref_layout_streams
    dec = port.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    dec = port.decompress(jenc["strings"], jenc["shape"])
    np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)
    jdec = jc.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(np.asarray(jdec["y_hat"]),
                               enc["y_hat"].permute(0, 2, 3, 1).numpy(), rtol=0, atol=CROSS_TOL)


def test_default_layout_streams_are_unchanged(ref_codecs, ref_layout_streams):
    """Without ``ref_layout`` the streams are the JAX codec's default
    (NHWC-ordered) ones, which the reference order changes."""
    r = ref_codecs
    enc = tmodels.CharmCodec(r["tm"], tables=r["ttables"]).compress(torch.from_numpy(r["x"]))
    jenc = JaxCharmCodec(r["jm"], r["variables"], tables=r["jtables"]).compress(
        jnp.asarray(r["x"]))
    assert enc["strings"] == jenc["strings"]
    assert enc["strings"][0] != ref_layout_streams[1]["strings"][0]
    assert enc["strings"][1] != ref_layout_streams[1]["strings"][1]


def test_device_wire_refuses_the_reference_layout(ref_codecs):
    with pytest.raises(ValueError, match="ref_layout"):
        tmodels.DeviceWireCodec(ref_codecs["tm"], lanes_per_image=4, ref_layout=True)
