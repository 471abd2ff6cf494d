"""Reference ``oj_ICM`` / ``seg_oj_ICM`` checkpoints and the Detectron2
R50-FPN: icm_tpu_torch.zoo against icm_tpu.zoo.

The synthetic reference dicts carry the reference's names
(fasterRCNN_ICM.py, MaskedRCNN_OBJ_ICM.py: ``g_a``, ``g_s``, the inline
coder's ``h_a``, ``h_mean_s``, ``h_scale_s``, 3-conv ``cc_*_transforms2``
and the ``lrp_transforms2`` it applies, ``entropy_bottleneck``;
``seg_oj_ICM`` the same under ``seg_``, its encoder of 6 channels and its
bottleneck ``seg_entropy_bottleneck``) at ``tests/test_icm_models.py``'s
narrow codec widths, and, where a checkpoint holds one, the frozen task net
under ``task_net.``: Detectron2's ResNet-50 (``stem.conv1``,
``res{2-5}.{i}.conv{1-3}`` and ``shortcut``, each with its FrozenBatchNorm
``.norm``) under ``bottom_up.`` and its ``fpn_lateral{2-5}`` /
``fpn_output{2-5}``; filled with seeded values. Held: the port's
conversion equals ``from_jax_params`` of the JAX package's
``convert_oj_icm_checkpoint`` bit for bit, with the task net and without,
and loads strictly (into a model built with ``with_task_net=False`` for a
codec-only dict); ``convert_detectron2_fpn`` against JAX's with and
without ``bottom_up.``; the zoo's dispatch, and ``stf10`` the one name
left to port; the stored tables of both bottlenecks import as JAX imports
them and serve the host wire in the reference symbol order.
"""

import functools

import numpy as np
import pytest
import torch
from test_icm_models import TINY_CODEC
from test_torch_zoo import _RefDict, assert_same_state_dict, fill
from test_torch_zoo_cnn2 import fill_det
from test_torch_zoo_crc import _bottleneck, _coder, _decoder, _win_noshift

from icm_tpu import zoo as jzoo
from icm_tpu.utils import torch_weights as jtw
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc_codec import SegOjCodec
from icm_tpu_torch.models.icm import _FrozenFPN

torch.set_num_threads(2)

NAMES = ["oj_ICM", "seg_oj_ICM"]


def _encoder(sd, prefix, N, M, in_ch=3):
    """mainCNNencoder: WACNN's g_a."""
    sd.conv(f"{prefix}.0", N, in_ch, 5)
    sd.gdn(f"{prefix}.1", N)
    sd.conv(f"{prefix}.2", N, N, 5)
    sd.gdn(f"{prefix}.3", N)
    _win_noshift(sd, f"{prefix}.4", N, 8, 8)
    sd.conv(f"{prefix}.5", N, N, 5)
    sd.gdn(f"{prefix}.6", N)
    sd.conv(f"{prefix}.7", M, N, 5)
    _win_noshift(sd, f"{prefix}.8", M, 8, 4)


def detectron2_fpn_sd(prefix: str = "", bottom_up: bool = True) -> _RefDict:
    """Detectron2's R50-FPN backbone names under ``prefix`` (the ResNet under
    ``bottom_up.`` or at the top level)."""
    sd = _RefDict()
    bu = prefix + ("bottom_up." if bottom_up else "")

    def conv_bn(name, o, i, k):
        sd[f"{name}.weight"] = np.zeros((o, i, k, k), np.float32)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.norm.{leaf}"] = np.zeros((o,), np.float32)

    conv_bn(f"{bu}stem.conv1", 64, 3, 7)
    inplanes = 64
    for res, n in tzoo.DETECTRON2_R50.items():
        w = 64 * 2 ** (res - 2)
        for i in range(n):
            p = f"{bu}res{res}.{i}"
            conv_bn(f"{p}.conv1", w, inplanes, 1)
            conv_bn(f"{p}.conv2", w, w, 3)
            conv_bn(f"{p}.conv3", 4 * w, w, 1)
            if i == 0:
                conv_bn(f"{p}.shortcut", 4 * w, inplanes, 1)
            inplanes = 4 * w
    for level in range(2, 6):
        sd.conv(f"{prefix}fpn_lateral{level}", 256, 64 * 2 ** level, 1)
        sd.conv(f"{prefix}fpn_output{level}", 256, 256, 3)
    return sd


def oj_sd(name: str, task: bool = True) -> _RefDict:
    """The reference ``name``'s codec at ``TINY_CODEC``'s widths (module
    docstring), with the task net under ``task_net.`` if ``task``."""
    c = TINY_CODEC
    N, M, mid, z = c["N"], c["M"], c["mid"], c["hyper_enc_widths"][-1]
    sd = _RefDict()
    for prefix, in_ch in (("", 3),) + ((("seg_", 6),) if name == "seg_oj_ICM" else ()):
        _encoder(sd, f"{prefix}g_a", N, M, in_ch)
        _decoder(sd, f"{prefix}g_s", N, M, mid)
        _coder(sd, c, prefix)
        _bottleneck(sd, f"{prefix}entropy_bottleneck", z)
    if task:
        sd.update(detectron2_fpn_sd("task_net."))
    return sd


@functools.lru_cache(maxsize=None)
def converted(name: str, task: bool = True):
    """-> (the filled reference dict with DataParallel's ``module.``, the
    JAX conversion, the port's)."""
    sd = {"module." + k: v for k, v in fill_det(oj_sd(name, task), seed=len(name)).items()}
    return sd, jzoo.convert_oj_icm_checkpoint(sd, name), tzoo.convert_reference_state_dict(
        name, sd)


def port_model(name: str, task: bool = True):
    return tmodels.create_model(name, device="cpu", with_task_net=task, **TINY_CODEC)


@pytest.mark.parametrize("task", [True, False], ids=["with_task_net", "codec_only"])
@pytest.mark.parametrize("name", NAMES)
def test_conversion_matches_jax_and_loads_strictly(name, task):
    """The port's conversion is ``from_jax_params`` of JAX's bit for bit
    (BatchNorm's statistics the port's buffers), and loads strictly: a
    codec-only dict into a model without the task net."""
    sd, want, port = converted(name, task)
    assert ("batch_stats" in want) == task
    assert_same_state_dict(port, from_jax_params(want))
    model = port_model(name, task)
    model.load_state_dict(port, strict=True)
    assert all(torch.equal(p, port[k]) for k, p in model.state_dict().items())
    if task:
        np.testing.assert_array_equal(
            port["task_net.ResNetBackbone_0.layer3_5.BatchNorm_2.var"].numpy(),
            sd["module.task_net.bottom_up.res4.5.conv3.norm.running_var"])
        assert model.task_net.ResNetBackbone_0.layers == (3, 4, 6, 3)


@pytest.mark.parametrize("bottom_up", [True, False], ids=["bottom_up", "bare"])
def test_detectron2_fpn_converter_matches_jax(bottom_up):
    """Detectron2's FPN wraps its ResNet as ``bottom_up.``; a bare ResNet
    checkpoint has ``stem`` / ``res*`` at the top level: both convert as
    JAX converts them (the shortcut in each first block's last slot), to
    the same state dict, which loads strictly into ``_FrozenFPN``."""
    sd = fill_det(detectron2_fpn_sd("detector.", bottom_up), seed=27)
    port = tzoo.convert_detectron2_fpn(sd, prefix="detector.")
    assert_same_state_dict(port, from_jax_params(jtw.convert_detectron2_fpn(sd, "detector.")))
    assert "ResNetBackbone_0.layer1_0.Conv_3.weight" in port
    assert "ResNetBackbone_0.layer1_1.Conv_3.weight" not in port
    _FrozenFPN().load_state_dict(port, strict=True)
    other = fill_det(detectron2_fpn_sd("detector.", not bottom_up), seed=27)
    assert_same_state_dict(tzoo.convert_detectron2_fpn(other, prefix="detector."), port)


def test_only_stf10_is_left_to_port():
    """The zoo's dispatch converts both names as ``convert_oj_icm_checkpoint``
    does; ``stf10`` is the one architecture still refused (Queue 1 item
    1); the converter refuses other names."""
    assert tzoo._NOT_PORTED == {"stf10": "Queue 1 item 1 (ICM)"}
    for name in NAMES:
        sd, _, port = converted(name)
        assert_same_state_dict(tzoo.convert_oj_icm_checkpoint(sd, name), port)
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        tzoo.convert_reference_state_dict("stf10", {})
    with pytest.raises(ValueError, match="oj_ICM"):
        tzoo.convert_oj_icm_checkpoint({}, "stf13")


@pytest.mark.parametrize("name", NAMES)
def test_stored_tables_serve_the_host_wire(name):
    """A reference dict with every bottleneck's and the Gaussian's CDF
    buffers (``seg_oj_ICM``: ``seg_entropy_bottleneck`` beside
    ``entropy_bottleneck``, the model's own keys): the tables import as
    JAX imports them, and the converted codec (``CharmCodec``; ``SegOjCodec``)
    serves the host wire with them in the reference symbol order, bit-exact,
    its blobs those of the tables built from the model."""
    sd, _, port = converted(name, False)
    model = port_model(name, False)
    model.load_state_dict(port, strict=True)
    built = tmodels.build_codec_tables(model)
    stored = dict(sd)
    for prefix, t in (("gaussian_conditional", built.gaussian), *built.bottlenecks.items()):
        for field in ("quantized_cdf", "cdf_length", "offset"):
            stored[f"module.{prefix}._{field}"] = getattr(t, field)
    stored["module.gaussian_conditional.scale_table"] = built.scale_table
    tables = tzoo.import_reference_tables(stored)
    jt = jzoo.import_reference_tables(stored)
    assert set(tables.bottlenecks) == set(jt.bottlenecks) == set(model.eb_dict())
    for k, t in tables.bottlenecks.items():
        for field in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(t, field), getattr(built.bottlenecks[k], field))
            np.testing.assert_array_equal(getattr(t, field),
                                          np.asarray(getattr(jt.bottlenecks[k], field)))
    x = torch.from_numpy(np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32))

    def codec(t):
        if name == "oj_ICM":
            return tmodels.CharmCodec(model, tables=t, ref_layout=True, narrow=0.2)
        return SegOjCodec(model, tables=t, ref_layout=True, narrow=0.2)

    c = codec(tables)
    enc = c.compress(x, return_debug=True)
    args = [enc["shape"]] + ([enc["seg_shape"]] if name == "seg_oj_ICM" else [])
    dec = c.decompress(enc["strings"], *args)
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert codec(None).compress(x)["strings"] == enc["strings"]
