"""Reference ``cnn2`` checkpoints: icm_tpu_torch.zoo against icm_tpu.zoo.

A synthetic reference WACNN2 state dict at full width, as the reference
stores it (``test_torch_zoo.wacnn_sd``'s codec at N 192, M 320, 10 slices;
``studentNet.*``, the trained RetinaNet-ResNet-50 with 80 classes:
torchvision backbone names with ``running_mean`` / ``running_var`` /
``num_batches_tracked``, ``fpn.P3_1`` ... ``fpn.P7_2``, the
``regressionModel`` and ``classificationModel`` heads; ``teacherNet.*``, the
frozen pretrained detector; the CDF buffers ``update()`` stores; the
DataParallel ``module.`` prefix), filled with seeded values. Held:
``zoo.convert_reference_state_dict("cnn2", sd)`` equals
``from_jax_params`` of the JAX package's ``convert_cnn2_checkpoint`` key
for key and bit for bit, BatchNorm statistics included, drops the teacher
and the counters, and loads strictly into the port's full-width
``cnn2``; the stored tables import as JAX imports them. The torchvision
ResNet and RetinaNet converters alone, against JAX's, at ResNet-18 and
ResNet-50.
"""

import numpy as np
import pytest
import torch
from test_torch_zoo import _RefDict, assert_same_state_dict, fill, wacnn_sd

from icm_tpu import zoo as jzoo
from icm_tpu.utils import torch_weights as jtw
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import zoo as tzoo
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)


class _DetRefDict(_RefDict):
    """The reference's detector names."""

    def bn(self, name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self[f"{name}.{leaf}"] = np.zeros((c,), np.float32)
        self[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)

    def resnet(self, prefix="", block="bottleneck", layers=(3, 4, 6, 3), fc=False):
        """torchvision's ResNet names (``conv1`` / ``bn1``, ``layer{L}.{i}``
        with ``conv{k}`` / ``bn{k}`` and ``downsample.0`` / ``.1``)."""
        self[f"{prefix}conv1.weight"] = np.zeros((64, 3, 7, 7), np.float32)
        self.bn(f"{prefix}bn1", 64)
        exp = 4 if block == "bottleneck" else 1
        inplanes = 64
        for L, (w, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            for i in range(n):
                p = f"{prefix}layer{L}.{i}"
                stride = 2 if L > 1 and i == 0 else 1
                if block == "bottleneck":
                    shapes = [(w, inplanes, 1), (w, w, 3), (4 * w, w, 1)]
                else:
                    shapes = [(w, inplanes, 3), (w, w, 3)]
                for k, (o, c, ks) in enumerate(shapes, start=1):
                    self[f"{p}.conv{k}.weight"] = np.zeros((o, c, ks, ks), np.float32)
                    self.bn(f"{p}.bn{k}", o)
                if i == 0 and (stride != 1 or inplanes != w * exp):
                    self[f"{p}.downsample.0.weight"] = np.zeros((w * exp, inplanes, 1, 1),
                                                                np.float32)
                    self.bn(f"{p}.downsample.1", w * exp)
                inplanes = w * exp
        if fc:
            self.lin(f"{prefix}fc", 1000, inplanes)

    def retinanet(self, prefix="", num_classes=80):
        """The reference RetinaNet (``retinanet/model.py``)."""
        self.resnet(prefix)
        for name, c, k, in (("P5_1", 2048, 1), ("P5_2", 256, 3), ("P4_1", 1024, 1),
                            ("P4_2", 256, 3), ("P3_1", 512, 1), ("P3_2", 256, 3),
                            ("P6", 2048, 3), ("P7_2", 256, 3)):
            self.conv(f"{prefix}fpn.{name}", 256, c, k)
        for head, out in (("regressionModel", 9 * 4), ("classificationModel", 9 * num_classes)):
            for i in range(1, 5):
                self.conv(f"{prefix}{head}.conv{i}", 256, 256, 3)
            self.conv(f"{prefix}{head}.output", out, 256, 3)


def fill_det(sd: dict, seed: int) -> dict:
    """``test_torch_zoo.fill``, with BatchNorm's statistics of a trained
    net's kind: means near 0, variances of 1 to 2, the counters kept."""
    out = fill({k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}, seed)
    rng = np.random.default_rng(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_var"):
            out[k] = (1.0 + np.abs(rng.standard_normal(v.shape))).astype(np.float32)
        elif k.endswith("running_mean"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("num_batches_tracked"):
            out[k] = np.asarray(1000, np.int64)
    return out


@pytest.fixture(scope="module")
def reference():
    """-> (the full-width reference cnn2 dict with ``module.`` and CDF
    buffers, the port's conversion)."""
    sd = wacnn_sd(N=192, M=320, slices=10, K=5, enc=(320, 288, 256, 224, 192),
                  dec=(192, 224, 256, 288, 320), cc=(224, 176, 128, 64))
    det = _DetRefDict()
    det.retinanet("studentNet.")
    det.retinanet("teacherNet.")
    sd = fill_det({**sd, **det}, seed=23)
    rng = np.random.default_rng(24)
    for prefix, rows, width in (("entropy_bottleneck", 192, 40), ("gaussian_conditional", 64, 60)):
        sd[f"{prefix}._quantized_cdf"] = np.sort(rng.integers(0, 65536, (rows, width)),
                                                 axis=1).astype(np.int32)
        sd[f"{prefix}._offset"] = -rng.integers(1, 20, rows).astype(np.int32)
        sd[f"{prefix}._cdf_length"] = rng.integers(3, width, rows).astype(np.int32)
    sd["gaussian_conditional.scale_table"] = np.exp(np.linspace(np.log(0.11), np.log(256), 64)
                                                    ).astype(np.float32)
    sd = {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    return sd, tzoo.convert_reference_state_dict("cnn2", sd)


def test_cnn2_conversion_matches_jax_and_loads_strictly(reference):
    sd, port = reference
    want = jzoo.convert_cnn2_checkpoint({k: v.numpy() for k, v in sd.items()})
    assert set(want) == {"params", "batch_stats"}
    assert_same_state_dict(port, from_jax_params(want))
    assert not any(k.startswith("teacherNet.") or "num_batches" in k for k in port)
    # the student's BatchNorm statistics became the port's buffers
    np.testing.assert_array_equal(
        port["studentNet.backbone.layer3_2.BatchNorm_1.var"].numpy(),
        sd["module.studentNet.layer3.2.bn2.running_var"].numpy())
    with torch.device("meta"):
        model = tmodels.models["cnn2"][0]()
    model = model.to_empty(device="cpu")
    model.load_state_dict(port, strict=True)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.numel() for k, v in port.items() if not k.endswith((".mean", ".var")))
    assert torch.equal(model.studentNet.classification.output.bias,
                       sd["module.studentNet.classificationModel.output.bias"])


def test_cnn2_stored_tables_import_as_jax(reference):
    sd, _ = reference
    tt = tzoo.import_reference_tables(sd)
    jt = jzoo.import_reference_tables({k: v.numpy() for k, v in sd.items()})
    assert set(tt.bottlenecks) == set(jt.bottlenecks) == {"entropy_bottleneck"}
    for t, j in ((tt.gaussian, jt.gaussian),
                 (tt.bottlenecks["entropy_bottleneck"], jt.bottlenecks["entropy_bottleneck"])):
        for f in ("quantized_cdf", "cdf_length", "offset"):
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert a.dtype == np.int32 and a.shape == b.shape and (a == b).all(), f
    np.testing.assert_array_equal(tt.scale_table, np.asarray(jt.scale_table))


@pytest.mark.parametrize("block,layers", [("basic", (2, 2, 2, 2)), ("bottleneck", (3, 4, 6, 3))])
def test_torchvision_resnet_converter_matches_jax(block, layers):
    det = _DetRefDict()
    det.resnet(block=block, layers=layers, fc=True)
    sd = fill_det(det, seed=25)
    port = tzoo.convert_torchvision_resnet(sd, block, layers)
    assert_same_state_dict(port, from_jax_params(jtw.convert_torchvision_resnet(sd, block,
                                                                                  layers)))
    from icm_tpu_torch.tasks import ResNetBackbone

    ResNetBackbone(block, layers).load_state_dict(port, strict=True)


def test_retinanet_converter_matches_jax():
    det = _DetRefDict()
    det.retinanet("detector.", num_classes=3)
    sd = fill_det(det, seed=26)
    port = tzoo.convert_retinanet_state(sd, prefix="detector.")
    assert_same_state_dict(port, from_jax_params(jtw.convert_retinanet_state(sd, "detector.")))
    from icm_tpu_torch.tasks import RetinaNet

    RetinaNet(num_classes=3).load_state_dict(port, strict=True)
