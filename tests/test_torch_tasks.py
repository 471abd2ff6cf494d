"""The task networks of icm_tpu_torch against the JAX package's
``icm_tpu.tasks`` and ``icm_tpu.eval.metrics``.

At ``tests/test_tasks.py``'s size (64 x 64 images, ``layers=(1, 1, 1,
1)``, ``num_classes=4``): the ResNet backbones (basic and bottleneck
blocks at output strides 32, 16 and 8) and the P3-P7 pyramid within 1e-5
of flax, RetinaNet's 5-tuple within 1e-4 with the anchors equal, the
numpy box utilities, ``decode_detections``, ``focal_loss``,
``compute_map`` and ``csv_eval_ap`` against JAX's on seeded inputs, the
frozen BatchNorm untouched by ``model.train()``, and ``create_model``'s
BatchNorm and classification-prior inits. Parameters are drawn with numpy
at the shapes of the flax init (``jax.eval_shape``), BatchNorm's scale,
bias and statistics moved off their init so that the comparison sees
them; the flax modules run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.eval import metrics as jmetrics
from icm_tpu.tasks import anchors as janchors
from icm_tpu.tasks import fpn as jfpn
from icm_tpu.tasks import losses as jlosses
from icm_tpu.tasks import resnet as jresnet
from icm_tpu.tasks import retinanet as jretinanet
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import tasks
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(2)

# f32 on both sides, sums in another order
MODULE_TOL = 1e-5
RETINANET_TOL = 1e-4


def draw_variables(shapes, seed: int) -> dict:
    """Variables at the shapes of a flax init (``jax.eval_shape``'s tree):
    fan-in scaled kernels, small biases, BatchNorm scales near 1, means
    near 0 and variances of 1 to 2."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return 1.0 + np.abs(n)
        return 0.1 * n  # bias, mean

    return jax.device_get(jax.tree_util.tree_map_with_path(draw, shapes))


def flax_twin(module, x, seed: int, **apply_kw):
    """-> (variables drawn at the module's init shapes, its output on x)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    variables = draw_variables(shapes, seed)
    return variables, module.apply(variables, x, **apply_kw)


def load(module, variables):
    module.load_state_dict(from_jax_params(variables), strict=True)
    return module.eval()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def image(seed: int = 0, size: int = 64, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).random((batch, size, size, 3)).astype(np.float32)


def _assert_close(got, want, tol, name=""):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    print(f"{name}: max |port - JAX| {err:.2e} (max |JAX| {float(np.abs(want).max()):.2e})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


# --- modules against flax ---------------------------------------------------------


@pytest.mark.parametrize("output_stride", [32, 16, 8])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_backbone_matches_flax(block, output_stride):
    x = image(1)
    jm = jresnet.ResNetBackbone(block=block, layers=(1, 1, 1, 1), output_stride=output_stride)
    variables, ref = flax_twin(jm, jnp.asarray(x), seed=2)
    tm = load(tasks.ResNetBackbone(block, (1, 1, 1, 1), output_stride), variables)
    with torch.no_grad():
        feats = tm(nchw(x))
    assert len(feats) == len(ref) == 4
    for i, (a, b) in enumerate(zip(feats, ref)):
        assert nhwc(a).shape == b.shape
        _assert_close(nhwc(a), b, MODULE_TOL, f"{block} os {output_stride} C{i + 2}")


def test_resnet50_shapes_and_parameters():
    """ResNet-50 without ``fc``: 23.5 M parameters, 53 BatchNorm layers and
    flax's auto-names; the strides of each stage."""
    with torch.device("meta"):
        m = tasks.resnet50()
    assert sum(p.numel() for p in m.parameters()) == 23_508_032
    assert sum(isinstance(b, tasks.FrozenBatchNorm2d) for b in m.modules()) == 53
    assert hasattr(m, "layer3_5") and hasattr(m.layer1_0, "Conv_3")
    assert not hasattr(m.layer1_1, "Conv_3")
    with torch.no_grad():
        feats = tasks.resnet18()(torch.zeros(1, 3, 64, 64))
    assert [tuple(f.shape) for f in feats] == [(1, 64, 16, 16), (1, 128, 8, 8),
                                               (1, 256, 4, 4), (1, 512, 2, 2)]


def test_pyramid_features_match_flax():
    rng = np.random.default_rng(3)
    c3, c4, c5 = (rng.standard_normal((2, s, s, c)).astype(np.float32)
                  for s, c in ((8, 128), (4, 256), (2, 512)))
    jm = jfpn.PyramidFeatures()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [c3, c4, c5]))
    variables = draw_variables(shapes, 4)
    ref = jm.apply(variables, [jnp.asarray(c) for c in (c3, c4, c5)])
    tm = load(tasks.PyramidFeatures((128, 256, 512)), variables)
    with torch.no_grad():
        out = tm([nchw(c) for c in (c3, c4, c5)])
    assert [nhwc(p).shape for p in out] == [r.shape for r in ref] == [
        (2, 8, 8, 256), (2, 4, 4, 256), (2, 2, 2, 256), (2, 1, 1, 256), (2, 1, 1, 256)]
    for i, (a, b) in enumerate(zip(out, ref)):
        _assert_close(nhwc(a), b, MODULE_TOL, f"P{i + 3}")


def test_upsample_nearest_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 5)).astype(np.float32)
    ref = np.asarray(jfpn._upsample_nearest(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tasks.upsample_nearest(nchw(x))), ref)


@pytest.fixture(scope="module")
def retinanet():
    """(JAX RetinaNet, its variables, its 5-tuple, the port's, x) at
    tests/test_tasks.py's size."""
    x = image(6)
    jm = jretinanet.RetinaNet(num_classes=4, block="basic", layers=(1, 1, 1, 1))
    variables, ref = flax_twin(jm, jnp.asarray(x), seed=7)
    tm = load(tasks.RetinaNet(num_classes=4, block="basic", layers=(1, 1, 1, 1)), variables)
    return jm, variables, ref, tm, x


def test_retinanet_matches_flax(retinanet):
    """The 5-tuple: C2, [C3, C4, C5] (NHWC), classification and regression
    (B, A, K | 4) within 1e-4, the anchors equal. The heads' rows run over
    (level, y, x, anchor) as the anchors do: a row order from the NCHW
    maps would keep the shapes and break these."""
    _, _, ref, tm, x = retinanet
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    c2, feats, cls, reg, anchors = out
    _assert_close(c2.numpy(), ref[0], RETINANET_TOL, "compressH (C2)")
    for i, (a, b) in enumerate(zip(feats, ref[1])):
        _assert_close(a.numpy(), b, RETINANET_TOL, f"C{i + 3}")
    A = 9 * (8 * 8 + 4 * 4 + 2 * 2 + 1 + 1)
    assert tuple(cls.shape) == (2, A, 4) and tuple(reg.shape) == (2, A, 4)
    _assert_close(cls.numpy(), ref[2], RETINANET_TOL, "classification")
    _assert_close(reg.numpy(), ref[3], RETINANET_TOL, "regression")
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(ref[4]))
    assert anchors.dtype == torch.float32


def test_retinanet_anchors_are_built_once_a_shape(retinanet):
    tm = retinanet[3]
    a = tm.anchors((64, 64), "cpu")
    assert tm.anchors((64, 64), "cpu") is a
    assert tm.anchors((128, 64), "cpu").shape[1] == 9 * (16 * 8 + 8 * 4 + 4 * 2 + 2 + 1)


def test_frozen_batchnorm_ignores_train(retinanet):
    """``model.train()`` changes neither the outputs nor the statistics."""
    _, _, _, tm, x = retinanet
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        ev = tm.eval()(torch.from_numpy(x))[2]
        tr = tm.train()(torch.from_numpy(x))[2]
    tm.eval()
    assert torch.equal(ev, tr)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_frozen_batchnorm_is_flax_inference_batchnorm():
    rng = np.random.default_rng(8)
    x = (3 * rng.standard_normal((2, 5, 6, 7))).astype(np.float32)
    import flax.linen as fnn

    jm = fnn.BatchNorm(use_running_average=True)
    variables = draw_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x)), 9)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.BatchNorm_0 = tasks.FrozenBatchNorm2d(7)
    bn = load(holder, {"params": {"BatchNorm_0": variables["params"]},
                       "batch_stats": {"BatchNorm_0": variables["batch_stats"]}}).BatchNorm_0
    _assert_close(nhwc(bn(nchw(x))), ref, MODULE_TOL, "BatchNorm")


# --- boxes, detections and losses ---------------------------------------------------


def test_anchors_and_box_utilities_match_jax():
    rng = np.random.default_rng(10)
    for hw in ((64, 64), (96, 160)):
        np.testing.assert_array_equal(tasks.Anchors()(hw), janchors.Anchors()(hw))
    anchors = tasks.Anchors()((64, 64))[0]
    deltas = rng.standard_normal(anchors.shape).astype(np.float32)
    boxes = tasks.bbox_transform(anchors, deltas)
    np.testing.assert_array_equal(boxes, janchors.bbox_transform(anchors, deltas))
    np.testing.assert_array_equal(tasks.clip_boxes(boxes, (48, 64)),
                                  janchors.clip_boxes(boxes, (48, 64)))
    scores = rng.random(len(boxes)).astype(np.float32)
    for t in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(tasks.nms_numpy(boxes, scores, t),
                                      janchors.nms_numpy(boxes, scores, t))


def _seeded_maps(seed: int, A: int, K: int = 4):
    """Classification scores with about 5% above 0.05 and regression deltas."""
    rng = np.random.default_rng(seed)
    cls = (0.06 * rng.random((2, A, K)) ** 4).astype(np.float32)
    cls[rng.random(cls.shape) < 0.02] += 0.5
    reg = (0.5 * rng.standard_normal((2, A, 4))).astype(np.float32)
    return cls, reg


def test_decode_detections_matches_jax():
    anchors = tasks.Anchors()((64, 64))
    cls, reg = _seeded_maps(11, anchors.shape[1])
    got = tasks.decode_batch(torch.from_numpy(cls), torch.from_numpy(reg),
                             torch.from_numpy(anchors), (60, 64))
    assert len(got) == 2
    for b in range(2):
        want = jretinanet.decode_detections(cls[b:b + 1], reg[b:b + 1], anchors, (60, 64))
        single = tasks.decode_detections(cls[b:b + 1], reg[b:b + 1], anchors, (60, 64))
        assert len(want[0]) > 10
        for g, s, w in zip(got[b], single, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(s, w)
    # nothing above the threshold: empty arrays of JAX's dtypes
    empty = tasks.decode_detections(np.zeros_like(cls[:1]), reg[:1], anchors, (64, 64))
    for g, w in zip(empty, jretinanet.decode_detections(np.zeros_like(cls[:1]), reg[:1],
                                                        anchors, (64, 64))):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_focal_loss_matches_jax(dtype):
    """Two images with ground truth (one box padded) and one without, on
    64 x 64 anchors: both terms within 1e-5 (float32) or 1e-12 (float64)."""
    anchors = tasks.Anchors()((64, 64))[0].astype(dtype)
    cls, reg = _seeded_maps(12, anchors.shape[0])
    cls = np.concatenate([cls, cls[:1]]).astype(dtype)
    reg = np.concatenate([reg, reg[:1]]).astype(dtype)
    ann = np.array([[[4, 4, 36, 30, 1], [20, 24, 60, 64, 3], [0, 0, 0, 0, -1]],
                    [[10, 2, 26, 20, 0], [0, 0, 0, 0, -1], [0, 0, 0, 0, -1]],
                    [[0, 0, 0, 0, -1]] * 3], dtype)
    with jax.enable_x64(dtype == np.float64):
        want = [float(v) for v in jlosses.focal_loss(*map(jnp.asarray, (cls, reg, anchors, ann)))]
    got = [float(v) for v in tasks.focal_loss(*map(torch.from_numpy, (cls, reg, anchors, ann)))]
    print(f"focal loss {dtype.__name__}: port {got}, JAX {want}")
    assert all(np.isfinite(got)) and got[0] > 0 and got[1] > 0
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_focal_loss_gradients_match_jax():
    anchors = tasks.Anchors()((64, 64))[0]
    cls, reg = _seeded_maps(13, anchors.shape[0])
    ann = np.array([[[4, 4, 36, 30, 2], [0, 0, 0, 0, -1]],
                    [[30, 30, 62, 60, 1], [8, 8, 40, 40, 0]]], np.float32)
    jg = jax.grad(lambda c, r: sum(jlosses.focal_loss(c, r, jnp.asarray(anchors),
                                                      jnp.asarray(ann))), argnums=(0, 1))(
        jnp.asarray(cls), jnp.asarray(reg))
    tc, tr = (torch.from_numpy(a).requires_grad_() for a in (cls, reg))
    sum(tasks.focal_loss(tc, tr, torch.from_numpy(anchors), torch.from_numpy(ann))).backward()
    for g, w, name in ((tc.grad, jg[0], "d classification"), (tr.grad, jg[1], "d regression")):
        scale = float(np.abs(np.asarray(w)).max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


# --- the detection evaluators -------------------------------------------------------


def _seeded_detections(seed: int, n_images: int = 6, K: int = 3):
    """Ground truth and detections near it (some moved, some spurious, some
    small, medium and large boxes), keyed by image id."""
    rng = np.random.default_rng(seed)
    gts, dets = {}, {}
    for i in range(n_images):
        G = int(rng.integers(0, 6))
        xy = rng.uniform(0, 400, (G, 2))
        wh = rng.choice([12.0, 50.0, 150.0], (G, 1)) * rng.uniform(0.7, 1.3, (G, 2))
        boxes = np.concatenate([xy, xy + wh], 1)
        labels = rng.integers(0, K, G)
        gts[i] = {"boxes": boxes, "labels": labels}
        keep = rng.random(G) < 0.8
        moved = boxes[keep] + rng.normal(0, 4, (int(keep.sum()), 4))
        D = int(rng.integers(0, 4))
        xy2 = rng.uniform(0, 400, (D, 2))
        spurious = np.concatenate([xy2, xy2 + rng.uniform(10, 100, (D, 2))], 1)
        dets[i] = {"boxes": np.concatenate([moved, spurious]),
                   "scores": rng.random(int(keep.sum()) + D),
                   "labels": np.concatenate([labels[keep], rng.integers(0, K, D)])}
    return dets, gts


def test_compute_map_matches_jax():
    dets, gts = _seeded_detections(14)
    got = tmetrics.compute_map(dets, gts, class_names={0: "a", 1: "b", 2: "c"})
    want = jmetrics.compute_map(dets, gts, class_names={0: "a", 1: "b", 2: "c"})
    assert got == want
    assert 0 < got["mAP"] < 1 and set(got["per_class_AP"]) <= {"a", "b", "c"}
    assert tmetrics.compute_map({}, {0: {"boxes": np.zeros((0, 4)), "labels": []}}) == \
        jmetrics.compute_map({}, {0: {"boxes": np.zeros((0, 4)), "labels": []}})


@pytest.mark.parametrize("iou", [0.5, 0.75])
def test_csv_eval_ap_matches_jax(iou):
    dets, gts = _seeded_detections(15)
    got = tmetrics.csv_eval_ap(dets, gts, num_classes=4, iou_threshold=iou)
    want = jmetrics.csv_eval_ap(dets, gts, num_classes=4, iou_threshold=iou)
    assert got == want and got[3] == (0.0, 0)
    assert any(ap > 0 for ap, _ in got.values())


# --- construction -------------------------------------------------------------------


def test_create_model_inits_batchnorm_and_the_classification_prior():
    """``create_model`` builds on the meta device and then materializes the
    tensors: every BatchNorm gets flax's init (scale 1, bias 0, mean 0, var
    1), the classification output flax's prior bias -log(0.99 / 0.01), the
    other conv biases 0; a cnn2 and a cnn of one seed share the codec."""
    tiny = dict(N=16, M=24, num_slices=6, max_support_slices=5,
                hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(12, 14, 16, 20, 24),
                cc_widths=(16, 12, 10, 8))
    m = tmodels.create_model("cnn2", device="cpu", seed=3, num_classes=4, task_block="basic",
                             task_layers=(1, 1, 1, 1), **tiny)
    bns = [b for b in m.modules() if isinstance(b, tasks.FrozenBatchNorm2d)]
    assert len(bns) == 12  # stem, 2 + 3 + 3 + 3 in the four single-block stages
    for b in bns:
        assert torch.equal(b.weight, torch.ones_like(b.weight))
        assert not b.bias.any() and not b.mean.any()
        assert torch.equal(b.var, torch.ones_like(b.var))
    out = m.studentNet.classification.output.bias
    assert torch.allclose(out, torch.full_like(out, -np.log(99.0)))
    assert not m.studentNet.regression.output.bias.any()
    assert not m.studentNet.fpn.P3_2.bias.any()
    cnn = tmodels.create_model("cnn", device="cpu", seed=3, **tiny)
    sd = m.state_dict()
    for k, v in cnn.state_dict().items():
        assert torch.equal(sd[k], v), k
