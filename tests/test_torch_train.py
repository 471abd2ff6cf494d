"""The port's RD training slice against the JAX package's.

Entropy training forwards and the aux loss, the RD loss, the dual
optimizer, the schedules, checkpoints, and one whole training step of the
narrow WACNN (``NARROW``, 2 x 64 x 64) against ``jax.value_and_grad`` of
the JAX step's loss and the JAX step itself, with weights carried by
``from_jax_params``. Uniform noise cannot come from the same generator on
both sides, so one set of noise arrays, drawn with numpy, is replayed into
both in call order (the bottleneck's (C, 1, N) first, then the y slices,
NHWC on the JAX side and NCHW on the port's) by patching ``quantize`` in
the entropy modules of both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_cnn_codec import NARROW, _params_from_numpy

import icm_tpu.entropy.bottleneck as jeb
import icm_tpu.entropy.gaussian as jgc
import icm_tpu_torch.entropy.bottleneck as teb
import icm_tpu_torch.entropy.gaussian as tgc
from icm_tpu.entropy import EntropyBottleneck as JaxEB
from icm_tpu.entropy import GaussianConditional as JaxGC
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu.train import compute_bpp as jax_compute_bpp
from icm_tpu.train.optim import TrainState as JaxTrainState
from icm_tpu.train.optim import _label_params
from icm_tpu.train.optim import make_optimizer as jax_make_optimizer
from icm_tpu.train.schedule import PolyLR as JaxPolyLR
from icm_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.entropy import EntropyBottleneck, GaussianConditional
from icm_tpu_torch.train import engine

torch.set_num_threads(2)

# f32 on both sides, sums in another order: a few ulps of O(1) values
TOL = 1e-5


class NoiseReplay:
    """Stands in for ``quantize`` in the entropy modules: "noise" mode adds
    the next array of ``noise`` (JAX layout) to the inputs; every other mode
    goes to the real function."""

    def __init__(self, noise, real, to_port: bool):
        self.noise, self.real, self.to_port = noise, real, to_port
        self.i = 0

    def __call__(self, inputs, mode, means=None, **kw):
        if mode != "noise":
            return self.real(inputs, mode, means, **kw)
        n = self.noise[self.i]
        self.i += 1
        if self.to_port:
            if n.ndim == 4:  # y slice: NHWC -> NCHW
                n = n.transpose(0, 3, 1, 2)
            n = torch.from_numpy(np.ascontiguousarray(n))
        assert tuple(n.shape) == tuple(inputs.shape), (n.shape, inputs.shape)
        return inputs + n


def _replay(monkeypatch, noise):
    """Patch both packages; returns the port's and JAX's replays (reset
    ``.i`` to replay again)."""
    j = NoiseReplay(noise, jeb.quantize, to_port=False)
    t = NoiseReplay(noise, teb.quantize, to_port=True)
    monkeypatch.setattr(jeb, "quantize", j)
    monkeypatch.setattr(jgc, "quantize", j)
    monkeypatch.setattr(teb, "quantize", t)
    monkeypatch.setattr(tgc, "quantize", t)
    return t, j


def _close(a, b, tol, name=""):
    """max |a - b| relative to max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:g}"
    return err


# --- entropy models ---------------------------------------------------------


def test_noise_quantize_draws_from_the_generator():
    x = torch.zeros(3, 4, 5)
    a = teb.quantize(x, "noise", generator=torch.Generator().manual_seed(7))
    b = teb.quantize(x, "noise", generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    with pytest.raises(ValueError, match="Generator"):
        teb.quantize(x, "noise")


def test_bottleneck_training_forward_and_aux_loss_match_jax(monkeypatch):
    C, rng = 16, np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 6, C))).astype(np.float32)
    jm = JaxEB(C)
    params = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    noise = [rng.uniform(-0.5, 0.5, (C, 1, 2 * 5 * 6)).astype(np.float32)]
    t, j = _replay(monkeypatch, noise)

    ref_out, ref_lik = jm.apply({"params": params}, jnp.asarray(x), training=True,
                                rngs={"noise": jax.random.PRNGKey(2)})
    port = EntropyBottleneck(C)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    out, lik = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                    generator=torch.Generator())
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), ref_out, atol=TOL)
    np.testing.assert_allclose(lik.permute(0, 2, 3, 1).detach().numpy(), ref_lik,
                               atol=TOL, rtol=TOL)

    ref_aux, ref_grad = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, method=jm.aux_loss))(params)
    aux = port.aux_loss()
    aux.backward()
    _close(aux.item(), ref_aux, TOL, "aux_loss")
    _close(port.quantiles.grad.numpy(), ref_grad["quantiles"], TOL, "d quantiles")
    # the density parameters are held fixed in the aux loss
    assert all(p.grad is None for n, p in port.named_parameters() if n != "quantiles")
    assert all(float(jnp.abs(g).max()) == 0 for n, g in ref_grad.items() if n != "quantiles")


def test_gaussian_training_likelihood_matches_jax(monkeypatch):
    rng = np.random.default_rng(1)
    shape = (2, 4, 5, 8)
    y, scales, means = (rng.standard_normal(shape).astype(np.float32) * s
                        for s in (3.0, 1.0, 1.0))
    scales = np.abs(scales)
    noise = [rng.uniform(-0.5, 0.5, shape).astype(np.float32)]
    _replay(monkeypatch, noise)
    ref_out, ref_lik = JaxGC().apply({}, *map(jnp.asarray, (y, scales, means)),
                                     training=True, rngs={"noise": jax.random.PRNGKey(0)})
    nchw = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
            for a in (y, scales, means)]
    out, lik = GaussianConditional()(*nchw, generator=torch.Generator())
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref_out, atol=TOL)
    np.testing.assert_allclose(lik.permute(0, 2, 3, 1).numpy(), ref_lik, atol=TOL, rtol=TOL)


# --- losses, optimizer, schedules -------------------------------------------


def test_rd_loss_and_bpp_match_jax():
    rng = np.random.default_rng(2)
    x = rng.random((2, 16, 16, 3)).astype(np.float32)
    out = {"x_hat": rng.random(x.shape).astype(np.float32),
           "likelihoods": {"y": rng.uniform(1e-3, 1, (2, 1, 1, 8)).astype(np.float32),
                           "z": rng.uniform(1e-3, 1, (2, 1, 1, 4)).astype(np.float32)}}
    ref = JaxRD(0.01)(jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(x))
    got = ttrain.RateDistortionLoss(0.01)(
        jax.tree_util.tree_map(torch.from_numpy, out), torch.from_numpy(x))
    for k in ("loss", "bpp_loss", "mse_loss"):
        _close(got[k].item(), ref[k], TOL, k)
    _close(ttrain.compute_bpp({k: torch.from_numpy(v) for k, v in out["likelihoods"].items()},
                              512).item(),
           jax_compute_bpp(jax.tree_util.tree_map(jnp.asarray, out["likelihoods"]), 512),
           TOL, "compute_bpp")


class _Tiny(torch.nn.Module):
    """Parameters named as in a model with a task network: g_a.Conv_0,
    entropy_bottleneck, task_net."""

    def __init__(self):
        super().__init__()
        self.g_a = torch.nn.Module()
        self.g_a.Conv_0 = torch.nn.Module()
        self.g_a.Conv_0.kernel = torch.nn.Parameter(torch.zeros(3, 4))
        self.entropy_bottleneck = torch.nn.Module()
        self.entropy_bottleneck.quantiles = torch.nn.Parameter(torch.zeros(4, 1, 3))
        self.entropy_bottleneck.bias0 = torch.nn.Parameter(torch.zeros(4, 3, 1))
        self.task_net = torch.nn.Module()
        self.task_net.w = torch.nn.Parameter(torch.zeros(5))

    def tree(self, values):
        """The same parameters as the nested dict a flax tree is."""
        out = {}
        for name, p in self.named_parameters():
            node = out
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = values[name]
        return out


def _flat(tree):
    """A flax-style nested dict -> {dotted name: leaf}."""
    return {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("freeze,train", [((), None), (("task_net",), None),
                                          ((), ("g_a", "Conv"))])
def test_optimizer_labels_match_jax(freeze, train):
    m = _Tiny()
    labels = ttrain.label_params(m, freeze, train)
    ref = _label_params(m.tree({n: np.zeros(1) for n in labels}), freeze, train)
    assert labels == _flat(ref)


@pytest.mark.parametrize("main_scale", [0.05, 50.0])
def test_optimizer_steps_match_optax_with_main_only_clip(main_scale):
    """Two steps of the dual optimizer against optax's multi_transform on the
    same gradients. The aux and frozen gradients are large; the clip must
    not count them (main_scale 0.05: main norm under 1, no clipping)."""
    m = _Tiny()
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in m.named_parameters()}
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    opt = ttrain.make_optimizer(m, 1e-2, 1e-1, 1.0, freeze_patterns=("task_net",))
    tx = jax_make_optimizer(1e-2, 1e-1, 1.0, freeze_patterns=("task_net",))
    params = m.tree({n: jnp.asarray(v) for n, v in init.items()})
    opt_state = tx.init(params)
    for _ in range(2):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) *
                 (main_scale if n.startswith("g_a") else 100.0)
                 for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        opt.step()
        updates, opt_state = tx.update(m.tree({n: jnp.asarray(g) for n, g in grads.items()}),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
    # optax forms Adam's bias corrections 1 - b**t in float32 (1 - 0.999 is
    # off by 1.3e-5 relative there), torch in float64: the moves agree to
    # 2e-5 of their size
    ref = _flat(params)
    for n, p in m.named_parameters():
        moved, ref_moved = p.detach().numpy() - init[n], np.asarray(ref[n]) - init[n]
        _close(moved, ref_moved, 2e-5, n) if np.abs(ref_moved).max() else None
    np.testing.assert_array_equal(m.task_net.w.detach().numpy(), init["task_net.w"])


def test_plateau_lowers_only_the_main_rate():
    m = _Tiny()
    opt = ttrain.make_optimizer(m, 1e-4, 1e-3)
    opt.set_learning_rate(1e-5)
    assert [g["lr"] for g in opt.groups["main"].param_groups] == [1e-5]
    assert [g["lr"] for g in opt.groups["aux"].param_groups] == [1e-3]


def test_schedules_match_jax():
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 4.3, 3.0, 3.0, 3.1, 3.2, 3.3, 3.3]
    for kw in (dict(patience=2), dict(patience=1, factor=0.5, cooldown=2, min_lr=2e-5)):
        ours, ref = ttrain.ReduceLROnPlateau(1e-4, **kw), JaxPlateau(1e-4, **kw)
        assert [ours.step(v) for v in metrics] == [ref.step(v) for v in metrics]
    ours, ref = ttrain.PolyLR(0.01, 10, min_lr=1e-4), JaxPolyLR(0.01, 10, min_lr=1e-4)
    assert [ours(s) for s in range(13)] == [ref(s) for s in range(13)]


# --- one training step of the narrow WACNN ----------------------------------


@pytest.fixture(scope="module")
def narrow():
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm = JaxWACNN(**NARROW)
    params = jax.device_get(_params_from_numpy(jm, x, seed=1)["params"])
    rng = np.random.default_rng(5)
    noise = [rng.uniform(-0.5, 0.5, (NARROW["hyper_enc_widths"][-1], 1, 2)).astype(np.float32)]
    sc = NARROW["M"] // NARROW["num_slices"]
    noise += [rng.uniform(-0.5, 0.5, (2, 4, 4, sc)).astype(np.float32)
              for _ in range(NARROW["num_slices"])]
    return jm, params, x, noise


def _port_model(params):
    tm = tmodels.create_model("cnn", device="cpu", **NARROW)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return tm


def test_train_step_matches_jax(narrow, monkeypatch):
    jm, params, x, noise = narrow
    tr, jr = _replay(monkeypatch, noise)
    criterion, jcrit = ttrain.RateDistortionLoss(0.01), JaxRD(0.01)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):  # the loss of icm_tpu.train.steps.make_train_step
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": key, "dropout": key})
        rd = jcrit(out, jnp.asarray(x))
        aux = jm.apply({"params": p}, method=jm.aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    # jitted: traced once, with the replayed noise as constants
    (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert jr.i == len(noise)

    tm = _port_model(params)
    out = tm(torch.from_numpy(x), generator=torch.Generator())
    rd = criterion(out, torch.from_numpy(x))
    aux = tm.aux_loss()
    (rd["loss"] + aux).backward()
    assert tr.i == len(noise)
    # f32 through ~60 layers and the log-likelihoods, sums in another order
    for k, v in {**rd, "aux_loss": aux}.items():
        _close(v.item(), ref_m[k], 1e-5, k)
    ref_grads = from_jax_params(jax.device_get(ref_g))
    worst = {}
    for name, p in tm.named_parameters():
        worst[name] = _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-4, name)
    print("largest gradient error relative to its max:",
          max(worst.items(), key=lambda kv: kv[1]))

    # one step: the JAX step's update (``TrainState.apply_gradients`` of
    # these gradients, as ``make_train_step`` does) against the port's whole
    # step. Adam's first move is lr * u / (|u| + eps), u = c g, with c the
    # main group's clip factor (1 for aux); here c brings u down to eps's
    # order, so the clip shows in the move. A gradient held to 1e-4 of its
    # leaf's max (above) moves u by at most c 1e-4 (max|g| + |g|), and the
    # move by that times lr eps / (|u| + eps)^2. Beside it: 2e-5 of the
    # moves' max (optax's f32 bias corrections, as in the optimizer test)
    # and an ulp of the new f32 parameter. Where that bound is under half
    # the move, as it is over most of every leaf, a lost update or a
    # skipped clip shows.
    tr.i = 0
    jstate = JaxTrainState.create(params, jax_make_optimizer(1e-4, 1e-3, 1.0))
    jstate = jax.jit(JaxTrainState.apply_gradients)(jstate, ref_g)
    tm = _port_model(params)
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
    metrics = ttrain.make_train_step(tm, criterion)(state, torch.from_numpy(x),
                                                    torch.Generator())
    assert state.step == int(jstate.step) == 1
    for k, v in metrics.items():
        _close(v.item(), ref_m[k], 1e-5, k)
    new_ref = from_jax_params(jax.device_get(jstate.params))
    p0 = from_jax_params(params)
    labels = ttrain.label_params(tm)
    main_norm = float(np.sqrt(sum(float((ref_grads[n].double() ** 2).sum())
                                  for n in labels if labels[n] == "main")))
    eps, checked = 1e-8, {}
    for name, p in tm.named_parameters():
        lr, c = (1e-3, 1.0) if labels[name] == "aux" else (1e-4, min(1.0, 1.0 / main_norm))
        g = ref_grads[name].double().numpy()
        u = c * np.abs(g)
        du = c * 1e-4 * (np.abs(g).max() + np.abs(g))
        ref_moved = (new_ref[name] - p0[name]).double().numpy()
        moved = (p.detach() - p0[name]).double().numpy()
        bound = (lr * eps * du / (u + eps) ** 2 + 2e-5 * np.abs(ref_moved).max()
                 + np.spacing(np.abs(new_ref[name].numpy())))
        err = np.abs(moved - ref_moved)
        assert (err <= bound).all(), (name, float((err - bound).max()))
        tight = bound < 0.5 * np.abs(ref_moved)
        assert tight.mean() > 0.05, (name, float(tight.mean()))
        checked[name] = float(tight.mean())
    print(f"main clip factor {min(1.0, 1.0 / main_norm):.3e}; least share of a leaf "
          "held under half its move:", min(checked.items(), key=lambda kv: kv[1]))


# --- the engine ---------------------------------------------------------------


def _engine_kwargs(tmp_path, x, **kw):
    return dict(model=kw.pop("model"), criterion=ttrain.RateDistortionLoss(0.01),
                make_step=kw.pop("make_step", ttrain.make_train_step),
                train_batches=lambda epoch: iter([x, x]), eval_batches=lambda: iter([x]),
                save_path=str(tmp_path / "ckpt" / "best.pt"), log_every=1, **kw)


def test_run_training_end_to_end_with_checkpoint_and_resume(narrow, tmp_path):
    _, params, x, _ = narrow
    tm = _port_model(params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state, history = ttrain.run_training(**_engine_kwargs(tmp_path, x[:1], model=tm, epochs=1))
    assert state.step == 2 and len(history) == 1 and np.isfinite(history[0])
    assert all(not torch.equal(before[n], p) for n, p in tm.named_parameters()
               if n.startswith("g_a") or n.endswith("quantiles"))

    # the checkpoint round-trips into a fresh model and optimizer
    fresh = _port_model(params)
    fresh_state = ttrain.TrainState(fresh, ttrain.make_optimizer(fresh))
    fresh_state, meta = ttrain.load_checkpoint(str(tmp_path / "ckpt" / "best.pt"), fresh_state)
    assert meta == {"epoch": 0, "best_loss": history[0]} and fresh_state.step == 2
    for (n, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    saved = state.optimizer.state_dict()["main"]["state"]
    loaded = fresh_state.optimizer.state_dict()["main"]["state"]
    assert all(torch.equal(saved[k]["exp_avg"], loaded[k]["exp_avg"]) for k in saved)

    # resume: epoch 1 only, from step 2
    resumed, history2 = ttrain.run_training(**_engine_kwargs(
        tmp_path, x[:1], model=fresh, epochs=2,
        checkpoint=str(tmp_path / "ckpt" / "best.pt")))
    assert resumed.step == 4 and len(history2) == 1


def test_run_training_with_recovery_resumes_after_a_failure(narrow, tmp_path):
    _, params, x, _ = narrow
    calls = []

    def flaky_make_step(model, criterion):
        inner = ttrain.make_train_step(model, criterion)

        def step(state, batch, generator):
            calls.append(state.step)
            if state.step == 2 and calls.count(2) == 1:
                raise RuntimeError("injected failure")
            return inner(state, batch, generator)

        return step

    state, history = ttrain.run_training_with_recovery(
        max_retries=1, **_engine_kwargs(tmp_path, x[:1], model=_port_model(params),
                                        make_step=flaky_make_step, epochs=2))
    # epoch 0 ran and was saved; epoch 1 failed at its first step, was
    # resumed from the checkpoint and finished
    assert calls == [0, 1, 2, 2, 3] and state.step == 4 and len(history) == 1
    assert os.path.exists(tmp_path / "ckpt" / "best.pt")


def test_resume_steps_at_the_argument_rates(narrow, tmp_path, monkeypatch):
    """A checkpoint saved after the plateau lowered the main rate resumes at
    the rates ``run_training`` is given, as the JAX package rebuilds ``tx``
    from its arguments: both groups step at them, and the plateau scheduler,
    which restarts at ``learning_rate``, agrees with the optimizer."""
    _, params, x, _ = narrow
    tm = _port_model(params)
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3))
    ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
        state, torch.from_numpy(x[:1]), torch.Generator().manual_seed(0))
    state.optimizer.set_learning_rate(5e-5)  # a plateau decay before the save
    ckpt = str(tmp_path / "decayed.pt")
    ttrain.save_checkpoint(ckpt, state, {"epoch": 0, "best_loss": 1e9})
    saved = state.optimizer.state_dict()

    scheds, rates = [], []

    class RecordedPlateau(ttrain.ReduceLROnPlateau):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            scheds.append(self)

    def recording_make_step(model, criterion):
        inner = ttrain.make_train_step(model, criterion)

        def step(st, batch, generator):
            rates.append({k: [g["lr"] for g in opt.param_groups]
                          for k, opt in st.optimizer.groups.items()})
            return inner(st, batch, generator)

        return step

    monkeypatch.setattr(engine, "ReduceLROnPlateau", RecordedPlateau)
    resumed, _ = ttrain.run_training(**_engine_kwargs(
        tmp_path, x[:1], model=_port_model(params), make_step=recording_make_step,
        epochs=2, learning_rate=1e-4, aux_learning_rate=1e-3, checkpoint=ckpt))
    assert resumed.step == 3 and len(rates) == 2
    assert rates == [{"main": [1e-4], "aux": [1e-3]}] * 2
    assert len(scheds) == 1 and scheds[0].lr == 1e-4
    # the moments and step counts came back from the checkpoint
    loaded = resumed.optimizer.groups["main"].state
    assert all(int(s["step"]) == 3 for s in loaded.values())
    assert all(int(s["step"]) == 1 for s in saved["main"]["state"].values())
