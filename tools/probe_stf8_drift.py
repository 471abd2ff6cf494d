"""Where the port's float32 error along the full-width stf8's slice chain
parts from the JAX package's, module by module (CPU, JAX and the port).

    JAX_PLATFORMS=cpu python tools/probe_stf8_drift.py [--size 128] [--out drift.json]
    JAX_PLATFORMS=cpu python tools/probe_stf8_drift.py --ops [--trials 20]

The full-width ``stf8`` (the registry's preset) on one ``--size`` image, the
weights of ``tests/test_torch_stf_family.py::
test_full_width_stf8_eval_forward_matches_jax`` (drawn in float32, seed 4;
image seed 3). JAX's eval forward runs twice under ``jax.jit`` with
``capture_intermediates``: in float32 and, under ``enable_x64``, in
float64, the reference (the port's float64 forward agrees with it to
1e-13, ``CHANGES.md``). The port's float32 forward records the output of
every module whose name is also a path of JAX's tree (``cc_mean_3``,
``mu_refine_3.stage1.block0.mlp`` ...; NCHW outputs compared as NHWC).

For every such module it prints, in the order the forward runs them, the
largest error of each float32 forward against the float64 reference,
relative to the reference's largest value (JAX's ``e_jax``, the port's
``e_port``), and per slice the errors of its mu, scale and LRP refiners'
outputs (a slice's y_hat is its symbols plus mu plus 0.5 tanh of the
LRP output, so where the symbols agree its error is theirs).
The first slice, and the first module in it, where ``e_port`` passes
``--factor`` times ``e_jax`` (and 1e-7) is where the port's error parts
from JAX's.

``--ops`` instead holds each op of the refiners' Swin blocks apart, on
the same float32 inputs in both packages (random, at the refiners'
sizes: 256 tokens of 64 channels, 4 heads of 16 over windows of 64
tokens): the dense product, LayerNorm, exact GELU (ATen's CPU kernel,
which the port's layers call, and XLA's form ``x / 2 * erfc(-x /
sqrt 2)`` computed in torch), softmax and window attention,
each one's own rounding against float64 (mean over ``--trials`` draws of
the largest error relative to the largest value).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=()):
    """flax intermediates -> {dotted module path: first output array}."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            val = v[0] if isinstance(v, (tuple, list)) else v
            while isinstance(val, (tuple, list)):
                val = val[0]
            if hasattr(val, "shape"):  # not the model's output dict
                out[".".join(prefix)] = np.asarray(val, np.float64)
        elif isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
    return out


def _as_ref_layout(a: np.ndarray, ref: np.ndarray):
    if a.shape == ref.shape:
        return a
    if a.ndim == 4 and a.transpose(0, 2, 3, 1).shape == ref.shape:
        return a.transpose(0, 2, 3, 1)
    if a.size == ref.size:
        return a.reshape(ref.shape)
    return None


def _rel(a, ref) -> float:
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _op_errors(trials: int) -> dict:
    """Each refiner op's own float32 rounding in both packages (``--ops``)."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    from flax import linen as fnn

    from icm_tpu.nn.pallas_kernels import window_attention_reference as jax_attention
    from icm_tpu_torch.nn.layers import LayerNorm
    from icm_tpu_torch.nn.window_attention import window_attention_reference

    rng = np.random.default_rng(0)
    ln_t = LayerNorm(64)
    with torch.no_grad():
        ln_t.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(64)))
        ln_t.bias.copy_(torch.from_numpy(0.05 * rng.standard_normal(64)))
    ln_params = {"params": {"scale": ln_t.weight.detach().numpy(),
                            "bias": ln_t.bias.detach().numpy()}}
    ln_j = fnn.LayerNorm(epsilon=1e-5)
    w = (rng.standard_normal((64, 192)) / 8).astype(np.float32)

    def attention_inputs():
        q, k, v = (rng.standard_normal((4, 4, 64, 16)).astype(np.float32) for _ in range(3))
        bias = (0.02 * rng.standard_normal((1, 4, 64, 64))).astype(np.float32)
        return q, k, v, bias, np.zeros(4, np.int32)

    ops = {
        "dense": (lambda: (rng.standard_normal((256, 64)).astype(np.float32),),
                  lambda x: jnp.dot(x, w),
                  lambda x: F.linear(x, torch.from_numpy(w.T.copy()).to(x.dtype))),
        "layernorm": (lambda: ((1 + 3 * rng.standard_normal((256, 64))).astype(np.float32),),
                      lambda x: ln_j.apply(jax.tree_util.tree_map(
                          lambda a: jnp.asarray(a, x.dtype), ln_params), x),
                      lambda x: F.layer_norm(x, (64,), ln_t.weight.to(x.dtype),
                                             ln_t.bias.to(x.dtype), 1e-5)),
        # ATen's own CPU GELU kernel, which the port's layers call
        "gelu_aten": (lambda: (3 * rng.standard_normal((256, 256)).astype(np.float32),),
                      lambda x: jax.nn.gelu(x, approximate=False), F.gelu),
        # XLA's form of the same function, in torch
        "gelu_erfc": (lambda: (3 * rng.standard_normal((256, 256)).astype(np.float32),),
                      lambda x: jax.nn.gelu(x, approximate=False),
                      lambda x: 0.5 * x * torch.erfc(x * -0.7071067811865476)),
        "softmax": (lambda: (3 * rng.standard_normal((64, 64)).astype(np.float32),),
                    lambda x: jax.nn.softmax(x, axis=-1), lambda x: torch.softmax(x, -1)),
        "window_attention": (attention_inputs, jax_attention,
                             lambda *a: window_attention_reference(*a)),
    }
    out = {}
    for name, (draw, jfn, tfn) in ops.items():
        ej, et = [], []
        for _ in range(trials):
            ins = draw()
            with jax.enable_x64(True):
                ref = np.asarray(jfn(*(jnp.asarray(a.astype(np.float64) if a.dtype == np.float32
                                                   else a) for a in ins)))
            j32 = np.asarray(jax.jit(jfn)(*map(jnp.asarray, ins)), np.float64)
            with torch.no_grad():
                t32 = tfn(*map(torch.from_numpy, ins)).double().numpy()
            ej.append(_rel(j32, ref))
            et.append(_rel(t32, ref))
        out[name] = {"e_jax": float(np.mean(ej)), "e_port": float(np.mean(et))}
        print(f"  {name}: jax {out[name]['e_jax']:.2e} port {out[name]['e_port']:.2e} "
              f"(port / jax {out[name]['e_port'] / out[name]['e_jax']:.2f})", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--factor", type=float, default=3.0)
    ap.add_argument("--ops", action="store_true", help="each refiner op alone (module doc)")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--out", help="write every module's errors here as JSON")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if args.ops:
        print("each op's float32 rounding against float64, the same inputs:")
        errors = _op_errors(args.trials)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(errors, f, indent=1)
        return 0
    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_stf import _params_from_numpy

    from icm_tpu.models import ZigzagSwinCodec as JaxZigzag
    from icm_tpu.models import models as jax_models
    from icm_tpu_torch import models as tmodels
    from icm_tpu_torch.convert import from_jax_params

    t0 = time.time()
    x = np.random.default_rng(3).random((1, args.size, args.size, 3)).astype(np.float32)
    jm = JaxZigzag(**jax_models["stf8"][1])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jax.device_get(_params_from_numpy(jm, x, seed=4)["params"]))
    capture = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False,
                                            capture_intermediates=True, mutable=["intermediates"]))
    _, inter = capture(params, jnp.asarray(x))
    j32 = _flat(jax.device_get(inter)["intermediates"])
    print(f"JAX float32: {len(j32)} modules ({time.time() - t0:.0f}s)", flush=True)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64), params)
        _, inter = capture(p64, jnp.asarray(x.astype(np.float64)))
        j64 = _flat(jax.device_get(inter)["intermediates"])
    print(f"JAX float64 ({time.time() - t0:.0f}s)", flush=True)

    tm = tmodels.create_model("stf8", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    tm.eval()
    port, order = {}, []

    def hook(name):
        def record(module, inputs, out):
            while isinstance(out, (tuple, list)):
                out = out[0]
            if isinstance(out, torch.Tensor) and name not in port:
                port[name] = out.detach().double().numpy()
                order.append(name)
        return record

    for name, mod in tm.named_modules():
        if name in j64:
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    print(f"port float32: {len(port)} of JAX's modules recorded ({time.time() - t0:.0f}s)",
          flush=True)

    rows = []
    for name in order:
        ref = j64[name]
        a = _as_ref_layout(port[name], ref)
        if a is None or j32[name].shape != ref.shape:
            continue
        rows.append({"module": name, "e_jax": _rel(j32[name], ref), "e_port": _rel(a, ref)})

    def slice_of(name):
        head = name.split(".")[0]
        tail = head.rsplit("_", 1)
        return int(tail[1]) if len(tail) == 2 and tail[1].isdigit() else None

    # per slice: the refiners' outputs (mu, scale, the LRP term's argument)
    per_slice = []
    n = tm.ctx_slices
    for i in range(n):
        entry = {"slice": i}
        for what, mod in (("mu", f"mu_refine_{i}"), ("scale", f"sigma_refine_{i}"),
                          ("lrp", f"lrp_refine_{i}")):
            if mod in j64 and mod in port:
                ref = j64[mod]
                entry[what] = {"e_jax": _rel(j32[mod], ref),
                               "e_port": _rel(_as_ref_layout(port[mod], ref), ref)}
        per_slice.append(entry)

    first = None
    for r in rows:
        if r["e_port"] > max(args.factor * r["e_jax"], 1e-7):
            first = r
            break
    print("per slice (relative to the float64 reference's max):")
    for e in per_slice:
        print("  slice {slice}: ".format(**e) + "; ".join(
            f"{k} jax {v['e_jax']:.2e} port {v['e_port']:.2e}"
            for k, v in e.items() if k != "slice"))
    print("modules of the first slice where the port parts from JAX "
          f"(e_port > {args.factor:g} x e_jax):")
    if first is None:
        print("  none")
    else:
        s = slice_of(first["module"])
        for r in rows:
            if slice_of(r["module"]) == s:
                print(f"  {r['module']}: jax {r['e_jax']:.2e} port {r['e_port']:.2e}")
        print(f"first: {first}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"size": args.size, "modules": rows, "per_slice": per_slice,
                       "first": first}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
