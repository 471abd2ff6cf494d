"""Smoke run of icm_tpu_torch on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It needs one CUDA card, nvcc and g++,
and exits non-zero (printing no result) without a card or without the
package beside it. Phases, each printed with its elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the window-attention and GDN kernels (nvcc, sm_90a) and the
   host rANS coder (g++), from the sources in the checkout, all at once;
3. window attention against its plain PyTorch version on the card, at
   the shapes of the full-width WACNN's path, in f32 and bf16, timed
   beside the plain version and F.scaled_dot_product_attention (a
   yardstick the port never calls);
4. the fused GDN forward and backward kernels against their plain
   versions at the training step's shapes (8 x 192 x 128^2, 64^2, 32^2,
   GDN and IGDN) and one ragged shape, timed beside the plain versions;
   two backward launches must give the same bits;
5. the full-width WACNN (N=192, M=320, 10 slices) on the card with
   weights drawn from ``--seed``: compress -> decompress of 2 images of
   512x512 made from ``--seed``. The kernel launch counts are zeroed
   right before and read right after each side. Asserts a bit-exact
   y_hat, the decoder's x_hat equal to the encoder's, a finite bpp, and
   window-attention and GDN-forward launches on both sides;
6. the same weights' eval forward on the card against the plain CPU path
   on a small input;
7. full-width WACNN training through ``train.run_training``: one epoch
   of 6 steps on seeded batches of 8 x 256 x 256, an eval batch, a
   checkpoint, and a resume for 2 more steps. Every step's loss, bpp and
   aux loss must be finite, the parameters must move, and each step must
   launch the three kernels (counts zeroed before it and read after it);
8. one training step of the trained weights on the card against the
   plain CPU path on a small input, with the same noise: the loss terms
   and every parameter's gradient.

It then prints the kernels line (JSON), the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result. Each kernel's ``bound_ms`` counts its
operations on the unit it runs them on (the f32 products of window
attention and of the GDN backward as three TF32 products each on the
tensor cores; the GDN forward on the f32 FMA units), against its bytes;
``f32_fma_bound_ms`` counts every operation at the f32 FMA rate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

# the card's published peaks (H100 SXM data sheet), for each kernel's bound:
# f32 on the FMA units, bf16 and TF32 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# the f32 products of window attention and of the GDN backward run on the
# tensor cores in 3xTF32: three TF32 products for each f32 product
TF32_PASSES = 3

# stated tolerances of the kernel against its plain version on the card:
# f32 sums of the same terms in another order (outputs O(1)); in bf16 the
# probabilities and the output are rounded to 8-bit mantissas, and a value
# on the other side of a rounding boundary moves the output by one ulp
# (2**-7 relative, outputs up to ~2)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}

# the GDN kernels against their plain versions: y and dx absolutely (sums
# of 192 products in another order, values O(1)); dgamma and dbeta
# relative to each tensor's max, since each is a sum over up to 131072
# rows, taken here in two fixed stages and by cuBLAS in its own order
GDN_TOLERANCE = {"y": 1e-5, "dx": 1e-5, "dgamma": 1e-4, "dbeta": 1e-4}
# one training step, card against CPU, each loss term and each gradient
# relative to its max: f32 on both, ~70 layers forward and back with sums
# in other orders (cuDNN and the kernels against oneDNN and the plain
# versions), through the log-likelihoods
TRAIN_TOLERANCE = 1e-3


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.time()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"phase {self.name}: {state} in {time.time() - self.t:.1f}s")
        return False


def cuda_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around it, the
    median of ``iters`` calls. Before each call the stream is held busy
    (``torch.cuda._sleep``) while the host enqueues the start event, the
    call and the end event, so the interval holds the device's work and
    not the host's launch overhead."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of spinning at H100 clocks
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(t_bytes: float, t_ops: float):
    """The larger of the two least times -> (ms, "bytes" | "operations")."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(W, H, N, D, n_cls, dtype: str):
    """Least time for the work: each input read once, the output written
    once, against the operations on the unit the kernel runs them on: the
    two products on the tensor cores (bf16; f32 as three TF32 products) and
    the softmax on the f32 units. -> (ms, "bytes" | "operations", and the
    f32-FMA bound: every operation at the f32 rate, (ms, by))."""
    elt = 4 if dtype == "float32" else 2
    nbytes = 4 * W * H * N * D * elt + n_cls * H * N * N * 4 + W * 4
    products = W * H * 4 * N * N * D
    softmax = W * H * 5 * N * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == "float32":
        t_mma = TF32_PASSES * products / PEAK_OPS_PER_S["tf32"] * 1e3
    else:
        t_mma = products / PEAK_OPS_PER_S["bfloat16"] * 1e3
    t_ops = t_mma + softmax / PEAK_OPS_PER_S["float32"] * 1e3
    fma = bound(t_bytes, (products + softmax) / PEAK_OPS_PER_S["float32"] * 1e3)
    return (*bound(t_bytes, t_ops), fma)


def attention_inputs(W, N, D, n_cls, dtype, seed):
    import torch

    rng = np.random.default_rng(seed)
    heads = 8
    q, k, v = (torch.from_numpy(rng.standard_normal((W, heads, N, D)).astype(np.float32))
               for _ in range(3))
    bias = rng.standard_normal((n_cls, heads, N, N)).astype(np.float32)
    if n_cls > 1:  # the -100 entries of the shifted-window mask
        bias[1:] += np.where(rng.random((n_cls - 1, 1, N, N)) < 0.3, -100.0, 0.0)
    cls = (np.arange(W) % n_cls).astype(np.int32)
    rng.shuffle(cls)
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    return (q.to(dev, tdt), k.to(dev, tdt), v.to(dev, tdt),
            torch.from_numpy(bias).to(dev), torch.from_numpy(cls).to(dev))


def check_kernel(twa):
    """Phase 3: kernel vs plain version at the codec's shapes."""
    import torch
    import torch.nn.functional as F

    B = 2  # images per compress call in phase 4
    cases = [
        # (W, N, D, n_cls): the two shapes the 512-px WACNN gives the kernel
        # (g_a block 1 / g_s block 2: 128x128x192, window 8, shift 4;
        # g_a block 2 / g_s block 1: 32x32x320, window 4, shift 2), then one
        # window class and a ragged window count
        (256 * B, 64, 24, 4),
        (64 * B, 16, 40, 4),
        (256 * B, 64, 24, 1),
        (100, 64, 24, 4),
        (100, 16, 40, 4),
    ]
    rows = []
    for dtype in ("float32", "bfloat16"):
        for W, N, D, n_cls in cases:
            ins = attention_inputs(W, N, D, n_cls, dtype, seed=W + N + D + n_cls)
            out = twa.window_attention_cuda(*ins)
            torch.cuda.synchronize()
            ref = twa.window_attention_reference(*ins)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOLERANCE[dtype]
            ok = bool(torch.isfinite(out).all()) and err <= tol
            q, k, v, bias, cls = ins
            mask = bias[cls.long()].to(q.dtype)
            row = dict(
                W=W, N=N, D=D, n_cls=n_cls, dtype=dtype, max_abs_err=err,
                tolerance=tol,
                ms=cuda_ms(lambda: twa.window_attention_cuda(*ins)),
                plain_ms=cuda_ms(lambda: twa.window_attention_reference(*ins)),
                library_ms=cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            )
            (row["bound_ms"], row["bound_by"],
             (row["f32_fma_bound_ms"], row["f32_fma_bound_by"])) = attention_bound_ms(
                W, 8, N, D, n_cls, dtype)
            rows.append(row)
            log(f"  window_attention W={W} N={N} D={D} n_cls={n_cls} {dtype}: "
                f"max_abs_err {err:.3e} (tolerance {tol:g}) ms {row['ms']:.4f} "
                f"plain {row['plain_ms']:.4f} sdpa {row['library_ms']:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {row}")
    return rows


def gdn_bound_ms(B, C, P, backward: bool):
    """Least time for the fused GDN work in f32: x (and g) read once, y
    (dx) written once, gamma and beta read (and their gradients written)
    once; against one C x C product per pixel (three in the backward)
    plus the elementwise work (4 operations per element forward: square,
    add beta, rsqrt, multiply; 14 backward), on the units the kernel runs
    them on: the forward all on the f32 FMA units, the backward's products
    on the tensor cores as three TF32 products each. -> (ms, "bytes" |
    "operations", and the f32-FMA bound (ms, by))."""
    elems = B * C * P
    if backward:
        nbytes = 4 * (3 * elems + 2 * (C * C + C))
        products, elementwise = 6 * C * C * B * P, 14 * elems
    else:
        nbytes = 4 * (2 * elems + C * C + C)
        products, elementwise = 2 * C * C * B * P, 4 * elems
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    fma = bound(t_bytes, (products + elementwise) / PEAK_OPS_PER_S["float32"] * 1e3)
    if not backward:
        return (*fma, fma)
    t_ops = (TF32_PASSES * products / PEAK_OPS_PER_S["tf32"]
             + elementwise / PEAK_OPS_PER_S["float32"]) * 1e3
    return (*bound(t_bytes, t_ops), fma)


def check_gdn(tgdn):
    """Phase 4: the GDN kernels vs their plain versions. -> rows."""
    import torch

    # (path, B, C, H, W): the GDN layers of the training step (8 x 256 px)
    # and of compress/decompress (2 x 512 px), then a ragged row count
    cases = [("train", 8, 192, s, s) for s in (128, 64, 32)]
    cases += [("serve", 2, 192, s, s) for s in (256, 128, 64)]
    cases.append(("ragged", 3, 192, 13, 21))  # 273 pixels, 9 tiles of 32
    rows = []
    for path, B, C, H, W in cases:
        rng = np.random.default_rng([B, H, W])
        dev = torch.device("cuda")
        x, g = (torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32)).to(dev)
                for _ in range(2))
        gamma = torch.from_numpy(  # (C_out, C_in), not symmetric
            (0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32)).to(dev)
        beta = torch.from_numpy((1.0 + 0.1 * rng.random(C)).astype(np.float32)).to(dev)
        for inverse in (False, True):
            y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
            dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
            again = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
            torch.cuda.synchronize()
            y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
            dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
            err = {
                "y": (y - y_ref).abs().max().item(),
                "dx": (dx - dx_ref).abs().max().item(),
                "dgamma": ((dgamma - dgamma_ref).abs().max() / dgamma_ref.abs().max()).item(),
                "dbeta": ((dbeta - dbeta_ref).abs().max() / dbeta_ref.abs().max()).item(),
            }
            deterministic = all(torch.equal(a, b) for a, b in zip(again, (dx, dgamma, dbeta)))
            row = dict(path=path, B=B, C=C, H=H, W=W, inverse=inverse, err=err,
                       deterministic=deterministic)
            P = H * W
            for name, kernel, plain, backward in (
                ("forward", lambda: tgdn.gdn_forward_cuda(x, gamma, beta, inverse),
                 lambda: tgdn.gdn_forward_reference(x, gamma, beta, inverse), False),
                ("backward", lambda: tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse),
                 lambda: tgdn.gdn_backward_reference(g, x, gamma, beta, inverse), True),
            ):
                bound_ms, by, (fma_ms, fma_by) = gdn_bound_ms(B, C, P, backward)
                row[name] = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                                 bound_ms=bound_ms, bound_by=by,
                                 f32_fma_bound_ms=fma_ms, f32_fma_bound_by=fma_by)
            rows.append(row)
            f, b = row["forward"], row["backward"]
            log(f"  gdn {path} {B}x{C}x{H}x{W} inverse={inverse}: err "
                f"{ {k: f'{v:.2e}' for k, v in err.items()} } deterministic {deterministic}; "
                f"forward ms {f['ms']:.4f} plain {f['plain_ms']:.4f} bound {f['bound_ms']:.4f} "
                f"({f['bound_by']}); backward ms {b['ms']:.4f} plain {b['plain_ms']:.4f} "
                f"bound {b['bound_ms']:.4f} ({b['bound_by']})")
            finite = all(bool(torch.isfinite(t).all()) for t in (y, dx, dgamma, dbeta))
            if not finite or not deterministic or any(
                    err[k] > GDN_TOLERANCE[k] for k in err):
                raise AssertionError(f"GDN kernels disagree with their plain versions "
                                     f"(tolerances {GDN_TOLERANCE}): {row}")
    return rows


def instrumented(make_step, records):
    """``make_step`` whose steps are timed (host clock around a step that
    ends in ``torch.cuda.synchronize()``) and whose kernel launches are
    counted: every count is set to 0 just before the step and read just
    after it. One record per step, with its metrics."""
    import torch

    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import window_attention as twa

    def make(model, criterion):
        inner = make_step(model, criterion)

        def step(state, batch, generator):
            torch.cuda.synchronize()
            twa.LAUNCHES = tgdn.FWD_LAUNCHES = tgdn.BWD_LAUNCHES = 0
            t = time.time()
            metrics = inner(state, batch, generator)
            torch.cuda.synchronize()
            seconds = time.time() - t
            records.append(dict(
                seconds=seconds, step=state.step,
                launches={"window_attention": twa.LAUNCHES,
                          "gdn_forward": tgdn.FWD_LAUNCHES,
                          "gdn_backward": tgdn.BWD_LAUNCHES},
                **{k: float(v) for k, v in metrics.items()}))
            return metrics

        return step

    return make


# launches of each kernel in one training step of WACNN: 3 GDN + 3 IGDN
# forward and backward; the 4 window blocks forward (their backward is
# autograd of the plain version, as in the JAX package)
TRAIN_STEP_LAUNCHES = {"window_attention": 4, "gdn_forward": 6, "gdn_backward": 6}


def train_phase(model, seed: int, card: str):
    """Phase 7: ``run_training`` on the card, then a resume. -> results."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.train import RateDistortionLoss, make_train_step, run_training

    B, size, steps, resumed_steps = 8, 256, 6, 2
    batches = [make_images(seed + 100 + i, B, size) for i in range(steps + resumed_steps)]
    eval_batch = make_images(seed + 99, B, size)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    records = []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.pt")
        common = dict(
            model=model, criterion=RateDistortionLoss(0.01),
            make_step=instrumented(make_train_step, records),
            eval_batches=lambda: iter([eval_batch]), learning_rate=1e-4,
            aux_learning_rate=1e-3, clip_max_norm=1.0, seed=seed, save_path=ckpt,
            log_every=steps)
        state, history = run_training(
            train_batches=lambda epoch: iter(batches[:steps]), epochs=1, **common)
        torch.cuda.synchronize()
        if not os.path.exists(ckpt) or state.step != steps:
            raise AssertionError(f"no checkpoint after epoch 0 (step {state.step})")
        moved = sum(not torch.equal(before[n], p) for n, p in model.named_parameters())
        resumed, history2 = run_training(
            train_batches=lambda epoch: iter(batches[steps:]), epochs=2,
            checkpoint=ckpt, **common)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if resumed.step != steps + resumed_steps or len(records) != steps + resumed_steps:
        raise AssertionError(f"resume: step {resumed.step}, {len(records)} steps run")
    if moved != len(before):
        raise AssertionError(f"{len(before) - moved} of {len(before)} parameters did not move")
    for r in records:
        if not all(np.isfinite(r[k]) for k in ("loss", "bpp_loss", "mse_loss", "aux_loss")):
            raise AssertionError(f"non-finite training metrics: {r}")
        if r["launches"] != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"step {r['step']}: launches {r['launches']}, "
                                 f"expected {TRAIN_STEP_LAUNCHES}")
    if not all(np.isfinite(history + history2)):
        raise AssertionError(f"eval losses {history} {history2}")
    timed = [r["seconds"] for r in records[1:steps]]  # after the first (warm-up) step
    result = dict(
        batch=B, size=size, steps=steps, resumed_steps=resumed_steps,
        train_img_per_s=B / float(np.median(timed)),
        step_seconds=[r["seconds"] for r in records],
        loss=[r["loss"] for r in records], bpp=[r["bpp_loss"] for r in records],
        aux_loss=[r["aux_loss"] for r in records], eval_loss=history + history2,
        peak_mem_gb=peak_gb, launches_per_step=records[-1]["launches"])
    for r in records:
        log(f"  step {r['step']}: {r['seconds'] * 1e3:.1f} ms loss {r['loss']:.4f} "
            f"bpp {r['bpp_loss']:.4f} aux {r['aux_loss']:.2f} launches {r['launches']}")
    log(f"  train {result['train_img_per_s']:.2f} img/s (median of {len(timed)} steps "
        f"after warm-up, batch {B} x {size}^2), peak {peak_gb:.2f} GB, eval losses "
        f"{history + history2}, resumed at step {steps} ({card})")
    return result


def train_vs_cpu_phase(model, seed: int):
    """Phase 8: one training step's loss terms and gradients, card vs CPU,
    same weights, same noise (one seeded CPU generator for each side: the
    noise is drawn on the generator's device)."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.train import RateDistortionLoss

    criterion = RateDistortionLoss(0.01)
    cpu_model = create_model("cnn", device="cpu", seed=seed)
    cpu_model.load_state_dict(model.state_dict())
    xs = torch.from_numpy(make_images(seed + 2, 1, 64))

    def step_grads(m, x):
        m.train()
        m.zero_grad(set_to_none=True)
        out = m(x, generator=torch.Generator().manual_seed(seed))
        rd = criterion(out, x)
        aux = m.aux_loss()
        (rd["loss"] + aux).backward()
        terms = {k: float(v.detach()) for k, v in {**rd, "aux_loss": aux}.items()}
        return terms, {n: p.grad.detach().cpu() for n, p in m.named_parameters()}

    got_terms, got = step_grads(model, xs.cuda())
    ref_terms, ref = step_grads(cpu_model, xs)
    model.zero_grad(set_to_none=True)
    worst = {k: abs(got_terms[k] - v) / max(abs(v), 1e-30) for k, v in ref_terms.items()}
    grad_err = {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item()
                for n in ref}
    name, err = max(grad_err.items(), key=lambda kv: kv[1])
    log(f"  loss terms card {got_terms} cpu {ref_terms}; relative errors {worst}")
    log(f"  largest gradient error relative to its max: {err:.3e} ({name}); "
        f"tolerance {TRAIN_TOLERANCE}")
    if max(worst.values()) > TRAIN_TOLERANCE or err > TRAIN_TOLERANCE:
        raise AssertionError("training step: card and CPU disagree")
    return dict(loss_terms_rel_err=worst, max_grad_rel_err=err, worst_grad=name,
                tolerance=TRAIN_TOLERANCE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from icm_tpu_torch import _native
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import CharmCodec, create_model
    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import window_attention as twa

    with Phase("environment"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0].strip()
        log(f"card: {card}")
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}, "
            f"name {torch.cuda.get_device_name(0)}")

    with Phase("build"):
        results, threads = {}, []

        def build(name, fn):
            t = time.time()
            try:
                results[name] = (fn(), time.time() - t)
            except BaseException as e:  # re-raised below, in the main thread
                results[name] = e

        for name, fn in _native.BUILDERS.items():
            threads.append(threading.Thread(target=build, args=(name, fn)))
            threads[-1].start()
        for t in threads:
            t.join()
        for name, res in results.items():
            if isinstance(res, BaseException):
                raise res
            log(f"  built {name}: {os.path.relpath(res[0], REPO)} in {res[1]:.1f}s")
        for lib in ("libwindow_attention", "libgdn"):
            for line in _native.BUILD_LOG.get(lib, "").splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"  ptxas ({lib}): {line.strip()}")

    # the codec's numerics (full f32, deterministic cuDNN) for every phase
    from icm_tpu_torch.models import cuda_numerics
    cuda_numerics()

    with Phase("window attention vs plain"):
        rows = check_kernel(twa)

    with Phase("GDN kernels vs plain"):
        gdn_rows = check_gdn(tgdn)

    def zero_counts():
        twa.LAUNCHES = tgdn.FWD_LAUNCHES = tgdn.BWD_LAUNCHES = 0

    def read_counts():
        return {"window_attention": twa.LAUNCHES, "gdn_forward": tgdn.FWD_LAUNCHES,
                "gdn_backward": tgdn.BWD_LAUNCHES}

    with Phase("full-width WACNN compress/decompress"):
        B, size = 2, 512
        t = time.time()
        model = create_model("cnn", seed=args.seed)  # N=192, M=320, 10 slices, on cuda
        n_params = sum(p.numel() for p in model.parameters())
        codec = CharmCodec(model, narrow=0.2)
        torch.cuda.synchronize()
        log(f"  model {n_params / 1e6:.1f} M parameters and codec tables in "
            f"{time.time() - t:.1f}s")
        x = torch.from_numpy(make_images(args.seed, B, size)).cuda()

        zero_counts()
        enc = codec.compress(x, return_debug=True)
        torch.cuda.synchronize()
        enc_launches = read_counts()
        zero_counts()
        dec = codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        dec_launches = read_counts()
        log(f"  launches: compress {enc_launches}, decompress {dec_launches}")

        if not torch.equal(dec["y_hat"], enc["y_hat"]):
            diff = (dec["y_hat"] - enc["y_hat"]).abs()
            raise AssertionError(f"y_hat not bit-exact: {int((diff > 0).sum())} "
                                 f"differ, max {diff.max().item():.3e}")
        if not torch.equal(dec["x_hat"], enc["x_hat"]):
            raise AssertionError("decoder x_hat differs from the encoder's")
        if dec["x_hat"].shape != x.shape or not bool(torch.isfinite(dec["x_hat"]).all()):
            raise AssertionError(f"bad x_hat {tuple(dec['x_hat'].shape)}")
        n_bytes = [len(y) + len(z) for y, z in zip(*enc["strings"])]
        bpp = [8 * n / (size * size) for n in n_bytes]
        if not all(np.isfinite(bpp)) or min(bpp) <= 0:
            raise AssertionError(f"bpp {bpp}")
        for side, counts in (("compress", enc_launches), ("decompress", dec_launches)):
            if counts["window_attention"] < 1 or counts["gdn_forward"] < 1:
                raise AssertionError(f"kernels not on the {side} path: {counts}")
        mse = torch.mean((dec["x_hat"] - x) ** 2, dim=(1, 2, 3))
        psnr = (10 * torch.log10(1.0 / mse)).tolist()

        enc_s, dec_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            e = codec.compress(x)
            torch.cuda.synchronize()
            enc_s.append(time.time() - t)
            t = time.time()
            d = codec.decompress(e["strings"], e["shape"])
            torch.cuda.synchronize()
            dec_s.append(time.time() - t)
            if not torch.equal(d["x_hat"], dec["x_hat"]):
                raise AssertionError("repeated decode differs from the first")
        slice_result = dict(
            images=B, size=size, bpp=bpp, psnr_db=psnr,
            encode_img_per_s=B / float(np.median(enc_s)),
            decode_img_per_s=B / float(np.median(dec_s)),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        log(f"  bpp {[round(b, 4) for b in bpp]}, PSNR {[round(p, 2) for p in psnr]} dB, "
            f"encode {slice_result['encode_img_per_s']:.2f} img/s, decode "
            f"{slice_result['decode_img_per_s']:.2f} img/s "
            f"(median of 3, batch {B}, {card})")

    with Phase("card vs CPU reference, small input"):
        xs = torch.from_numpy(make_images(args.seed + 1, 1, 64))
        cpu_model = create_model("cnn", device="cpu", seed=args.seed)
        cpu_model.load_state_dict(model.state_dict())
        with torch.no_grad():
            ref = cpu_model(xs)
            got = model(xs.cuda())
        worst = {}
        for name, a, b in (("x_hat", got["x_hat"], ref["x_hat"]),
                           ("y likelihoods", got["likelihoods"]["y"], ref["likelihoods"]["y"]),
                           ("z likelihoods", got["likelihoods"]["z"], ref["likelihoods"]["z"])):
            worst[name] = (a.cpu() - b).abs().max().item()
        log(f"  max |card - cpu|: {worst}")
        # f32 on both, through ~70 layers with sums in other orders
        if not worst["x_hat"] <= 1e-3 or not worst["y likelihoods"] <= 1e-3:
            raise AssertionError(f"card and CPU disagree: {worst}")

    with Phase("full-width WACNN training"):
        slice_result["train"] = train_phase(model, args.seed, card)
        train_launches = slice_result["train"]["launches_per_step"]

    with Phase("training step, card vs CPU"):
        slice_result["train"]["card_vs_cpu"] = train_vs_cpu_phase(model, args.seed)

    def launch_keys(name):
        per_path = {"launches_compress": enc_launches[name],
                    "launches_decompress": dec_launches[name],
                    "launches_train_step": train_launches[name]}
        return {"launches": sum(per_path.values()), **per_path}

    main_f32 = [r for r in rows if r["dtype"] == "float32" and r["n_cls"] == 4
                and r["W"] in (256 * B, 64 * B)]
    # the GDN layers of one training step: 8 x 192 at 128^2, 64^2, 32^2, GDN
    # and IGDN, one launch each; times summed. The serving and ragged rows
    # are in "cases", and every row's errors are under the tolerances
    gdn_main = [r for r in gdn_rows if r["path"] == "train"]
    no_library = ("no single PyTorch call computes the fused GDN function; "
                  "the plain version takes several")
    kernels = [{
        "name": "window_attention",
        "route": "cuda",
        "source": "icm_tpu_torch/csrc/window_attention.cu",
        "replaces": "icm_tpu/nn/pallas_kernels.py:33",
        **launch_keys("window_attention"),
        # the main path's rows (f32): one launch at each of its two shapes,
        # times summed; every row, bf16 too, is under "cases"
        "max_abs_err": max(r["max_abs_err"] for r in main_f32),
        "ms": sum(r["ms"] for r in main_f32),
        "plain_ms": sum(r["plain_ms"] for r in main_f32),
        "bound_ms": sum(r["bound_ms"] for r in main_f32),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_f32) else "operations",
        "bound_unit": "3xTF32 on the tensor cores (495 TFLOP/s dense), softmax at 67",
        "f32_fma_bound_ms": sum(r["f32_fma_bound_ms"] for r in main_f32),
        "library_ms": sum(r["library_ms"] for r in main_f32),
        "tolerance": TOLERANCE,
        "cases": rows,
    }]
    for name, part, err_key, line, unit in (
            ("gdn_forward", "forward", "y", 50, "f32 FMA units (67 TFLOP/s)"),
            ("gdn_backward", "backward", "dx", 64,
             "3xTF32 on the tensor cores (495 TFLOP/s dense), elementwise at 67")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/gdn.cu",
            "replaces": f"icm_tpu/nn/gdn_pallas.py:{line}",
            **launch_keys(name),
            "max_abs_err": max(r["err"][err_key] for r in gdn_rows
                               if r["path"] in ("train", "serve")),
            "ms": sum(r[part]["ms"] for r in gdn_main),
            "plain_ms": sum(r[part]["plain_ms"] for r in gdn_main),
            "bound_ms": sum(r[part]["bound_ms"] for r in gdn_main),
            "bound_by": ("operations" if all(r[part]["bound_by"] == "operations"
                                             for r in gdn_main) else "bytes"),
            "bound_unit": unit,
            "f32_fma_bound_ms": sum(r[part]["f32_fma_bound_ms"] for r in gdn_main),
            "library_ms": None,
            "library_note": no_library,
            "tolerance": GDN_TOLERANCE,
            "cases": [{k: v for k, v in r.items()
                       if k not in ("forward", "backward")} | r[part] for r in gdn_rows],
        })
    print(json.dumps({"kernels": kernels, "slice": slice_result}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
