"""Smoke run of icm_tpu_torch on one NVIDIA card: build, check, serve.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It needs one CUDA card, nvcc and g++,
and exits non-zero (printing no result) without a card or without the
package beside it. Phases, each printed with its elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the window-attention kernel (nvcc, sm_90a) and the host rANS
   coder (g++), from the sources in the checkout, both at once;
3. the kernel against its plain PyTorch version on the card, at the
   shapes of the full-width WACNN codec's path, in f32 and bf16, timed
   beside the plain version and F.scaled_dot_product_attention (a
   yardstick the port never calls);
4. the full-width WACNN (N=192, M=320, 10 slices) on the card with
   weights drawn from ``--seed``: compress -> decompress of 2 images of
   512x512 made from ``--seed``. The kernel launch counts are zeroed
   right before and read right after each side. Asserts a bit-exact
   y_hat, the decoder's x_hat equal to the encoder's, a finite bpp, and
   kernel launches on both sides;
5. the same weights' eval forward on the card against the plain CPU path
   on a small input.

It then prints the kernels line (JSON), the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

# the card's published peaks (H100 SXM data sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# stated tolerances of the kernel against its plain version on the card:
# f32 sums of the same terms in another order (outputs O(1)); in bf16 the
# probabilities and the output are rounded to 8-bit mantissas, and a value
# on the other side of a rounding boundary moves the output by one ulp
# (2**-7 relative, outputs up to ~2)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}


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


def attention_bound_ms(W, H, N, D, n_cls, dtype: str):
    """Least time for the work: each input read once, the output written
    once, against the operations (two products and the softmax) at the
    card's peak for the inputs' type. -> (ms, "bytes" | "operations")."""
    elt = 4 if dtype == "float32" else 2
    nbytes = 4 * W * H * N * D * elt + n_cls * H * N * N * 4 + W * 4
    ops = W * H * (4 * N * N * D + 5 * N * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            row["bound_ms"], row["bound_by"] = attention_bound_ms(W, 8, N, D, n_cls, dtype)
            rows.append(row)
            log(f"  window_attention W={W} N={N} D={D} n_cls={n_cls} {dtype}: "
                f"max_abs_err {err:.3e} (tolerance {tol:g}) ms {row['ms']:.4f} "
                f"plain {row['plain_ms']:.4f} sdpa {row['library_ms']:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok:
                raise AssertionError(
                    f"kernel disagrees with its plain version: {row}")
    return rows


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

        for name, fn in (("kernels", _native.build_kernels), ("rans", _native.build_rans)):
            threads.append(threading.Thread(target=build, args=(name, fn)))
            threads[-1].start()
        for t in threads:
            t.join()
        for name, res in results.items():
            if isinstance(res, BaseException):
                raise res
            log(f"  built {name}: {os.path.relpath(res[0], REPO)} in {res[1]:.1f}s")
        for line in _native.BUILD_LOG.get("libwindow_attention", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # the codec's numerics (full f32, deterministic cuDNN) for every phase
    from icm_tpu_torch.models import cuda_numerics
    cuda_numerics()

    with Phase("kernel vs plain"):
        rows = check_kernel(twa)

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

        twa.LAUNCHES = 0
        enc = codec.compress(x, return_debug=True)
        torch.cuda.synchronize()
        enc_launches = twa.LAUNCHES
        twa.LAUNCHES = 0
        dec = codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        dec_launches = twa.LAUNCHES
        log(f"  window_attention launches: compress {enc_launches}, "
            f"decompress {dec_launches}")

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
        if enc_launches < 1 or dec_launches < 1:
            raise AssertionError(
                f"kernel not on the main path: compress {enc_launches}, "
                f"decompress {dec_launches} launches")
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

    main_f32 = [r for r in rows if r["dtype"] == "float32" and r["n_cls"] == 4
                and r["W"] in (256 * B, 64 * B)]
    kernels = [{
        "name": "window_attention",
        "route": "cuda",
        "source": "icm_tpu_torch/csrc/window_attention.cu",
        "replaces": "icm_tpu/nn/pallas_kernels.py:33",
        "launches": enc_launches + dec_launches,
        # the main path's rows (f32): one launch at each of its two shapes,
        # times summed; every row, bf16 too, is under "cases"
        "max_abs_err": max(r["max_abs_err"] for r in main_f32),
        "ms": sum(r["ms"] for r in main_f32),
        "plain_ms": sum(r["plain_ms"] for r in main_f32),
        "bound_ms": sum(r["bound_ms"] for r in main_f32),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_f32) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_f32),
        "launches_compress": enc_launches,
        "launches_decompress": dec_launches,
        "tolerance": TOLERANCE,
        "cases": rows,
    }]
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
