"""Where the time goes in icm_tpu_torch's full-width WACNN codec, on the card.

    python3 tools/torch_profile_codec.py [--seed 0] [--out profile.json]

Builds the full-width ``cnn`` codec (N=192, M=320, 10 slices) on the CUDA
card with weights drawn from ``--seed``, warms it up on 2 images of
512x512 (``icm_tpu_torch.data.make_images``, as chip_smoke.py makes
them), then traces one compress and one decompress with
``torch.profiler``. For each side it reports the host wall time, the device busy time (union of kernel, copy and memset
intervals in the trace), the device idle share against the traced and
an untraced run (median of 3; tracing slows the host), the device time by
kernel, and the window-attention kernel's share. Prints a summary, and
writes the whole result as JSON to ``--out`` when it is given. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) intervals, in microseconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _trace_summary(prof, wall_s: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        key = e["name"] if e["cat"] == "kernel" else e["cat"]
        by_name[key][0] += e["dur"]
        by_name[key][1] += 1
    busy = _busy_us(dev)
    total = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    attn = sum(v[0] for k, v in by_name.items() if "window_attention_kernel" in k)
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / 1e3 / (wall_s * 1e3)),
        "device_kernel_ms": total / 1e3,
        "window_attention_ms": attn / 1e3,
        "window_attention_share_of_device": attn / total if total else 0.0,
        "n_device_events": len(dev),
        "top": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1],
                 "share": v[0] / total if total else 0.0} for k, v in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the whole result here as JSON")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_codec: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import CharmCodec, create_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    codec = CharmCodec(create_model("cnn", seed=args.seed), narrow=0.2)
    x = torch.from_numpy(make_images(args.seed, 2, 512)).cuda()
    for _ in range(2):  # warm-up: cuDNN handles, allocator, kernel library
        enc = codec.compress(x)
        codec.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()

    # host wall time without the profiler (its tracing slows the host)
    plain_wall = {"compress": [], "decompress": []}
    for _ in range(3):
        t = time.time()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        plain_wall["compress"].append(time.time() - t)
        t = time.time()
        codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        plain_wall["decompress"].append(time.time() - t)

    result = {"card": card, "images": 2, "size": 512, "narrow": 0.2}
    for side in ("compress", "decompress"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            if side == "compress":
                enc = codec.compress(x)
            else:
                codec.decompress(enc["strings"], enc["shape"])
            torch.cuda.synchronize()
            wall = time.time() - t
        r = result[side] = _trace_summary(prof, wall)
        unprofiled = sorted(plain_wall[side])[1]
        r["wall_ms_unprofiled"] = unprofiled * 1e3
        r["device_idle_share_unprofiled"] = max(
            0.0, 1.0 - r["device_busy_ms"] / (unprofiled * 1e3))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for side in ("compress", "decompress"):
        r = result[side]
        print(f"{side}: wall {r['wall_ms']:.2f} ms traced, {r['wall_ms_unprofiled']:.2f} ms "
              f"untraced; device busy {r['device_busy_ms']:.2f} ms (idle share "
              f"{r['device_idle_share']:.3f} traced, {r['device_idle_share_unprofiled']:.3f} "
              f"untraced), window attention "
              f"{r['window_attention_ms']:.3f} ms ({r['window_attention_share_of_device']:.3%} "
              f"of device time) [{card}]")
        for row in r["top"][:8]:
            print(f"   {row['ms']:8.3f} ms {row['share']:6.1%} x{row['count']:<4d} "
                  f"{row['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
