"""Where the time goes in icm_tpu_torch's full-width codecs and their
training step, on the card.

    python3 tools/torch_profile_codec.py [--model cnn|stf|stf5|...|stf8|stf9|stf11|stf14]
        [--wire host|device|scan] [--no-graphs] [--act-dtype f32|bf16]
        [--scan-charm] [--seed 0] [--out profile.json]

Builds the full-width codec of ``--model`` (``cnn``, the default: WACNN,
N=192, M=320, 10 slices; ``stf``: the Swin codec, embed 48, M=384, 12
slices; ``stf5``-``stf8``: the zigzag family, stf's transforms with
per-slice Swin refiners; its training step runs the registry's unrolled
forward, or with ``--scan-charm`` the ``scan_charm=True`` forward, whose
refiners take stochastic depth; ``stf9``, ``stf11``, ``stf14``: the CRC
family, a machine layer with the zigzag ChARM coder and a human layer,
served by ``CRCCodec`` on the same three wires and trained on both layers'
likelihoods) on the CUDA card with weights drawn from ``--seed``, on the host
wire (``CharmCodec``, the default), the device wire
(``DeviceWireCodec``, 1024 lanes an image, its rANS on the card) or the
scan wire (``DeviceWireCodec(scan_wire=True)``, float32 only: its four
programs replayed as CUDA graphs, or with ``--no-graphs`` launch by
launch, for the A/B), warms
it up on 2 images of 512x512 (``icm_tpu_torch.data.make_images``, as
chip_smoke.py makes them), then traces one compress and one decompress with
``torch.profiler``; then warms up the RD training step
(``train.make_train_step``, lambda 0.01, batch 8 of 256x256, as
chip_smoke.py trains) and traces one step. ``--act-dtype bf16`` runs all
of it under the bfloat16 activation policy (``nn.set_activation_dtype``,
the counterpart of ``bench.py``'s flag). For each it reports the host
wall time, the device busy time (union of kernel, copy and memset
intervals in the trace), the device idle share against the traced and
an untraced run (median of 3; tracing slows the host), the largest idle
gaps of the card with the host operator running in each, the device time
by kernel, the port's own kernels' shares, and the host's operators by
self CPU time. Prints a summary, and
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
FAMILY = ("stf5", "stf6", "stf7", "stf8")  # the zigzag family
CRC = ("stf9", "stf11", "stf14")  # the CRC family


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


# the port's kernels by the names of their CUDA functions in the trace
PORT_KERNELS = {
    "window_attention": ("window_attention_kernel",),
    "gdn_forward": ("gdn_fwd_kernel",),
    "gdn_backward": ("gdn_bwd_kernel", "gdn_reduce_kernel"),
    "rans_encode": ("rans_encode_lanes_kernel",),
    "rans_decode": ("rans_decode_lanes_kernel",),
}


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
    # the card's idle gaps: between the device intervals, and before the
    # first, from the first host operator on; each with the innermost host
    # operator or CUDA runtime call running at its middle
    ops = [e for e in trace.get("traceEvents", [])
           if e.get("cat") in ("cpu_op", "cuda_runtime") and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    t0 = min([e["ts"] for e in ops] + [s for s, _ in spans[:1]])
    gaps, end = [], t0
    for s0, e0 in spans:
        if s0 > end:
            gaps.append((end, s0))
        end = max(end, e0)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:5]

    def host_op(t):
        inside = [e for e in ops if e["ts"] <= t <= e["ts"] + e["dur"]]
        return min(inside, key=lambda e: e["dur"])["name"][:60] if inside else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    port = {}
    for name, patterns in PORT_KERNELS.items():
        us = sum(v[0] for k, v in by_name.items() if any(p in k for p in patterns))
        port[name] = {"ms": us / 1e3, "share_of_device": us / total if total else 0.0}
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / 1e3 / (wall_s * 1e3)),
        "device_kernel_ms": total / 1e3,
        "port_kernels": port,
        "n_device_events": len(dev),
        "idle_gaps": [{"at_ms": (a - t0) / 1e3, "ms": (b - a) / 1e3,
                       "host_op": host_op((a + b) / 2)} for a, b in gaps],
        "top": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1],
                 "share": v[0] / total if total else 0.0} for k, v in top],
    }


def _host_summary(prof, n: int = 12) -> dict:
    """The host's side of the traced call: the operators by self CPU time
    (the host's own time in each, its launches included) and the count of
    ATen operator calls."""
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {
        "host_self_cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
        "n_aten_calls": sum(e.count for e in ops if e.key.startswith("aten::")),
        "host_top": [{"name": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                      "count": e.count} for e in ops[:n]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("cnn", "stf") + FAMILY + CRC, default="cnn")
    ap.add_argument("--wire", choices=("host", "device", "scan"), default="host")
    ap.add_argument("--no-graphs", action="store_true",
                    help="scan wire: run its programs launch by launch, not as CUDA graphs")
    ap.add_argument("--act-dtype", choices=("f32", "bf16"), default="f32",
                    help="activation dtype of the transforms and context stacks (both "
                    "coder sides and the training step); the entropy math stays f32")
    ap.add_argument("--scan-charm", action="store_true",
                    help="the zigzag family: train through the scan_charm=True forward")
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
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.models.crc_codec import CRCCodec
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.train import (
        RateDistortionLoss, TrainState, make_optimizer, make_train_step)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    if args.act_dtype == "bf16":
        set_activation_dtype(torch.bfloat16)
    if args.scan_charm and args.model not in FAMILY:
        ap.error("--scan-charm is an option of the zigzag family (stf5-stf8)")
    model = create_model(args.model, seed=args.seed,
                         **({"scan_charm": True} if args.scan_charm else {}))
    if args.model in CRC:
        codec = CRCCodec(model, narrow=0.2, wire="host" if args.wire == "host" else "device",
                         scan_wire=args.wire == "scan", cuda_graphs=not args.no_graphs)
    elif args.wire == "scan":
        codec = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2, scan_wire=True,
                                cuda_graphs=not args.no_graphs)
    elif args.wire == "device":
        codec = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2)
    else:
        codec = CharmCodec(model, narrow=0.2)
    x = torch.from_numpy(make_images(args.seed, 2, 512)).cuda()
    def decompress(enc):
        extra = (enc["human_shape"],) if args.model in CRC else ()
        return codec.decompress(enc["strings"], enc["shape"], *extra)

    for _ in range(2):  # warm-up: cuDNN handles, allocator, kernel library
        enc = codec.compress(x)
        decompress(enc)
    torch.cuda.synchronize()

    # the codec's sides first: training moves the weights its tables came from
    runs = {
        "compress": lambda: codec.compress(x),
        "decompress": lambda: decompress(enc),
    }
    state = TrainState(model, make_optimizer(model))
    keys = ("likelihoods", "machine_likelihoods") if args.model in CRC else ("likelihoods",)
    train_step = make_train_step(model, RateDistortionLoss(0.01, likelihood_keys=keys))
    noise = torch.Generator(device="cuda").manual_seed(args.seed)
    batch = torch.from_numpy(make_images(args.seed + 100, 8, 256)).cuda()
    runs["train_step"] = lambda: train_step(state, batch, noise)
    result = {"card": card, "model": args.model, "wire": args.wire,
              "scan_charm": args.scan_charm,
              "cuda_graphs": args.wire == "scan" and not args.no_graphs,
              "act_dtype": args.act_dtype, "images": 2,
              "size": 512, "narrow": 0.2,
              "train_batch": 8, "train_size": 256}
    for side, run in runs.items():
        if side == "train_step":
            for _ in range(2):  # warm-up: cuDNN's backward handles, Adam state
                run()
        # host wall time without the profiler (its tracing slows the host)
        plain_wall = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            run()
            torch.cuda.synchronize()
            plain_wall.append(time.time() - t)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            run()
            torch.cuda.synchronize()
            wall = time.time() - t
        r = result[side] = {**_trace_summary(prof, wall), **_host_summary(prof)}
        unprofiled = sorted(plain_wall)[1]
        r["wall_ms_unprofiled"] = unprofiled * 1e3
        r["device_idle_share_unprofiled"] = max(
            0.0, 1.0 - r["device_busy_ms"] / (unprofiled * 1e3))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for side in runs:
        r = result[side]
        kernels = ", ".join(f"{k} {v['ms']:.3f} ms ({v['share_of_device']:.3%})"
                            for k, v in r["port_kernels"].items())
        wire = args.wire + (" (launch by launch)" if args.wire == "scan" and args.no_graphs
                            else " (graphs)" if args.wire == "scan" else "")
        fwd = ", scan_charm" if args.scan_charm and side == "train_step" else ""
        print(f"{args.model}{fwd}, {wire} wire, {args.act_dtype}, {side}: wall {r['wall_ms']:.2f} ms traced, {r['wall_ms_unprofiled']:.2f} ms "
              f"untraced; device busy {r['device_busy_ms']:.2f} ms (idle share "
              f"{r['device_idle_share']:.3f} traced, {r['device_idle_share_unprofiled']:.3f} "
              f"untraced); {kernels} [{card}]")
        for row in r["top"][:8]:
            print(f"   {row['ms']:8.3f} ms {row['share']:6.1%} x{row['count']:<4d} "
                  f"{row['name'][:90]}")
        print("   largest idle gaps: " + ", ".join(
            f"{g['ms']:.3f} ms at {g['at_ms']:.2f} ms ({g['host_op']})" for g in r["idle_gaps"]))
        print(f"   host: {r['host_self_cpu_ms']:.2f} ms self CPU time traced, "
              f"{r['n_aten_calls']} ATen calls; by self CPU time:")
        for row in r["host_top"][:8]:
            print(f"   {row['self_cpu_ms']:8.3f} ms x{row['count']:<5d} {row['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
