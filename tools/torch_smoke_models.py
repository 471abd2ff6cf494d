"""chip_smoke.py's phases of some CRC-family, masked-family, czigzag, cnn2
or oj models alone, on the card: the quick check of one model's paths
without the whole run.

    python3 tools/torch_smoke_models.py [--models stf13] [--size 512] [--seed 0]
        [--out models.json] [--probe-gains 8,16,32]

Builds every kernel (``chip_smoke.build_kernels``), then runs, for each
model of ``--models`` (comma- or space-separated, of ``chip_smoke.CRC``,
``chip_smoke.MASKED``, ``czigzag``, ``cnn2``, ``oj_ICM`` and
``seg_oj_ICM``), its phases as ``chip_smoke.main`` does, each phase
holding what it holds in the whole run:

- a CRC model (``chip_smoke.crc_model_phases``) on phase 5's images: the
  three wires and the eval forward card against CPU, training, the bf16
  policy (``CRC_BF16``) and the reference checkpoint (``CRC_REFERENCE``);
- a masked model (``chip_smoke.masked_model_phases``: stf3, stf4, stf2):
  the host and device wires (stf2's device wire graphed and launch by
  launch) and the eval forward card against CPU, the same under the bf16
  policy, training in float32 and under the policy, and the reference
  checkpoint, on 2 images of ``--size`` px (default: the model's
  ``MASKED_SIZE``; stf3 / stf4's decoder work grows with the square of the
  token count, so stf4 at 512 px takes about 16 times its 256 px
  decompress; stf2's with the count);
- czigzag (``chip_smoke.czigzag_model_phases``) on phase 5's images and
  their up_x4: the three wires (the scan wire graphed and launch by
  launch) and the eval forward card against CPU, training, the bf16
  policy and the reference checkpoint;
- cnn2 (``chip_smoke.cnn2_model_phases``) on phase 5's images, held to
  what cnn from the same seed gives (``chip_smoke.cnn_refs``: its blobs
  and launch counts on the device, scan and bf16 device wires and of its
  reference checkpoint): the device and scan wires with detection on the
  decoded images, the student card against CPU, the bf16 policy's serving,
  training and the reference checkpoint;
- oj_ICM and seg_oj_ICM together (``chip_smoke.oj_model_phases``, phases
  53-56; either name runs both) on phase 5's images: their wires, the eval
  forward and the task net card against CPU, training, the bf16 policy and
  the reference checkpoints.

Prints the card's name and power limit and, last, one JSON line of each
model's results and launch counts; ``--out`` also writes it. Exits 1 if a
phase fails. With ``--probe-gains`` (CRC models only) it runs no phase: for
each gain in place of ``chip_smoke.CRC_GAIN``'s factors, each zigzag
layer's nonzero symbols and each stream's host and device-wire bytes,
escapes and limit (``chip_smoke.crc_stream_bytes``) of one host and one
device-wire compress of the same images. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe_gains(smoke, name: str, x, seed: int, gains) -> dict:
    """For each gain, ``name``'s seeded weights with CRC_GAIN's parameters
    scaled by it: each zigzag layer's nonzero symbols (of all) and the
    device wire's stream bytes against the host wire's."""
    import torch

    from icm_tpu_torch.models import create_model

    model = create_model(name, seed=seed)
    base = {p: model.get_parameter(p).detach().clone() for p in smoke.CRC_GAIN.get(name, {})}
    out = {}
    for g in gains:
        with torch.no_grad():
            for p, w in base.items():
                model.get_parameter(p).copy_(w * g)
        host = smoke.crc_codec(model, narrow=0.2)
        dev = smoke.crc_codec(model, narrow=0.2, wire="device")
        symbols = {k: [sum(int(s.count_nonzero()) for s in v), sum(s.numel() for s in v)]
                   for k, v in host.symbols(x).items()}
        stream_bytes = smoke.crc_stream_bytes(model, dev, host.compress(x), dev.compress(x),
                                              x.shape[1])
        over = [k for k, v in stream_bytes.items() if v["device"] > v["limit"]]
        smoke.log(f"  {name} gain {g}: nonzero symbols {symbols}; over the limit {over}; "
                  f"bytes {stream_bytes}")
        out[str(g)] = {"nonzero_y_symbols": symbols, "stream_bytes": stream_bytes,
                       "over_limit": over}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", nargs="+", default=["stf13"])
    ap.add_argument("--size", type=int, default=0,
                    help="px a side of a masked model's images; 0: MASKED_SIZE")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--probe-gains", default=None,
                    help="comma-separated factors for CRC_GAIN's parameters; no phase runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_smoke_models: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = [n for arg in args.models for n in arg.split(",") if n]
    unknown = sorted(set(names) - set(smoke.CRC) - set(smoke.MASKED) - {"czigzag", "cnn2"}
                     - set(smoke.OJ))
    if args.probe_gains:
        unknown += sorted(set(names) & (set(smoke.MASKED) | {"czigzag", "cnn2"} | set(smoke.OJ)))
    if unknown:
        what = "CRC" if args.probe_gains else "CRC, masked, czigzag, cnn2 or oj"
        print(f"torch_smoke_models: not {what} models of chip_smoke.py: {unknown}",
              file=sys.stderr)
        return 2
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import cuda_numerics

    card = smoke.environment()
    smoke.build_kernels()
    cuda_numerics()
    zero_counts, read_counts = smoke.launch_counts("float32")
    x = torch.from_numpy(make_images(args.seed, 2, 512)).cuda()  # phase 5's images
    out = {"card": card}
    try:
        for name in names:
            if args.probe_gains:
                out[name] = probe_gains(smoke, name, x, args.seed,
                                        [float(g) for g in args.probe_gains.split(",")])
            elif name == "czigzag":
                result, counts, shapes = smoke.czigzag_model_phases(x, card, zero_counts,
                                                                    read_counts, args.seed)
                out[name] = {"result": result, "launches": counts, "launches_by_shape": shapes}
            elif name in smoke.OJ:
                if "oj" in out:  # one run serves both names
                    continue
                out["oj"] = {n: {"result": r, "launches": c, "launches_by_shape": sh}
                             for n, (r, c, sh) in smoke.oj_model_phases(
                                 x, card, zero_counts, read_counts, args.seed).items()}
            elif name == "cnn2":
                cnn = smoke.cnn_refs(x, zero_counts, read_counts, args.seed)
                result, counts, bf16_counts = smoke.cnn2_model_phases(
                    x, card, zero_counts, read_counts, args.seed, cnn)
                out[name] = {"result": result, "launches": counts, "launches_bf16": bf16_counts}
            elif name in smoke.MASKED:
                result, counts, bf16_counts = smoke.masked_model_phases(
                    name, card, zero_counts, read_counts, args.seed, args.size)
                out[name] = {"result": result, "launches": counts, "launches_bf16": bf16_counts}
            else:
                result, counts, shapes = smoke.crc_model_phases(name, x, card, zero_counts,
                                                                read_counts, args.seed)
                out[name] = {"result": result, "launches": counts, "launches_by_shape": shapes}
    except Exception:
        traceback.print_exc()
        return 1
    line = json.dumps(out, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(card, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
