"""The GDN kernels of one checkout, or a GDN model's training step, timed
on the card, for comparing two trees A/B in one call.

    python3 tools/torch_ab_gdn.py [--root DIR] [--out ab.json]
        [--all-widths] [--step cnn|stf9|stf11|stf12|stf13|stf14 [--steps 10]
        [--seed 0] [--act-dtype f32|bf16]]

Imports ``icm_tpu_torch`` from ``--root`` (default: this checkout) and
runs chip_smoke.py's phase 4 from this checkout at the CRC family's
256-channel shapes (``GDN_C256_CASES``: 2 x 256 x 128^2 serving, 8 x 256
x 64^2 training; GDN and IGDN; float32 and bfloat16), or with
``--all-widths`` at every case of phase 4 (``GDN_CASES``: 192, 256 and
512 channels): each kernel against its plain version and against
itself, timed with CUDA events beside the plain version and the bound,
and the backward split into its kernels from a profiler trace. With ``--step MODEL`` it times that checkout's RD
training step of the model instead (lambda 0.01 over the model's
likelihoods, every layer's for the CRC family, batch 8 of 256x256, weights
from ``--seed``, as tools/torch_profile_codec.py trains it), under the
bfloat16 activation policy with ``--act-dtype bf16``: after 2 warm-up
steps, ``--steps`` steps, each on the host clock from a synchronized card
to a synchronized card, with no profiler. Prints the card's name and power
limit and one JSON line; ``--out`` also writes it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_walls(model_name: str, steps: int, seed: int, act_dtype: str = "f32") -> dict:
    """Host wall ms of ``steps`` untraced training steps of ``model_name``
    (under the bfloat16 policy with ``act_dtype`` "bf16")."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.train import (
        RateDistortionLoss, TrainState, make_optimizer, make_train_step)

    if act_dtype == "bf16":
        set_activation_dtype(torch.bfloat16)
    model = create_model(model_name, seed=seed)
    state = TrainState(model, make_optimizer(model))
    keys = getattr(model, "likelihood_keys", ("likelihoods",))
    train_step = make_train_step(model, RateDistortionLoss(0.01, likelihood_keys=keys))
    noise = torch.Generator(device="cuda").manual_seed(seed)
    batch = torch.from_numpy(make_images(seed + 100, 8, 256)).cuda()
    for _ in range(2):  # warm-up: cuDNN's handles, Adam state
        train_step(state, batch, noise)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(state, batch, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return {"model": model_name, "act_dtype": act_dtype, "step_wall_ms": walls,
            "median_ms": sorted(walls)[len(walls) // 2]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose icm_tpu_torch is timed")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all-widths", action="store_true",
                    help="every case of chip_smoke.py's phase 4, not only 256 channels")
    ap.add_argument("--step", choices=("cnn", "stf9", "stf11", "stf12", "stf13", "stf14"),
                    default=None, help="time this model's training step instead of the kernels")
    ap.add_argument("--act-dtype", choices=("f32", "bf16"), default="f32",
                    help="the step's activation policy (bf16: icm_tpu_torch.nn's bfloat16 policy)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ab_gdn: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from icm_tpu_torch.models import cuda_numerics
    from icm_tpu_torch.nn import gdn_fused as tgdn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    cuda_numerics()
    if args.step:
        result = {"root": os.path.abspath(args.root), "card": card,
                  **step_walls(args.step, args.steps, args.seed, args.act_dtype)}
    else:
        rows = smoke.check_gdn(tgdn, smoke.GDN_CASES if args.all_widths else smoke.GDN_C256_CASES,
                               split_all=True)
        result = {"root": os.path.abspath(args.root), "card": card, "rows": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
