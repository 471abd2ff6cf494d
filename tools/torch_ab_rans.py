"""The device wire's rANS kernels of one checkout, timed on the card, for
comparing two trees' kernels A/B in one call.

    python3 tools/torch_ab_rans.py [--root DIR] [--images 2 32] [--seed 0] [--out ab.json]

Imports ``icm_tpu_torch`` from ``--root`` (default: this checkout) and
runs chip_smoke.py's phase 6 from this checkout (``check_rans``: encode
and decode of y and z at the device wire's shapes for each image count of
512x512 images, byte for byte against the plain versions and launch to
launch, timed with CUDA events beside ``one_lane_ms`` and the bound). Then
it compresses ``make_images(seed, 2, 512)`` on the device wire of the
full-width ``cnn`` model (weights from ``--seed``, ``narrow=0.2``, as
chip_smoke.py's phase 7 does) and prints the sha256 of the y and z blobs,
so two trees' wires can be compared. Prints the card's name and power
limit and one JSON line; ``--out`` also writes it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose icm_tpu_torch is timed")
    ap.add_argument("--images", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ab_rans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import DeviceWireCodec, create_model, cuda_numerics

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    cuda_numerics()
    codec = DeviceWireCodec(create_model("cnn", seed=args.seed), lanes_per_image=1024,
                            narrow=0.2)
    rows = [row for B in args.images
            for row in smoke.check_rans(codec.kit, codec.tables, args.seed, B, 512)]
    x = torch.from_numpy(make_images(args.seed, 2, 512)).cuda()
    strings = codec.compress(x)["strings"]
    blob_sha256 = {name: hashlib.sha256(b"".join(strings[k])).hexdigest()
                   for k, name in enumerate("yz")}
    result = {"root": os.path.abspath(args.root), "card": card, "rows": rows,
              "blob_sha256": blob_sha256}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
