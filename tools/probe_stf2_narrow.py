"""The share of ``stf2``'s y symbols that are nonzero at several ``narrow``
values, on the CPU: the full-width registry model from its seeded weights
and one image made as ``chip_smoke.py`` makes them. Picks
``chip_smoke.STF2_NARROW`` (a trained model codes a few percent of its
symbols nonzero; seeded weights at ``narrow=1`` code over a third).

    python3 tools/probe_stf2_narrow.py [--size 256] [--seed 0] [--narrow 1,0.5,0.3,0.2]

Prints, for each value, the nonzero symbols of all and the largest
magnitude. Needs no card (about a minute at 256 px on a few cores)."""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--narrow", default="1,0.5,0.3,0.2")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.masked_codec import Stf2Codec

    model = create_model("stf2", device="cpu", seed=args.seed)
    x = torch.from_numpy(make_images(args.seed, 1, args.size))
    for narrow in (float(v) for v in args.narrow.split(",")):
        sym = Stf2Codec(model, narrow=narrow).symbols(x)
        n = int(sym.count_nonzero())
        print(f"narrow {narrow}: nonzero y symbols {n} of {sym.numel()} ({n / sym.numel():.2%}), "
              f"largest |symbol| {int(sym.abs().max())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
