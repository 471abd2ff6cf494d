"""``czigzag``'s y symbols at several ``narrow`` values, on the CPU: the
full-width registry model from its seeded weights, and images and up_x4
made as ``chip_smoke.py`` makes them (``chip_smoke.conditioning_image``:
x average-pooled by 4, then bilinearly upsampled back). Picks
``chip_smoke.CZIGZAG_NARROW``.

    python3 tools/probe_czigzag_narrow.py [--size 512] [--images 2] [--seed 0]
        [--narrow 4,1,0.5,0.2]

The transforms run once; for each value the 16-slice chain runs again and
prints the nonzero symbols of all, the largest magnitude, and the y
stream's bytes on the host wire and on the device wire with its escapes
(8 bytes each on the device wire). Needs no card (a few minutes at 512 px
on a few cores)."""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--narrow", default="4,1,0.5,0.2")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import importlib.util

    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import build_codec_tables, create_model
    from icm_tpu_torch.models.crc_codec import CzigzagCodec

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    model = create_model("czigzag", device="cpu", seed=args.seed)
    x = torch.from_numpy(make_images(args.seed, args.images, args.size))
    up = smoke.conditioning_image(x)
    with torch.no_grad():
        tables = build_codec_tables(model)
        host = CzigzagCodec(model, tables=tables)
        xc, uc = host._inputs(x, up)
        ctx_list, hctx, hctx2, _ = host._unflat(host._pyramids(uc))
        y = model.analyze_cond(xc, ctx_list)
        z = model.hyper_encode(y, hctx, hctx2)
        for narrow in (float(v) for v in args.narrow.split(",")):
            host = CzigzagCodec(model, tables=tables, narrow=narrow)
            dev = CzigzagCodec(model, tables=tables, narrow=narrow, wire="device")
            z_sym = host.driver.z_sym(z)
            syms, idxs, _ = host.driver.encode(y, z_sym, hctx, hctx2)
            sym = torch.cat([s.flatten() for s in syms])
            n = int(sym.count_nonzero())
            host_b = sum(map(len, host._encode_y(syms, idxs)))
            blobs = dev._encode_y(syms, idxs)
            print(f"narrow {narrow}: nonzero y symbols {n} of {sym.numel()} "
                  f"({n / sym.numel():.2%}), largest |symbol| {int(sym.abs().max())}; y bytes "
                  f"host {host_b}, device {sum(map(len, blobs))} with "
                  f"{smoke.wire_escapes(blobs)} escapes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
