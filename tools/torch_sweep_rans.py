"""Launch variants of the device wire's two lane-rANS kernels, timed on
the card at the device wire's shapes.

    python3 tools/torch_sweep_rans.py [--seed 0] [--images 2 32] [--out sweep.json]

Builds the full-width ``cnn`` model's coding tables (weights drawn from
``--seed``) and, for each image count (512x512 images, 1024 y lanes an
image), chip_smoke.py's phase-6 payloads: y (Gaussian rows, 320 steps a
lane, decoded in 10 continued launches of 32) and z (bottleneck rows, 24
steps, one launch). Then it times every launch variant the kernels take,
each held byte for byte against the default launch's output:

- decode: threads a block (8 .. 1024), and the compact tables staged in
  shared memory or read through L1;
- encode: threads a block (8 .. 256), the emissions kept in shared memory
  or written to the output rows.

Then the default decode once more on streams of the same rows whose every
value is its row's most likely symbol (``payload: "mode"``): almost no
lane has a CDF entry left to search, so the gap to the drawn payload is
what the search costs (its halvings and a warp's wait for its slowest
lane).

Device time of one call (chip_smoke.cuda_ms: CUDA events, the stream held
busy, median of 20). Prints one line a variant and the card's name and
power limit, and writes the rows as JSON to ``--out`` when given. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_rans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, rans_payload
    from icm_tpu_torch.coding import device_rans as tdr
    from icm_tpu_torch.models import DeviceWireKit, build_codec_tables, create_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    codec_tables = build_codec_tables(create_model("cnn", seed=args.seed))
    kit = DeviceWireKit(codec_tables)
    host_tables = {"y": codec_tables.gaussian,
                   "z": codec_tables.bottlenecks["entropy_bottleneck"]}
    dev_tables = {"y": kit.gauss_dev, "z": kit.eb_dev["entropy_bottleneck"]}
    dev = torch.device("cuda", torch.cuda.current_device())
    _, _, dec_bytes, enc_bytes, _ = tdr._kernel_fns()
    limit = tdr._smem_limit(dev)

    rows_out = []
    rng = np.random.default_rng(args.seed + 7)
    for B in args.images:
        n_l = kit.n_lanes(32, 32)
        eb = dev_tables["z"]
        for stream, rows_np, n_launches in (
                ("y", rng.integers(0, kit.gauss_dev.num_rows, size=(320, B * n_l)), 10),
                ("z", kit.z_rows(eb.num_rows, kit.z_groups(eb.num_rows), B * 64).cpu().numpy(),
                 1)):
            tab = dev_tables[stream]
            values = torch.from_numpy(rans_payload(host_tables[stream], rows_np, rng)).cuda()
            rows = torch.from_numpy(rows_np.astype(np.int32)).cuda()
            T, lanes = values.shape
            want = tdr.encode_lanes_kernel(values, rows, tab)
            for threads in (8, 16, 32, 64, 128, 256):
                for smem in (True, False):
                    if enc_bytes(T, tab.num_rows, threads, int(smem)) > limit:
                        continue
                    cfg = (threads, smem)
                    got = tdr._encode_launch(values, rows, tab, cfg)
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    ms = cuda_ms(lambda: tdr._encode_launch(values, rows, tab, cfg))
                    rows_out.append(dict(images=B, stream=stream, kernel="encode",
                                         threads=threads, smem=smem, ms=ms, same=same,
                                         default=cfg == tdr.encode_launch_config(
                                             T, tab.num_rows, dev)))
                    print(json.dumps(rows_out[-1]), flush=True)
            seg = T // n_launches

            def chain(tables, cfg, streams):
                """The continued decode launches of (words, off)."""
                state = ptr = None
                out = []
                for i in range(n_launches):
                    vals, state, ptr = tdr._decode_launch(
                        *streams, rows[i * seg:(i + 1) * seg], tables, state, ptr, cfg)
                    out.append(vals)
                return [*out, state, ptr]

            def streams(values):
                """-> (words, off) of the values encoded by the default launch."""
                buf, lengths, _ = tdr.encode_lanes_kernel(values, rows, tab)
                len_h = lengths.cpu().numpy()
                words = torch.from_numpy(tdr.assemble_streams(
                    buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
                return words, torch.from_numpy(tdr.lane_offsets(len_h)).cuda()

            drawn = streams(values)
            want_dec = chain(tab, None, drawn)
            nbytes = 4 * tab.ctab.numel()
            for threads in (8, 16, 32, 64, 128, 256, 512, 1024):
                for smem in (True, False):
                    if dec_bytes(nbytes, threads, int(smem)) > limit:
                        continue
                    cfg = (threads, smem)
                    same = all(torch.equal(a, b)
                               for a, b in zip(chain(tab, cfg, drawn), want_dec))
                    ms = cuda_ms(lambda: chain(tab, cfg, drawn))
                    rows_out.append(dict(images=B, stream=stream, kernel="decode",
                                         table_bytes=nbytes, threads=threads, smem=smem,
                                         ms=ms, same=same,
                                         default=cfg == tdr.decode_launch_config(tab, lanes, dev)))
                    print(json.dumps(rows_out[-1]), flush=True)
            # the search's share of the decode: the same rows, every value
            # its row's most likely symbol, so that almost every lane's
            # bucket holds no CDF entry to search (default launch)
            host = host_tables[stream]
            mode = np.array([np.argmax(np.diff(host.quantized_cdf[r, :L - 1].astype(np.int64)))
                             for r, L in enumerate(host.cdf_length)])
            mode_values = torch.from_numpy(
                (mode[rows_np] + host.offset[rows_np]).astype(np.int32)).cuda()
            peaked = streams(mode_values)
            vals = chain(tab, None, peaked)
            rows_out.append(dict(images=B, stream=stream, kernel="decode", payload="mode",
                                 ms=cuda_ms(lambda: chain(tab, None, peaked)),
                                 same=torch.equal(torch.cat(vals[:-2]), mode_values)))
            print(json.dumps(rows_out[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows_out}, f, indent=1)
    bad = [r for r in rows_out if not r["same"]]
    if bad:
        print(f"{len(bad)} variants differ from the default launch: {bad[:3]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
