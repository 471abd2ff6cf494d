"""The card's rate for the tensor-core instruction the port's hand kernels
use, ``mma.sync.aligned.m16n8k16`` bf16 with f32 accumulators: the ceiling
against which the GDN kernels' bfloat16 design is read (``PERF.md`` §6).
The published 989 TFLOP/s is ``wgmma``'s.

    python3 tools/torch_mma_peak.py [--iters 2000]

Builds a probe kernel with nvcc (the flags of ``icm_tpu_torch._native``)
into the port's build directory: each warp runs ``chains`` independent
accumulators through ``iters`` rounds of mma, at a few block shapes, timed
with CUDA events (``chip_smoke.cuda_ms``). Prints the card's name and power
limit and one line of TFLOP/s per shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_probe(float* out, int iters) {
  const uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  const uint32_t b[2] = {0x3c003c00u ^ threadIdx.x, 0x3c003c00u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the sums live
}
extern "C" int mma_probe_run(float* out, int blocks, int threads, int iters, int chains,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 4) mma_probe<4><<<blocks, threads, 0, s>>>(out, iters);
  else if (chains == 8) mma_probe<8><<<blocks, threads, 0, s>>>(out, iters);
  else mma_probe<16><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

# (blocks, threads, independent accumulators a warp): one or more blocks an SM
SHAPES = [(132, 256, 4), (132, 256, 8), (132, 256, 16), (132, 384, 8), (132, 512, 8),
          (264, 512, 8), (528, 256, 8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mma_peak: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from icm_tpu_torch import _native

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    src = os.path.join(_native.BUILD_DIR, "mma_probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    lib = ctypes.CDLL(_native._build("libmma_probe", src, [_native._nvcc()], _native.NVCC_FLAGS))
    run = lib.mma_probe_run
    run.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    out = torch.empty(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, threads, chains in SHAPES:
        def launch():
            if run(out.data_ptr(), blocks, threads, args.iters, chains, stream) != 0:
                raise RuntimeError("mma probe launch failed")
        ms = smoke.cuda_ms(launch)
        flop = blocks * (threads // 32) * args.iters * chains * 2 * 16 * 8 * 16
        print(f"mma.sync m16n8k16 bf16: {blocks} blocks x {threads} threads, {chains} chains "
              f"a warp: {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
