"""Smoke run of icm_tpu_torch on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It needs one CUDA card, nvcc and g++,
and exits non-zero (printing no result) without a card or without the
package beside it. Phases, each printed with its elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the window-attention, GDN and lane-rANS kernels (nvcc, sm_90a)
   and the host rANS coder (g++), from the sources in the checkout, all
   at once;
3. window attention against its plain PyTorch version on the card, at
   the shapes of the full-width WACNN's path (head widths 24 and 40), of
   the full-width stf's (head width 16, windows of 16 tokens: 3, 6, 12
   and 24 heads over 8192, 2048, 512 and 128 windows) and of the zigzag
   family's refiners (4 heads: head width 8 over 128 windows of 16
   tokens (stf5) and 32 of 64 (stf7), head width 16 over 32 of 16 (stf6)
   and 8 of 64 (stf8), each at 1 and 4 window classes) and of the CRC
   family (8 heads: head width 32 over 512 windows of 64 tokens, 48 over
   128 of 16, each at 1 and 4 classes), then a ragged window count of
   each, in f32 and bf16; two launches must give the same bits; timed
   beside the plain version and F.scaled_dot_product_attention (a
   yardstick the port never calls);
4. the fused GDN forward and backward kernels against their plain
   versions at the training step's shapes (8 x 192 x 128^2, 64^2, 32^2,
   GDN and IGDN), the serving path's and one ragged shape, and the CRC
   family's 256 channels (2 x 256 x 128^2 serving, 8 x 256 x 64^2
   training), timed beside
   the plain versions; two launches of each must give the same bits; in
   float32 and then the bfloat16 builds (x, g, y, dx bfloat16, gamma
   rounded to it, beta float32);
5. the full-width WACNN (N=192, M=320, 10 slices) on the card with
   weights drawn from ``--seed``: compress -> decompress of 2 images of
   512x512 made from ``--seed``. The kernel launch counts are zeroed
   right before and read right after each side. Asserts a bit-exact
   y_hat, the decoder's x_hat equal to the encoder's, a finite bpp, and
   window-attention and GDN-forward launches on both sides;
6. the device wire's rANS kernels against their plain versions, byte for
   byte, at the path's shapes: encode y (2048 lanes x 320 steps, the 64
   Gaussian rows) and z (1024 lanes x 24 steps, the 192 bottleneck
   rows); decode y as 10 continued launches of 32 steps and z as one.
   Then the same at bench.py's batch of 32 images of 512x512 (y 32768
   lanes, z 16384). Payloads drawn from ``--seed`` and each row's
   distribution, about 1% escapes with int32 extremes among them; two
   launches must give the same bytes; timed beside the plain versions,
   with the kernels' compact tables' bytes beside lut2's;
7. the same weights and images on the device wire
   (``DeviceWireCodec``, 1024 lanes an image): compress -> decompress with
   the counts zeroed right before and read right after each side. Asserts
   a bit-exact y_hat and x_hat, y_hat equal to phase 5's host wire, the
   device wire's bytes within the host wire's x 1.02 plus each lane's
   flush and header, 2 encode launches per compress and one decode
   launch a slice and one for z (11) per decompress, window attention
   and the GDN forward on both sides, and that decompress made no host
   round trip
   (``torch.cuda.set_sync_debug_mode``); it logs the sha256 of the y and
   z blobs;
7a. the same weights and images on the scan wire
   (``DeviceWireCodec(scan_wire=True)``, float32), its four programs (the
   encode front, the conditioning, the chain one graph each way, assembly
   and synthesis) captured as CUDA graphs by a first compress and
   decompress (their seconds and the graphs' pool bytes logged), then
   held with the counts zeroed as in phase 7: y_hat and x_hat bit-exact,
   the device wire's launch counts (2 encode launches, 11 decode: 10 in
   the decode graph, z outside), no host round trip in decompress, each
   graph's launches a replay equal to the port's kernels in a traced
   replay (up to three traces: the trace has dropped a record), the blobs and y_hat / x_hat bits equal to the same functions
   launch by launch (``cuda_graphs=False``), y_hat against the device
   wire's within JAX's bar (under 0.5% of elements more than 1e-2 apart,
   median under 1e-4) and its y bytes within that share plus a tier byte
   a blob; encode and decode img/s graphed, launch by launch and on the
   device wire, with each side's device idle share;
7b. the same weights and images under the bfloat16 activation policy
   (``nn.set_activation_dtype(torch.bfloat16)``) on the host wire and the
   device wire, held as in phases 5 and 7 (y_hat bit-exact and x_hat
   equal on each wire, the device wire's y_hat equal to the host wire's)
   with the float32 phases' launch counts, all of them the bfloat16
   builds'; bpp within 5% and mean |x_hat - x_hat_f32| under 0.01 of the
   float32 runs (``tests/test_bf16.py``'s bars);
8. the same weights' eval forward on the card against the plain CPU path
   on a small input, in float32 and then under the bfloat16 policy on both
   sides (held to bars set from this comparison's readings on the card),
   with a control that must fail those bars: the card under the policy
   against the CPU in float32;
9. full-width WACNN training through ``train.run_training``: one epoch
   of 6 steps on seeded batches of 8 x 256 x 256, an eval batch, a
   checkpoint, and a resume for 2 more steps. Every step's loss, bpp and
   aux loss must be finite, the parameters must move, and each step must
   launch the three kernels (counts zeroed before it and read after it);
10. one training step of the trained weights on the card against the
    plain CPU path on a small input, with the same noise: the loss terms
    and every parameter's gradient;
10b. 3 training steps under the bfloat16 policy from the weights phase 9
    started from, on its batches and noise: every loss, bpp and aux loss
    finite, the parameters moved, the gradients float32, each step
    launching the bfloat16 GDN forward and backward 6 times (and window
    attention 4), the first step's bpp within 5% of phase 9's;
11. the full-width Swin codec stf (embed 48, depths 2/2/6/2, heads
    3/6/12/24, window 4, M=384, 12 slices) with weights drawn from
    ``--seed``, on the same images: compress -> decompress on the host
    wire, held as in phase 5, with one window-attention launch a Swin
    block (24 on compress with its debug reconstruction, 12 on
    decompress) and no GDN or lane-rANS launch;
12. the lane-rANS kernels as in phase 6 at stf's shapes (y 2048 lanes x
    384 steps decoded in 12 launches of 32, z 1024 x 24);
13. stf on the device wire, held as in phase 7: 2 encode launches and 13
    decode launches (12 slices and z), 24 / 12 window-attention launches,
    no host round trip in decompress;
13a. stf on the scan wire, held as in phase 7a (13 decode launches);
14. stf's eval forward on the card against the plain CPU path on a
    small input, as phase 8;
15. full-width stf training through ``train.run_training``: 4 steps of
    8 x 256 x 256 with stochastic depth, an eval batch; every step's
    loss, bpp and aux loss finite, the parameters moved, 24
    window-attention launches a step and no other kernel's; the peak
    device memory logged;
16. one stf training step on the card against the plain CPU path, as
    phase 10, with stochastic depth 0;
17. stf under the bfloat16 policy: serving as phase 7b (after phase 13)
    and training as phase 10b (24 bfloat16 window-attention launches a
    step);
18. a reference checkpoint at full width: a seeded reference WACNN state
    dict (the reference's module names, legacy bottleneck keys, ``module.``
    prefix) converted by ``icm_tpu_torch.zoo`` and loaded strictly; the
    converted model's own CDF tables written into it as the reference's
    buffers and imported back equal; the images of phase 5 on the host
    wire with the imported tables in the reference symbol order
    (``ref_layout=True``), held as in phase 5, the blobs equal to the
    built tables' in that order;
19-22. the zigzag family stf5, stf6, stf7 and stf8 at their published
    full width (weights from ``--seed``, f32), each on the images of phase
    5 on the host wire and the device wire, held as in phases 5 and 7:
    one window-attention launch a Swin block (compress 24 + r with its
    debug reconstruction, decompress 12 + r, r the refiners' 432, 288,
    240 and 480 blocks), no GDN launch, 2 encode and ctx_slices + 1 (13,
    25, 13, 25) decode launches, no host round trip in decompress, the
    device wire's y_hat the host wire's and its bytes within the bound
    counted with each slice's lanes (a 16 x 16 zigzag block: 256 an
    image); each model's eval forward on the card against the plain CPU
    path on one 256 x 256 image (x_hat and y likelihoods within 1e-3);
    stf8's phase also holds the lane-rANS kernels at the zigzag blocks'
    shapes (y 512 lanes x 1536 steps in 24 decode launches); stf7's eval
    forward is also held under the bfloat16 policy on both sides at 64 x
    64, as phase 14's end to end;
23. each family model on the scan wire (``ZigzagSwinScanWire``: the chain
    with its refiners, padded first convolutions), held as in phase 7a:
    capture seconds and pool bytes of each graph, bit-exact, equal to
    launch by launch, counted launches a replay equal to a traced
    replay's, the device wire's launch counts (one decode launch a slice
    inside the decode graph, none of the encode kernel inside the encode
    graph), no host round trip in decompress, y_hat and bytes against the
    device wire's, img/s and idle graphed, launch by launch and on the
    device wire; its graphs and stacked weights are freed before the next
    model;
24. each family model under the bfloat16 policy on both wires, as phase
    7b (the refiners' window attention in its bfloat16 builds: head width
    8 padded to 16, and 16), and its scan wire refusing the policy; phases
    19-24 time each wire once (``FAMILY_REPS``), not the median of 3;
25. stf7 and stf8 training (``run_training``, 8 x 256 x 256): 3 steps of
    the registry's unrolled forward, then 3 of the ``scan_charm=True``
    forward at the presets' stochastic depth 0.2 (the refiners' too), each
    step finite, the parameters moved, one window-attention launch a Swin
    block (g_a, g_s and the refiners) and no other kernel's; img/s and
    peak memory of both; one ``scan_charm`` step against the CPU at depth
    0, as phase 16;
26. 3 bfloat16 training steps of each, as phase 17;
27-28. the CRC family's stf9 (stf11 is its class and weights) and stf14
    at their published full width (N=192, M=384, mid=256, 6 x 2x2 zigzag
    = 24 slices, weights from ``--seed``, f32), each on the images of
    phase 5 at ``narrow=0.2`` with ``CRCCodec`` on the host wire, the
    device wire and the scan wire (graphed, and launch by launch), each
    side's counts zeroed right before and read right after: y_hat and
    x_hat bit-exact; window attention's launches by head width (24, 48,
    32) and GDN's by channels (192, 256) as CRC_SIDE_LAUNCHES says
    (stf9: compress 4 / 6, decompress none; stf14: 6 / 9 and 2 / 3); 4
    encode launches a compress and 27 decode launches a decompress (24
    slices, both z, the human y) on the device and scan wires; no host
    round trip in decompress; the device wire's y_hat and x_hat the host
    wire's and each stream's bytes within the host wire's x 1.02 plus
    its lanes' flushes (256 lanes an image for the machine y, 1024 for
    the human y); the scan wire held as phase 7a (graphs against a
    traced replay and against launch by launch, y_hat within JAX's bar
    of the device wire's) and refusing the bf16 policy; each side's
    img/s (median of 3), device idle share and ATen calls on each wire;
    the eval forward against the CPU's on one 256 x 256 image (x_hat,
    machine_x_hat, both y likelihoods within 1e-3);
29. stf9 training (``run_training``, 8 x 256 x 256, RateDistortionLoss
    over both layers' likelihoods): 3 steps, each finite, 6 window
    attention, 9 GDN forward and 6 GDN backward launches (the split
    decoder g_s1 / g_s2 gives machine_x_hat, which no loss term reads:
    its parameters must not move, all others must), by width and
    channels as CRC_STEP_SHAPES; img/s and peak memory; one step card
    against CPU as phase 10;
30. a reference stf9 checkpoint at full width, as phase 18 (both
    bottlenecks' and the Gaussian's tables stored and imported, the host
    wire in the reference symbol order).

Each serving phase also logs its sides' device idle share: one traced
compress and decompress (the union of the trace's kernel, copy and memset
intervals) against the median untraced wall time.

The kernels line lists window attention's head widths 32 and 48 and the
GDN kernels at 256 channels (``window_attention_d32``, ``_d48``,
``gdn_forward_c256``, ``gdn_backward_c256``) with their launches on the
CRC paths, read from the wrappers' counts by width and channels. It
splits window attention's launches on the family paths
between the transforms (under ``window_attention_d16`` and its bfloat16
entry, at stf's shapes) and the refiners (``window_attention_d8`` for
stf5 and stf7, ``window_attention_d16_refiners`` for stf6 and stf8, and
their ``_bf16`` entries), from the phases' exact counts.

The wrappers of window attention and GDN count their launches by dtype;
a float32 phase fails on a launch of a bfloat16 build and a bfloat16
phase on one of a float32 build. The kernels line lists the bfloat16
builds beside the float32 ones, with the bfloat16 phases' launches. It
then prints the kernels line (JSON), the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result. Each kernel's ``bound_ms`` counts
the operations the function needs at the tensor cores' rate, against its
bytes: the f32 products of window attention and of the float32 GDN
builds as three TF32 products each, the bfloat16 GDN builds' products as
the fewest bfloat16 products that give the float32 sums
(``GDN_BF16_PASSES``), the rest on the f32 units; ``f32_fma_bound_ms``
counts every operation at the f32 FMA rate. The rANS kernels' bound
counts the bytes this run's data needs (each distinct table entry once)
against their integer operations; beside their time stands the first
lane's alone (``one_lane_ms``).
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

# the card's published peaks (H100 SXM data sheet), for each kernel's bound:
# f32 on the FMA units, bf16 and TF32 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# the f32 products of window attention and of both GDN kernels run on the
# tensor cores in 3xTF32: three TF32 products for each f32 product
TF32_PASSES = 3
# the bfloat16 GDN builds' products in bfloat16 passes (989 TFLOP/s), the
# fewest that give the float32 sums: gamma is bfloat16 (one piece), x^2 of
# a bfloat16 x has at most 16 significant bits (two pieces, exactly) and
# dn is float32 (three pieces). The forward's gamma . x^2: 1 x 2 = 2. The
# backward: gamma . x^2 again (2), Gamma^T dn (1 x 3 = 3) and dn (x^2)^T
# (3 x 2 pieces less the one below 2^-24 of the sum, as 3xTF32 drops
# lo*lo: 5). The kernels run these products in TF32 (gamma exact, so two
# passes where gamma is an operand, and three for dn (x^2)^T)
GDN_BF16_PASSES = {"forward": 2, "backward": 2 + 3 + 5}

# stated tolerances of the kernel against its plain version on the card:
# f32 sums of the same terms in another order (outputs O(1)); in bf16 the
# probabilities and the output are rounded to 8-bit mantissas, and a value
# on the other side of a rounding boundary moves the output by one ulp
# (2**-7 relative, outputs up to ~2)
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}

# the GDN kernels against their plain versions: y and dx absolutely (sums
# of 192 products in another order, values O(1)); dgamma and dbeta
# relative to each tensor's max, since each is a sum over up to 131072
# rows, taken here in two fixed stages and by cuBLAS in its own order
GDN_TOLERANCE = {"y": 1e-5, "dx": 1e-5, "dgamma": 1e-4, "dbeta": 1e-4}
# their bfloat16 builds: y and dx rounded once from float32 values that
# differ from the plain version's in float order, so a value across a
# rounding boundary moves by one ulp (2**-8 to 2**-7 of it): window
# attention's bfloat16 bar, 2e-2, below 1 and relative above (IGDN values
# reach ~13), err = max |kernel - plain| / max(1, |plain|); dgamma
# (rounded to bfloat16) and dbeta relative to their max
GDN_BF16_TOLERANCE = {"y": 2e-2, "dx": 2e-2, "dgamma": 1e-2, "dbeta": 1e-2}
# the bfloat16 policy's serving and training against float32 on the same
# weights and images: tests/test_bf16.py's bars
BF16_XHAT_MEAN_TOL = 0.01
BF16_BPP_RTOL = 0.05
# the eval forward under the bfloat16 policy on both sides, card against
# CPU (phases 8 and 14), end to end: mean |x_hat difference| and the share
# of y likelihoods that differ by more than 1e-3 (a symbol rounded the
# other way: with untrained weights most likelihoods sit near 1, and a
# flipped symbol moves one to ~1e-9). A float32 sum in another order that
# lands across a bfloat16 rounding boundary moves an output by an ulp, and
# the next layers carry that on, so two bfloat16 runs differ end to end
# almost as much as bfloat16 from float32 (read on the card: x_hat 1.6e-3
# and 8.5e-3 of mean difference for cnn and stf, 2.6e-3 and 9.5e-3 against
# the CPU in float32): these bars, twice the larger readings, catch a
# broken path, not a policy ignored on one side
BF16_EVAL_TOL = {"x_hat_mean": 0.02, "y_likelihood_share": 0.01, "z_likelihood_max": 1e-3}
# so each policy layer, GDN and window attention of the card's bfloat16
# forward is also replayed on the CPU twin's module from the same inputs:
# the share of its outputs that differ at all, and the largest difference
# relative to its largest output. Set from the card's readings; the
# control (the CPU module in float32 on the same inputs) differs almost
# everywhere and must exceed the share bar at every call
BF16_LAYER_TOL = {"share": 0.05, "relative": 0.02}
# the scan wire's y_hat against the device wire's, which sums its first
# context conv in another order (the padded stacked weights): JAX's bar
# (tests/test_device_codec.py::test_scan_wire_roundtrip_cnn), the share of
# elements more than 1e-2 apart and the median difference; its y bytes
# within that share of the device wire's, plus the tier byte a blob
SCAN_VS_DEVICE = {"share_above_1e-2": 0.005, "median": 1e-4}
# the port's kernels by the names of their CUDA functions in a trace,
# under the names of the launch counters (graphs.launch_counts)
TRACE_TRIES = 3
# kernels each traced session runs before the traced call (see trace_events),
# and the name of the call's marker in the trace
TRACE_WARMUP_KERNELS = 64
TRACE_MARK = "chip_smoke_traced_call"
TRACE_KERNELS = {"window_attention": "window_attention_kernel",
                 "gdn_forward": "gdn_fwd_kernel", "gdn_backward": "gdn_bwd_kernel",
                 "ENCODE_LAUNCHES": "rans_encode_lanes_kernel",
                 "DECODE_LAUNCHES": "rans_decode_lanes_kernel"}
# one training step, card against CPU, each loss term and each gradient
# relative to its max: f32 on both, ~70 layers forward and back with sums
# in other orders (cuDNN and the kernels against oneDNN and the plain
# versions), through the log-likelihoods
TRAIN_TOLERANCE = 1e-3

# the rANS kernels: 32-bit integer operations on the CUDA cores, 64 of an
# SM's 128 lanes a clock (half the f32 rate)
INT32_OPS_PER_S = PEAK_OPS_PER_S["float32"] / 2
INT32_EXTREMES = np.array([2 ** 31 - 1, -(2 ** 31), 2 ** 20, -12345678], np.int64)
# phase 6's second case: bench.py's default batch (bench.py:270)
RANS_BENCH_IMAGES = 32


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
    not the host's launch overhead: for at least 1 ms, and for four times
    the host's time to enqueue one call (a plain version of many small
    launches can take the host longer than its work takes the card)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(max(1e-3, 4 * host_s) * 2e9)  # cycles; at most 1.98 GHz on an H100
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(t_bytes: float, t_ops: float):
    """The larger of the two least times -> (ms, "bytes" | "operations")."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(W, H, N, D, n_cls, dtype: str):
    """Least time for the work: each input read once, the output written
    once, against the operations on the unit the kernel runs them on: the
    two products on the tensor cores (bf16; f32 as three TF32 products) and
    the softmax on the f32 units. -> (ms, "bytes" | "operations", and the
    f32-FMA bound: every operation at the f32 rate, (ms, by))."""
    elt = 4 if dtype == "float32" else 2
    nbytes = 4 * W * H * N * D * elt + n_cls * H * N * N * 4 + W * 4
    products = W * H * 4 * N * N * D
    softmax = W * H * 5 * N * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == "float32":
        t_mma = TF32_PASSES * products / PEAK_OPS_PER_S["tf32"] * 1e3
    else:
        t_mma = products / PEAK_OPS_PER_S["bfloat16"] * 1e3
    t_ops = t_mma + softmax / PEAK_OPS_PER_S["float32"] * 1e3
    fma = bound(t_bytes, (products + softmax) / PEAK_OPS_PER_S["float32"] * 1e3)
    return (*bound(t_bytes, t_ops), fma)


def attention_inputs(W, N, D, n_cls, dtype, seed, heads=8):
    import torch

    rng = np.random.default_rng(seed)
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


# stf's window-attention launches at 2 x 512 px, by shape (W, heads): its
# 4x4 windows give N = 16 and D = 16 at every stage; g_a's stages (depths
# 2, 2, 6, 2) and g_s's (2, 6, 2, 2, the other way round) launch each shape
# the same number of times a side
STF_SIDE_LAUNCHES = {(8192, 3): 2, (2048, 6): 2, (512, 12): 6, (128, 24): 2}
# the zigzag family: its transforms are stf's; each slice's refiners attend
# at 4 heads over the slice, at 2 x 512 px (W, N, D): stf5 and stf7 on 32 x
# 32 channel slices of 32 channels at windows 4 and 8, stf6 and stf8 on 16
# x 16 zigzag blocks of 64 channels at windows 4 and 8. Their Swin blocks
# a side (one launch each), half of them at the shifted windows' 4 classes
FAMILY = ("stf5", "stf6", "stf7", "stf8")
FAMILY_REFINER_SHAPES = {"stf5": (128, 16, 8), "stf6": (32, 16, 16), "stf7": (32, 64, 8),
                         "stf8": (8, 64, 16)}
FAMILY_REFINER_BLOCKS = {"stf5": 432, "stf6": 288, "stf7": 240, "stf8": 480}
REFINER_HEADS = 4
# the family's training presets: a channel-slice one and a zigzag one (the
# largest: 418 M parameters with Adam's moments); and the preset whose
# bfloat16 eval forward is held against the CPU
FAMILY_TRAIN = ("stf7", "stf8")
FAMILY_BF16_EVAL = "stf7"
# host-clock calls whose median gives a family wire's img/s: one, so that the
# CRC phases fit the run's time (the other models' wires take the median of 3)
FAMILY_REPS = 1
# the CRC family (stf11 is stf9's class and weights): window attention at
# 2 x 512 px by head width -> (W, N): MainCNNDecoder's 256-channel block
# (128 x 128 at window 8) and every 384-channel block (32 x 32 at window
# 4), 8 heads; a training step of 8 x 256^2 gives the same shapes. Its
# launches by side and model (g_a, human_g_s2; stf14's decoder runs
# human_g_s2 again): by head width 24, 48, 32, and the GDN forward's at
# 192 and 256 channels
CRC = ("stf9", "stf14")
CRC_ATTENTION_SHAPES = {32: (512, 64), 48: (128, 16)}
CRC_SIDE_LAUNCHES = {
    "stf9": {"compress": {24: 1, 48: 2, 32: 1, "gdn192": 5, "gdn256": 1},
             "decompress": {}},
    "stf14": {"compress": {24: 1, 48: 3, 32: 2, "gdn192": 7, "gdn256": 2},
              "decompress": {48: 1, 32: 1, "gdn192": 2, "gdn256": 1}},
}
# a training step of stf9 forward: g_a, g_s1 and human_g_s2 (6 attention,
# 9 GDN: 2 at 256 channels); backward: the split decoder g_s1 / g_s2 feeds
# no loss term (machine_x_hat), so 6 GDN backward launches, 1 at 256
CRC_STEP = {"window_attention": 6, "gdn_forward": 9, "gdn_backward": 6,
            "rans_encode": 0, "rans_decode": 0}
CRC_STEP_SHAPES = {"window_attention": {"float32 D24": 1, "float32 D32": 2, "float32 D48": 3},
                   "gdn": {"backward float32 C192": 5, "backward float32 C256": 1,
                           "forward float32 C192": 7, "forward float32 C256": 2}}
CRC_LIKELIHOODS = ("likelihoods", "machine_likelihoods")


def check_kernel(twa):
    """Phase 3: kernel vs plain version at the codecs' shapes. -> rows,
    each tagged with the model whose path gives the shape."""
    import torch
    import torch.nn.functional as F

    B = 2  # images per compress call in phases 5 and 11
    cases = [
        # (model, W, heads, N, D, n_cls): the two shapes the 512-px WACNN
        # gives the kernel (g_a block 1 / g_s block 2: 128x128x192, window 8,
        # shift 4; g_a block 2 / g_s block 1: 32x32x320, window 4, shift 2),
        # then one window class and a ragged window count
        ("cnn", 256 * B, 8, 64, 24, 4),
        ("cnn", 64 * B, 8, 16, 40, 4),
        ("cnn", 256 * B, 8, 64, 24, 1),
        ("cnn", 100, 8, 64, 24, 4),
        ("cnn", 100, 8, 16, 40, 4),
    ]
    # stf's four shapes (the shifted blocks' four classes), then one window
    # class and a ragged window count
    cases += [("stf", W, H, 16, 16, 4) for W, H in STF_SIDE_LAUNCHES]
    cases += [("stf", 512, 12, 16, 16, 1), ("stf", 8191, 3, 16, 16, 4)]
    # the family refiners' shapes, unshifted (1 class) and shifted (4), then
    # a ragged window count of each head width and window
    cases += [(m, W, REFINER_HEADS, N, D, n_cls) for m, (W, N, D) in FAMILY_REFINER_SHAPES.items()
              for n_cls in (1, 4)]
    cases += [("stf5", 127, REFINER_HEADS, 16, 8, 4), ("stf7", 31, REFINER_HEADS, 64, 8, 4),
              ("stf8", 7, REFINER_HEADS, 64, 16, 4)]
    # the CRC family's new widths (CRC_ATTENTION_SHAPES), at the shifted
    # blocks' 4 classes and at 1, then a ragged window count of each
    cases += [("crc", W, 8, N, D, n_cls) for D, (W, N) in CRC_ATTENTION_SHAPES.items()
              for n_cls in (4, 1)]
    cases += [("crc", 100, 8, 64, 32, 4), ("crc", 37, 8, 16, 48, 4)]
    rows = []
    for dtype in ("float32", "bfloat16"):
        for model, W, heads, N, D, n_cls in cases:
            ins = attention_inputs(W, N, D, n_cls, dtype, seed=W + N + D + n_cls, heads=heads)
            out = twa.window_attention_cuda(*ins)
            torch.cuda.synchronize()
            ref = twa.window_attention_reference(*ins)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOLERANCE[dtype]
            ok = bool(torch.isfinite(out).all()) and err <= tol
            same_bits = torch.equal(twa.window_attention_cuda(*ins), out)
            q, k, v, bias, cls = ins
            mask = bias[cls.long()].to(q.dtype)
            row = dict(
                model=model, W=W, heads=heads, N=N, D=D, n_cls=n_cls, dtype=dtype,
                max_abs_err=err, tolerance=tol, same_bits_twice=same_bits,
                ms=cuda_ms(lambda: twa.window_attention_cuda(*ins)),
                plain_ms=cuda_ms(lambda: twa.window_attention_reference(*ins)),
                library_ms=cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            )
            (row["bound_ms"], row["bound_by"],
             (row["f32_fma_bound_ms"], row["f32_fma_bound_by"])) = attention_bound_ms(
                W, heads, N, D, n_cls, dtype)
            rows.append(row)
            log(f"  window_attention ({model}) W={W} H={heads} N={N} D={D} n_cls={n_cls} "
                f"{dtype}: max_abs_err {err:.3e} (tolerance {tol:g}) ms {row['ms']:.4f} "
                f"plain {row['plain_ms']:.4f} sdpa {row['library_ms']:.4f} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok or not same_bits:
                raise AssertionError(
                    f"kernel disagrees with its plain version or with itself: {row}")
    return rows


def gdn_bound_ms(B, C, P, backward: bool, dtype: str = "float32"):
    """Least time for the fused GDN work: x (and g) read once, y (dx)
    written once, in ``dtype`` (4 or 2 bytes a value); gamma and beta read
    (and their gradients written) once, in float32; against one C x C
    product per pixel (three in the backward) plus the elementwise work (4
    operations per element forward: square, add beta, rsqrt, multiply; 14
    backward) on the f32 units. The products on the tensor cores: float32
    as three TF32 products each, bfloat16 as ``GDN_BF16_PASSES`` bfloat16
    products. -> (ms, "bytes" | "operations", and the f32-FMA bound (ms,
    by))."""
    elems = B * C * P
    elt = 4 if dtype == "float32" else 2
    if backward:
        nbytes = elt * 3 * elems + 4 * 2 * (C * C + C)
        products, elementwise = 6 * C * C * B * P, 14 * elems
    else:
        nbytes = elt * 2 * elems + 4 * (C * C + C)
        products, elementwise = 2 * C * C * B * P, 4 * elems
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    fma = bound(t_bytes, (products + elementwise) / PEAK_OPS_PER_S["float32"] * 1e3)
    if dtype == "float32":
        t_mma = TF32_PASSES * products / PEAK_OPS_PER_S["tf32"]
    else:
        passes = GDN_BF16_PASSES["backward" if backward else "forward"]
        t_mma = passes * 2 * C * C * B * P / PEAK_OPS_PER_S["bfloat16"]
    t_ops = (t_mma + elementwise / PEAK_OPS_PER_S["float32"]) * 1e3
    return (*bound(t_bytes, t_ops), fma)


def gdn_errors(got, ref, dtype: str) -> dict:
    """y / dx absolutely (bfloat16: relative above 1, see
    GDN_BF16_TOLERANCE), dgamma and dbeta relative to their max."""
    out = {}
    for key, a, b in zip(("y", "dx", "dgamma", "dbeta"), got, ref):
        d = (a.float() - b.float()).abs()
        if key in ("y", "dx"):
            out[key] = (d / b.float().abs().clamp_min(1.0) if dtype == "bfloat16" else d).max().item()
        else:
            out[key] = (d.max() / b.float().abs().max()).item()
    return out


def check_gdn(tgdn):
    """Phase 4: the GDN kernels vs their plain versions, float32 and then
    bfloat16. -> rows."""
    import torch

    # (path, B, C, H, W): the GDN layers of the training step (8 x 256 px)
    # and of compress/decompress (2 x 512 px), then a ragged row count
    cases = [("train", 8, 192, s, s) for s in (128, 64, 32)]
    cases += [("serve", 2, 192, s, s) for s in (256, 128, 64)]
    cases.append(("ragged", 3, 192, 13, 21))  # 273 pixels, 9 tiles of 32
    # the CRC family's 256-channel IGDN (MainCNNDecoder's): serving 2 x
    # 512^2, training 8 x 256^2
    cases += [("crc_serve", 2, 256, 128, 128), ("crc_train", 8, 256, 64, 64)]
    rows = []
    for dtype, (path, B, C, H, W) in ((d, c) for d in ("float32", "bfloat16") for c in cases):
        rng = np.random.default_rng([B, H, W])
        dev = torch.device("cuda")
        x, g = (torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32)).to(dev)
                for _ in range(2))
        gamma = torch.from_numpy(  # (C_out, C_in), not symmetric
            (0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32)).to(dev)
        beta = torch.from_numpy((1.0 + 0.1 * rng.random(C)).astype(np.float32)).to(dev)
        # bfloat16: x, g and gamma (in x's dtype, as the module gives it) rounded
        x, g, gamma = (t.to(getattr(torch, dtype)) for t in (x, g, gamma))
        tolerance = GDN_TOLERANCE if dtype == "float32" else GDN_BF16_TOLERANCE
        for inverse in (False, True):
            y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
            y_again = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
            dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
            again = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
            torch.cuda.synchronize()
            y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
            refs = (y_ref, *tgdn.gdn_backward_reference(g, x, gamma, beta, inverse))
            err = gdn_errors((y, dx, dgamma, dbeta), refs, dtype)
            deterministic = torch.equal(y_again, y) and all(
                torch.equal(a, b) for a, b in zip(again, (dx, dgamma, dbeta)))
            row = dict(path=path, B=B, C=C, H=H, W=W, inverse=inverse, dtype=dtype, err=err,
                       max_abs_err={k: (a.float() - b.float()).abs().max().item() for k, a, b in
                                    (("y", y, y_ref), ("dx", dx, refs[1]))},
                       deterministic=deterministic, tolerance=tolerance)
            P = H * W
            for name, kernel, plain, backward in (
                ("forward", lambda: tgdn.gdn_forward_cuda(x, gamma, beta, inverse),
                 lambda: tgdn.gdn_forward_reference(x, gamma, beta, inverse), False),
                ("backward", lambda: tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse),
                 lambda: tgdn.gdn_backward_reference(g, x, gamma, beta, inverse), True),
            ):
                bound_ms, by, (fma_ms, fma_by) = gdn_bound_ms(B, C, P, backward, dtype)
                row[name] = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                                 bound_ms=bound_ms, bound_by=by,
                                 f32_fma_bound_ms=fma_ms, f32_fma_bound_by=fma_by)
            rows.append(row)
            f, b = row["forward"], row["backward"]
            log(f"  gdn {dtype} {path} {B}x{C}x{H}x{W} inverse={inverse}: err "
                f"{ {k: f'{v:.2e}' for k, v in err.items()} } deterministic {deterministic}; "
                f"forward ms {f['ms']:.4f} plain {f['plain_ms']:.4f} bound {f['bound_ms']:.4f} "
                f"({f['bound_by']}); backward ms {b['ms']:.4f} plain {b['plain_ms']:.4f} "
                f"bound {b['bound_ms']:.4f} ({b['bound_by']})")
            finite = all(bool(torch.isfinite(t).all()) for t in (y, dx, dgamma, dbeta))
            types = (y.dtype, dx.dtype, dgamma.dtype, dbeta.dtype) == (
                x.dtype, x.dtype, gamma.dtype, torch.float32)
            if not finite or not types or not deterministic or any(
                    err[k] > tolerance[k] for k in err):
                raise AssertionError(f"GDN kernels disagree with their plain versions "
                                     f"(tolerances {tolerance}): {row}")
    return rows


def rans_payload(host, rows: np.ndarray, rng, esc_share: float = 0.01) -> np.ndarray:
    """Values for ``rows`` drawn from each row's own distribution, then
    about ``esc_share`` of them replaced by escapes (values past the row's
    support, half of them int32 extremes)."""
    peek = rng.integers(0, 1 << 16, size=rows.shape)
    sym = np.empty(rows.shape, np.int64)
    for r in np.unique(rows):
        at = rows == r
        L = int(host.cdf_length[r])
        sym[at] = np.clip(np.searchsorted(host.quantized_cdf[r, :L], peek[at], "right") - 1,
                          0, L - 3)
    offs = host.offset[rows].astype(np.int64)
    wild = np.where(rng.random(rows.shape) < 0.5, rng.choice(INT32_EXTREMES, rows.shape),
                    offs + host.cdf_length[rows] + rng.integers(0, 1000, rows.shape))
    values = np.where(rng.random(rows.shape) < esc_share, wild, sym + offs)
    return values.astype(np.int32)


def rans_bounds(host, values, rows, n_words: int, decode: bool):
    """Least time of the encode or the decode chain on this data: the
    bytes it must move (each input once, each output once; of the tables,
    each distinct entry this data needs: a lut2 pair or an fc entry per
    distinct (row, symbol), an eo pair per distinct row) at 3.35 TB/s,
    against its integer operations (~12 a symbol decoding, ~40 encoding
    with the 32-bit division) at INT32_OPS_PER_S. -> (ms, by)."""
    T, lanes = values.shape
    u = values.astype(np.int64) - host.offset[rows]
    es = host.cdf_length[rows].astype(np.int64) - 2
    sym = np.where((u < 0) | (u >= es), es, u)
    pairs = np.unique(rows.astype(np.int64) * 65536 + sym).size
    n = T * lanes
    if decode:
        nbytes = 2 * n_words + 4 * lanes + 4 * n + 8 * pairs + 4 * n + 8 * lanes
        ops = 12 * n
    else:
        nbytes = 8 * n + 4 * pairs + 8 * np.unique(rows).size + 2 * lanes * (T + 2) + 4 * lanes + n
        ops = 40 * n
    return bound(nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3)


def check_rans(kit, tables, seed: int, B: int, size: int, model, model_name: str):
    """Phases 6, 12 and 22: the lane-rANS kernels vs their plain versions
    at the device wire's shapes for ``model``'s latent (``model.ctx_slices``
    slices, each one decode launch; a slice is a zigzag block in the
    family) and B images of size^2 -> rows (y, z), each with
    ``model_name`` and its image count.
    Besides the
    launches' time, each part is timed on the first lane alone
    (``one_lane_ms``): the dependent chain of T steps with nothing beside
    it."""
    import torch

    from icm_tpu_torch.coding import device_rans as tdr

    def same(got, want, what) -> int:
        """-> the largest |kernel - plain| over the outputs; raises
        unless every output has the same dtype, shape and values."""
        err = 0
        for a, b in zip(got, want, strict=True):
            if isinstance(a, torch.Tensor):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} against "
                                         f"{b.dtype}{tuple(b.shape)}")
                if a.numel():
                    err = max(err, int((a.long() - b.long()).abs().max()))
            else:
                err = max(err, abs(a - b))
        if err:
            raise AssertionError(f"{what}: kernel and plain version differ by up to {err}")
        return err

    rng = np.random.default_rng(seed + 7)
    h, w = y_slice_hw(model, size)
    n_l = kit.n_lanes(h, w)
    S, sc = model.ctx_slices, model.M // model.num_slices
    rows_y = rng.integers(0, kit.gauss_dev.num_rows, size=(S * (h * w // n_l) * sc, B * n_l))
    zh = zw = size // 64
    eb = kit.eb_dev["entropy_bottleneck"]
    C = eb.num_rows
    rows_z = kit.z_rows(C, kit.z_groups(C), B * zh * zw).cpu().numpy()
    out = []
    for name, host, tab, rows_np, n_launches in (
            ("y", tables.gaussian, kit.gauss_dev, rows_y, S),
            ("z", tables.bottlenecks["entropy_bottleneck"], eb, rows_z, 1)):
        values_np = rans_payload(host, rows_np, rng)
        values = torch.from_numpy(values_np).cuda()
        rows = torch.from_numpy(rows_np.astype(np.int32)).cuda()
        T, lanes = values.shape
        enc = tdr.encode_lanes_cuda(values, rows, tab)
        err = same(tdr.encode_lanes_cuda(values, rows, tab), enc, f"{name} encode, two launches")
        err = max(err, same(tdr.encode_lanes_reference(values, rows, tab), enc, f"{name} encode"))
        buf, lengths, dest, raw, n_esc = enc
        len_h = lengths.cpu().numpy()
        words = torch.from_numpy(tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h)
                                 .view(np.int16)).cuda()
        off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
        seg = T // n_launches

        def chain(fn, off=off, rows=rows):
            """The n_launches continued decode launches -> (each launch's
            values, state, ptr); nothing but the launches runs."""
            state = ptr = None
            parts = []
            for i in range(n_launches):
                vals, state, ptr = fn(words, off, rows[i * seg:(i + 1) * seg], tab, state, ptr)
                parts.append(vals)
            return parts, state, ptr

        def flat(dec):
            return [*dec[0], dec[1], dec[2]]

        dec = chain(tdr.decode_lanes_cuda)
        err = max(err, same(flat(chain(tdr.decode_lanes_cuda)), flat(dec),
                            f"{name} decode, two runs"))
        err = max(err, same(flat(chain(tdr.decode_lanes_reference)), flat(dec), f"{name} decode"))
        if not torch.equal(tdr.fix_escapes(torch.cat(dec[0]), dest, raw), values):
            raise AssertionError(f"{name}: decoded values differ from the encoded ones")
        if not torch.equal(dec[2], lengths):
            raise AssertionError(f"{name}: decode did not read every word")
        row = dict(model=model_name, images=B, stream=name, T=T, lanes=lanes,
                   launches_decode=n_launches,
                   table_rows=tab.num_rows, n_escapes=n_esc, words=int(words.numel()),
                   max_abs_err=err)
        v1, r1, o1 = values[:, :1].contiguous(), rows[:, :1].contiguous(), off[:1]
        for part, run, one_lane, plain, decode in (
                ("encode", lambda: tdr.encode_lanes_kernel(values, rows, tab),
                 lambda: tdr.encode_lanes_kernel(v1, r1, tab),
                 lambda: tdr.encode_lanes_reference(values, rows, tab), False),
                ("decode", lambda: chain(tdr.decode_lanes_cuda),
                 lambda: chain(tdr.decode_lanes_cuda, o1, r1),
                 lambda: chain(tdr.decode_lanes_reference), True)):
            ms, by = rans_bounds(host, values_np, rows_np, int(words.numel()), decode)
            row[part] = dict(ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=3), bound_ms=ms,
                             bound_by=by, one_lane_ms=cuda_ms(one_lane))
        out.append(row)
        e, d = row["encode"], row["decode"]
        log(f"  rans {name} ({model_name}), {B} images: {lanes} lanes x T={T} "
            f"({n_launches} decode launches of "
            f"{seg}), {n_esc} escapes, {row['words']} words: same bytes as the plain versions "
            f"and launch to launch (max |kernel - plain| {err}); encode ms {e['ms']:.4f} "
            f"(one lane alone {e['one_lane_ms']:.4f}) plain {e['plain_ms']:.2f} bound "
            f"{e['bound_ms']:.5f} ({e['bound_by']}); decode ms {d['ms']:.4f} (one lane alone "
            f"{d['one_lane_ms']:.4f}) plain {d['plain_ms']:.2f} bound {d['bound_ms']:.5f} "
            f"({d['bound_by']})")
    return out


def trace_events(fn) -> list:
    """The chrome-trace events of one traced call of ``fn`` on the card.
    The profiler has lost the first records of a session (late in a long
    run, the first 14-15 kernels of a traced call, launch by launch as
    in a graph replay), so each session first runs TRACE_WARMUP_KERNELS
    tiny kernels and waits for them; only the events from the call's own
    marker on are returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_WARMUP_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        with record_function(TRACE_MARK):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    start = min(e["ts"] for e in events if e.get("name") == TRACE_MARK and "ts" in e)
    return [e for e in events if e.get("ts", start - 1) >= start]


def device_busy_ms(fn) -> float:
    """Device busy time of one traced call of ``fn``: the length of the
    union of its kernel, copy and memset intervals in the trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events(fn)
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us / 1e3


def idle_shares(codec, x, enc_s, dec_s) -> dict:
    """Each side's device busy ms (one traced call) and idle share against
    the median untraced wall time ``enc_s`` / ``dec_s``."""
    enc = codec.compress(x)
    out = {}
    for side, fn, walls in (("compress", lambda: codec.compress(x), enc_s),
                            ("decompress", lambda: codec.decompress(enc["strings"], enc["shape"]),
                             dec_s)):
        busy = device_busy_ms(fn)
        out[side] = dict(device_busy_ms=busy,
                         device_idle_share=max(0.0, 1.0 - busy / (1e3 * float(np.median(walls)))))
    return out


def launch_counts(dtype: str):
    """-> (zero, read) for a run under ``dtype``'s policy: ``zero()`` sets
    every launch count to 0; ``read()`` gives each kernel's launches since
    then, window attention's and GDN's those of their ``dtype`` build, and
    raises if either launched its build of another dtype."""
    import torch

    from icm_tpu_torch.coding import device_rans as tdr
    from icm_tpu_torch.graphs import by_dtype
    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import window_attention as twa

    counters = {"window_attention": twa.LAUNCHES, "gdn_forward": tgdn.FWD_LAUNCHES,
                "gdn_backward": tgdn.BWD_LAUNCHES}
    want = getattr(torch, dtype)

    def zero():
        for counter in counters.values():
            counter.clear()
        tdr.ENCODE_LAUNCHES = tdr.DECODE_LAUNCHES = 0

    def read() -> dict:
        totals = {name: by_dtype(counter) for name, counter in counters.items()}
        other = {f"{name} {dt}": n for name, counter in totals.items()
                 for dt, n in counter.items() if dt != want}
        if other:
            raise AssertionError(f"a {dtype} run launched other builds: {other}")
        return {**{name: counter[want] for name, counter in totals.items()},
                "rans_encode": tdr.ENCODE_LAUNCHES, "rans_decode": tdr.DECODE_LAUNCHES}

    return zero, read


def check_launches(what: str, counts: dict, expect: dict) -> None:
    """``expect``: kernel -> its exact count, or ``(least, None)``."""
    for name, want in expect.items():
        got = counts[name]
        if not (got >= want[0] if isinstance(want, tuple) else got == want):
            raise AssertionError(f"{what}: launches {counts}, expected {expect}")


def host_wire_phase(codec, x, card: str, zero_counts, read_counts, expect: dict,
                    reps: int = 3):
    """Phases 5 and 11: compress -> decompress on the host wire, the
    launch counts zeroed right before and read right after each side and
    held to ``expect[side]``; img/s the median of ``reps`` calls. ->
    (results, the encoder's output, the compress and decompress
    counts)."""
    import torch

    B, size = x.shape[0], x.shape[1]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    enc = codec.compress(x, return_debug=True)
    torch.cuda.synchronize()
    enc_launches = read_counts()
    zero_counts()
    dec = codec.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    dec_launches = read_counts()
    log(f"  launches: compress {enc_launches}, decompress {dec_launches}")

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
    check_launches("host wire, compress", enc_launches, expect["compress"])
    check_launches("host wire, decompress", dec_launches, expect["decompress"])
    mse = torch.mean((dec["x_hat"] - x) ** 2, dim=(1, 2, 3))
    psnr = (10 * torch.log10(1.0 / mse)).tolist()

    enc_s, dec_s = [], []
    for _ in range(reps):
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
    result = dict(
        images=B, size=size, bpp=bpp, psnr_db=psnr,
        encode_img_per_s=B / float(np.median(enc_s)),
        decode_img_per_s=B / float(np.median(dec_s)),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_compress=enc_launches, launches_decompress=dec_launches,
        device=idle_shares(codec, x, enc_s, dec_s),
    )
    log(f"  bpp {[round(b, 4) for b in bpp]}, PSNR {[round(p, 2) for p in psnr]} dB, "
        f"encode {result['encode_img_per_s']:.2f} img/s, decode "
        f"{result['decode_img_per_s']:.2f} img/s (median of {reps}, batch {B}, {card}); device "
        f"{result['device']}")
    return result, enc, enc_launches, dec_launches


def y_slice_hw(model, size: int):
    """A latent slice's (h, w) at ``size`` px: y is size / 16 a side, cut
    into spatial_number x spatial_number zigzag blocks in the family."""
    h = size // 16 // getattr(model, "spatial_number", 1)
    return h, h


def device_wire_phase(codec, host_enc, x, card: str, zero_counts, read_counts,
                      expect: dict, reps: int = 3):
    """Phases 7 and 13: compress -> decompress on the device wire, the
    launch counts held to ``expect[side]``, img/s the median of ``reps``
    calls; -> results."""
    import warnings

    import torch

    B, size = x.shape[0], x.shape[1]
    zero_counts()
    enc = codec.compress(x, return_debug=True)
    torch.cuda.synchronize()
    enc_launches = read_counts()
    zero_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dec = codec.decompress(enc["strings"], enc["shape"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught
             if "synchroniz" in str(c.message)]
    torch.cuda.synchronize()
    dec_launches = read_counts()
    blob_sha256 = {name: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
                   for k, name in enumerate("yz")}
    log(f"  launches: compress {enc_launches}, decompress {dec_launches}; host round "
        f"trips in decompress: {len(syncs)}; blobs' sha256 {blob_sha256}")
    if syncs:
        raise AssertionError(f"decompress waited for the card: {syncs[:3]}")
    if not torch.equal(dec["y_hat"], enc["y_hat"]) or not torch.equal(dec["x_hat"], enc["x_hat"]):
        raise AssertionError("device wire: decoder's y_hat or x_hat differs from the encoder's")
    if not torch.equal(enc["y_hat"], host_enc["y_hat"]):
        raise AssertionError("device wire: y_hat differs from the host wire's")
    if dec["x_hat"].shape != x.shape or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"bad x_hat {tuple(dec['x_hat'].shape)}")
    check_launches("device wire, compress", enc_launches, expect["compress"])
    check_launches("device wire, decompress", dec_launches, expect["decompress"])
    # rate: the host wire's bytes x 1.02, plus per image and stream each
    # lane's 4-byte flush and 2-byte length and the header; y's lanes are a
    # slice's (a zigzag block's, for the family)
    lanes = {"y": codec.kit.n_lanes(*y_slice_hw(codec.model, size)),
             "z": (size // 64) ** 2 * codec.kit.z_groups(codec.kit.eb_dev["entropy_bottleneck"].num_rows)}
    stream_bytes = {}
    for k, name in enumerate("yz"):
        dev_b = sum(len(s) for s in enc["strings"][k])
        host_b = sum(len(s) for s in host_enc["strings"][k])
        limit = host_b * 1.02 + B * (lanes[name] * 8 + 16)
        stream_bytes[name] = dict(device=dev_b, host=host_b, limit=limit)
        if dev_b > limit:
            raise AssertionError(f"device wire {name}: {dev_b} bytes over {limit}")
    n_bytes = [len(y) + len(z) for y, z in zip(*enc["strings"])]
    bpp = [8 * n / (size * size) for n in n_bytes]
    mse = torch.mean((dec["x_hat"] - x) ** 2, dim=(1, 2, 3))
    psnr = (10 * torch.log10(1.0 / mse)).tolist()
    enc_s, dec_s = [], []
    for _ in range(reps):
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
            raise AssertionError("repeated device-wire decode differs from the first")
    result = dict(
        images=B, size=size, lanes_per_image=codec.kit.lanes_per_image, bpp=bpp, psnr_db=psnr,
        stream_bytes=stream_bytes, encode_img_per_s=B / float(np.median(enc_s)),
        decode_img_per_s=B / float(np.median(dec_s)), host_round_trips_in_decompress=0,
        launches_compress=enc_launches, launches_decompress=dec_launches,
        blob_sha256=blob_sha256, device=idle_shares(codec, x, enc_s, dec_s))
    log(f"  bytes {stream_bytes}; bpp {[round(b, 4) for b in bpp]}, PSNR "
        f"{[round(p, 2) for p in psnr]} dB, encode {result['encode_img_per_s']:.2f} img/s, "
        f"decode {result['decode_img_per_s']:.2f} img/s (median of {reps}, batch {B}, {card}); "
        f"device {result['device']}")
    return result, enc_launches, dec_launches


def traced_kernels(fn, last: int = 0):
    """The names of the kernels one traced call of ``fn`` ran, counted;
    with ``last``, also the names of its last ``last`` kernels in time
    order."""
    kernels = sorted((e["ts"], e["name"]) for e in trace_events(fn) if e.get("cat") == "kernel")
    names: dict = {}
    for _, name in kernels:
        names[name] = names.get(name, 0) + 1
    return (names, [n[:60] for _, n in kernels[-last:]]) if last else names


def wire_times(codec, x, reps: int = 3):
    """Host seconds of ``reps`` compress and decompress calls, each ending
    in a synchronize."""
    import torch

    enc_s, dec_s = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        e = codec.compress(x)
        torch.cuda.synchronize()
        enc_s.append(time.time() - t)
        t = time.time()
        codec.decompress(e["strings"], e["shape"])
        torch.cuda.synchronize()
        dec_s.append(time.time() - t)
    return enc_s, dec_s


def graph_replays(codec, n_slices: int) -> dict:
    """The scan wire's graphs of ``codec`` (captured): the chain's decode
    graph holds one decode launch a slice (z's outside), its encode graph
    none of the encode kernel (it runs after the graph); each graph's
    counted launches a replay equal the port's kernels a traced replay ran
    (up to TRACE_TRIES traces: the trace has dropped a record). -> per
    graph: counted, traced, kernels and the host's ms to launch a replay."""
    import torch

    # the chain's graphs: one decode launch a slice inside the decode graph
    # (z's outside), the encode launch after the encode graph
    for key, g in codec.graphs.graphs().items():
        if key[0] == "scan":
            inside = {c: sum(g.launches[c].values()) for c in ("DECODE_LAUNCHES", "ENCODE_LAUNCHES")}
            want = {"DECODE_LAUNCHES": n_slices if key[1] == "decode" else 0,
                    "ENCODE_LAUNCHES": 0}
            if inside != want:
                raise AssertionError(f"graph {key}: rANS launches {inside}, expected {want}")

    # each graph's launches a replay, against the kernels a traced replay ran
    per_replay = {}
    for key, g in codec.graphs.graphs().items():
        host_ms = []
        for _ in range(3):  # the host's time to launch one replay
            torch.cuda.synchronize()
            t = time.perf_counter()
            g(g.static_in)
            host_ms.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        counted = {c: sum(g.launches[c].values()) for c in TRACE_KERNELS}
        name = " ".join(str(p) for p in key)
        # the trace has dropped a kernel record now and then (one of a front
        # replay's three GDN kernels, on the card): up to three traced
        # replays, and a kernel traced more often than counted fails at once
        shortfalls = []
        for _ in range(TRACE_TRIES):
            names = traced_kernels(lambda: g(g.static_in))
            traced = {c: sum(n for k, n in names.items() if kernel in k)
                      for c, kernel in TRACE_KERNELS.items()}
            if any(traced[c] > counted[c] for c in counted):
                raise AssertionError(f"graph {name}: counted {counted}, the trace shows {traced}")
            if traced == counted:
                break
            shortfalls.append(traced)
        per_replay[name] = dict(counted=counted, traced=traced, kernels=sum(names.values()),
                                traces_short=shortfalls, launch_host_ms=float(np.median(host_ms)))
        if counted != traced:
            # what the trace saw, against a traced run of the same function
            # launch by launch, and the last kernels of each in time order
            names, tail = traced_kernels(lambda: g(g.static_in), last=30)
            plain_names, plain_tail = traced_kernels(lambda: g.fn(*g.static_in), last=30)
            log(f"  graph {name}: kernels of a traced replay {names}, the last {tail}; launch "
                f"by launch {plain_names}, the last {plain_tail}")
            raise AssertionError(f"graph {name}: counted {counted}, {TRACE_TRIES} traces "
                                 f"show {shortfalls}")
    short = {k: v["traces_short"] for k, v in per_replay.items() if v["traces_short"]}
    if short:
        log(f"  traces short of the counted launches before one matched: {short}")
    log(f"  launches a replay, counted = traced: "
        f"{ {k: {c: n for c, n in v['counted'].items() if n} for k, v in per_replay.items()} }; "
        f"kernels a replay: { {k: v['kernels'] for k, v in per_replay.items()} }; host ms to "
        f"launch a replay: { {k: round(v['launch_host_ms'], 3) for k, v in per_replay.items()} }")
    return per_replay


def scan_wire_phase(model, dev_codec, x, card: str, zero_counts, read_counts, expect: dict,
                    dev_counts: dict, reps: int = 3):
    """Phases 7a and 13a: compress -> decompress on the scan wire, its four
    programs replayed as CUDA graphs (captured by a first compress and
    decompress, whose time, capture seconds and pool bytes are logged).
    Then, counts zeroed right before and read right after each side: y_hat
    and x_hat bit-exact, the launches held to ``expect[side]`` and equal
    to the device wire's (``dev_counts``), no host round trip in
    decompress; each graph's launches a replay against the kernels the
    profiler sees in one replay; the blobs, y_hat and x_hat the same bits
    as the same functions launch by launch (``cuda_graphs=False``); y_hat
    and the y bytes against the device wire's (``SCAN_VS_DEVICE``); encode
    and decode img/s graphed, launch by launch and on the device wire, and
    each side's device idle share. -> (results, compress and decompress
    counts)."""
    import warnings

    import torch

    from icm_tpu_torch.models import DeviceWireCodec

    B, size = x.shape[0], x.shape[1]
    codec = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2, scan_wire=True)
    plain = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2, scan_wire=True,
                            cuda_graphs=False)
    t = time.time()
    first = codec.compress(x, return_debug=True)
    codec.decompress(first["strings"], first["shape"])
    torch.cuda.synchronize()
    first_s = time.time() - t
    stats = codec.graphs.stats()
    graphs = {" ".join(str(p) for p in key): st for key, st in stats.items()}
    capture_s = sum(st["capture_s"] for st in stats.values())
    pool_bytes = sum(st["pool_bytes"] for st in stats.values())
    log(f"  first compress + decompress {first_s:.2f}s, captures {capture_s:.2f}s of it, "
        f"pools {pool_bytes / 2**20:.1f} MiB; per graph: {graphs}")

    zero_counts()
    enc = codec.compress(x, return_debug=True)
    torch.cuda.synchronize()
    enc_launches = read_counts()
    zero_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dec = codec.decompress(enc["strings"], enc["shape"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught if "synchroniz" in str(c.message)]
    torch.cuda.synchronize()
    dec_launches = read_counts()
    tiers = sorted({blob[4] for blob in enc["strings"][0]})
    log(f"  launches: compress {enc_launches}, decompress {dec_launches}; host round trips "
        f"in decompress: {len(syncs)}; tier {tiers}")
    if syncs:
        raise AssertionError(f"scan wire: decompress waited for the card: {syncs[:3]}")
    if not torch.equal(dec["y_hat"], enc["y_hat"]) or not torch.equal(dec["x_hat"], enc["x_hat"]):
        raise AssertionError("scan wire: decoder's y_hat or x_hat differs from the encoder's")
    if dec["x_hat"].shape != x.shape or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"bad x_hat {tuple(dec['x_hat'].shape)}")
    check_launches("scan wire, compress", enc_launches, expect["compress"])
    check_launches("scan wire, decompress", dec_launches, expect["decompress"])
    if enc_launches != dev_counts["compress"] or dec_launches != dev_counts["decompress"]:
        raise AssertionError(f"scan wire launches {enc_launches} / {dec_launches} differ from "
                             f"the device wire's {dev_counts}")

    per_replay = graph_replays(codec, model.ctx_slices)

    # graphs against the same functions launch by launch
    penc = plain.compress(x, return_debug=True)
    pdec = plain.decompress(enc["strings"], enc["shape"])
    if penc["strings"] != enc["strings"]:
        raise AssertionError("scan wire: graphed blobs differ from launch by launch")
    for k in ("y_hat", "x_hat", "z_hat"):
        if not torch.equal(penc[k], enc[k]):
            raise AssertionError(f"scan wire: graphed compress {k} differs from launch by launch")
    for k in ("y_hat", "x_hat"):
        if not torch.equal(pdec[k], dec[k]):
            raise AssertionError(f"scan wire: graphed decompress {k} differs from launch by launch")

    # against the device wire: y_hat's distribution and the bytes
    denc = dev_codec.compress(x, return_debug=True)
    d = (enc["y_hat"] - denc["y_hat"]).abs()
    vs_device = {"share_above_1e-2": float((d > 1e-2).float().mean()),
                 "median": float(d.median()), "max": float(d.max())}
    stream_bytes = {}
    for k, name in enumerate("yz"):
        scan_b = sum(len(b) for b in enc["strings"][k])
        dev_b = sum(len(b) for b in denc["strings"][k])
        limit = (dev_b * (1 + SCAN_VS_DEVICE["share_above_1e-2"]) + B if name == "y" else dev_b)
        stream_bytes[name] = dict(scan=scan_b, device=dev_b, limit=limit)
        if scan_b > limit:
            raise AssertionError(f"scan wire {name}: {scan_b} bytes over {limit}")
    log(f"  y_hat against the device wire's: {vs_device} (bars {SCAN_VS_DEVICE}); "
        f"bytes {stream_bytes}")
    if not (vs_device["share_above_1e-2"] < SCAN_VS_DEVICE["share_above_1e-2"]
            and vs_device["median"] < SCAN_VS_DEVICE["median"]):
        raise AssertionError(f"scan wire y_hat strays from the device wire's: {vs_device}")

    # img/s and device idle: graphed, launch by launch, the device wire
    times = {}
    for wire, c in (("graphed", codec), ("launches", plain), ("device_wire", dev_codec)):
        enc_s, dec_s = wire_times(c, x, reps)
        times[wire] = dict(encode_img_per_s=B / float(np.median(enc_s)),
                           decode_img_per_s=B / float(np.median(dec_s)),
                           device=idle_shares(c, x, enc_s, dec_s))
    log("  encode / decode img/s (median of {}, batch {}, {}): {}; device idle {}".format(
        reps, B, card, {w: f"{t['encode_img_per_s']:.2f} / {t['decode_img_per_s']:.2f}"
                  for w, t in times.items()},
        {w: f"{t['device']['compress']['device_idle_share']:.3f} / "
            f"{t['device']['decompress']['device_idle_share']:.3f}" for w, t in times.items()}))
    bpp = [8 * (len(y) + len(z)) / (size * size) for y, z in zip(*enc["strings"])]
    result = dict(
        images=B, size=size, lanes_per_image=1024, bpp=bpp, tier=tiers,
        stream_bytes=stream_bytes, y_hat_vs_device_wire=vs_device,
        first_call_s=first_s, capture_s=capture_s, pool_bytes=pool_bytes, graphs=graphs,
        launches_per_replay=per_replay, host_round_trips_in_decompress=0,
        launches_compress=enc_launches, launches_decompress=dec_launches,
        blob_sha256={name: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
                     for k, name in enumerate("yz")},
        **times["graphed"], launch_by_launch=times["launches"], device_wire=times["device_wire"])
    del codec, plain
    torch.cuda.empty_cache()
    return result, enc_launches, dec_launches


def bf16_serving_phase(codec, dev_codec, x, card, f32: dict, reps: int = 3):
    """Phases 7b and 17: compress -> decompress under the bfloat16 policy on
    the host wire and the device wire, held as the float32 phases are and
    to their launch counts, every launch the bfloat16 build's (``f32``: the
    float32 phases' results, encoder output and counts), then to
    tests/test_bf16.py's bars against them. -> (results, the launch counts
    of each side)."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    counts = f32["counts"]
    zero_counts, read_counts = launch_counts("bfloat16")
    set_activation_dtype(torch.bfloat16)  # read at forward time; both sides
    try:
        result, enc, enc_l, dec_l = host_wire_phase(
            codec, x, card, zero_counts, read_counts,
            {"compress": counts["compress"], "decompress": counts["decompress"]}, reps)
        result["device_wire"], dev_enc_l, dev_dec_l = device_wire_phase(
            dev_codec, enc, x, card, zero_counts, read_counts,
            {"compress": counts["device_compress"], "decompress": counts["device_decompress"]},
            reps)
    finally:
        set_activation_dtype(None)
    bpp_rel = [b16 / b32 - 1 for r16, r32 in ((result, f32["result"]),
                                                (result["device_wire"], f32["result"]["device_wire"]))
               for b16, b32 in zip(r16["bpp"], r32["bpp"])]
    x_hat_mean = (enc["x_hat"].float() - f32["enc"]["x_hat"].float()).abs().mean().item()
    result["against_f32"] = dict(bpp_rel=bpp_rel, x_hat_mean_abs=x_hat_mean,
                                 bpp_rtol=BF16_BPP_RTOL, x_hat_mean_tol=BF16_XHAT_MEAN_TOL)
    log(f"  bf16 against f32: bpp {[f'{r:+.2e}' for r in bpp_rel]} (bar {BF16_BPP_RTOL}), mean "
        f"|x_hat - x_hat_f32| {x_hat_mean:.3e} (bar {BF16_XHAT_MEAN_TOL}); encode / decode img/s "
        f"host wire {result['encode_img_per_s']:.2f} / {result['decode_img_per_s']:.2f} "
        f"(f32 {f32['result']['encode_img_per_s']:.2f} / {f32['result']['decode_img_per_s']:.2f}), "
        f"device wire {result['device_wire']['encode_img_per_s']:.2f} / "
        f"{result['device_wire']['decode_img_per_s']:.2f} (f32 "
        f"{f32['result']['device_wire']['encode_img_per_s']:.2f} / "
        f"{f32['result']['device_wire']['decode_img_per_s']:.2f}) ({card})")
    if max(abs(r) for r in bpp_rel) > BF16_BPP_RTOL or not x_hat_mean < BF16_XHAT_MEAN_TOL:
        raise AssertionError(f"bf16 serving strays from f32: {result['against_f32']}")
    return result, {"compress": enc_l, "decompress": dec_l, "device_compress": dev_enc_l,
                    "device_decompress": dev_dec_l}


def instrumented(make_step, records, dtype: str):
    """``make_step`` whose steps are timed (host clock around a step that
    ends in ``torch.cuda.synchronize()``) and whose kernel launches are
    counted (``launch_counts(dtype)``): every count is set to 0 just before
    the step and read just after it. One record per step, with its
    metrics."""
    import torch

    zero_counts, read_counts = launch_counts(dtype)

    def make(model, criterion):
        inner = make_step(model, criterion)

        def step(state, batch, generator):
            torch.cuda.synchronize()
            zero_counts()
            t = time.time()
            metrics = inner(state, batch, generator)
            torch.cuda.synchronize()
            seconds = time.time() - t
            records.append(dict(
                seconds=seconds, step=state.step, launches=read_counts(),
                shapes=shape_counts(),
                **{k: float(v) for k, v in metrics.items()}))
            return metrics

        return step

    return make


# launches of each kernel in one training step of WACNN: 3 GDN + 3 IGDN
# forward and backward; the 4 window blocks forward (their backward is
# autograd of the plain version, as in the JAX package); no coding
TRAIN_STEP_LAUNCHES = {"window_attention": 4, "gdn_forward": 6, "gdn_backward": 6,
                       "rans_encode": 0, "rans_decode": 0}


def train_phase(model, seed: int, card: str, expect: dict, steps: int = 6,
                resumed_steps: int = 2, dtype: str = "float32", criterion=None,
                fixed: tuple = ()):
    """Phases 9 and 15: ``run_training`` on the card, each step's launches
    exactly ``expect`` (in ``dtype``'s builds), then (``resumed_steps`` > 0)
    a resume from the checkpoint. ``criterion``: RateDistortionLoss(0.01)
    by default; ``fixed``: prefixes of the parameters no loss term reaches,
    which must not move (every other one must). -> results."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.train import RateDistortionLoss, make_train_step, run_training

    B, size = 8, 256
    batches = [make_images(seed + 100 + i, B, size) for i in range(steps + resumed_steps)]
    eval_batch = make_images(seed + 99, B, size)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    records = []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best.pt")
        common = dict(
            model=model, criterion=criterion or RateDistortionLoss(0.01),
            make_step=instrumented(make_train_step, records, dtype),
            eval_batches=lambda: iter([eval_batch]), learning_rate=1e-4,
            aux_learning_rate=1e-3, clip_max_norm=1.0, seed=seed, save_path=ckpt,
            log_every=steps)
        state, history = run_training(
            train_batches=lambda epoch: iter(batches[:steps]), epochs=1, **common)
        torch.cuda.synchronize()
        if not os.path.exists(ckpt) or state.step != steps:
            raise AssertionError(f"no checkpoint after epoch 0 (step {state.step})")
        moved = {n for n, p in model.named_parameters() if not torch.equal(before[n], p)}
        history2 = []
        if resumed_steps:
            resumed, history2 = run_training(
                train_batches=lambda epoch: iter(batches[steps:]), epochs=2,
                checkpoint=ckpt, **common)
            torch.cuda.synchronize()
            if resumed.step != steps + resumed_steps:
                raise AssertionError(f"resume: at step {resumed.step}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(records) != steps + resumed_steps:
        raise AssertionError(f"{len(records)} steps run, not {steps + resumed_steps}")
    if moved != {n for n in before if not n.startswith(fixed or ("\0",))}:
        raise AssertionError(f"{len(before) - len(moved)} of {len(before)} parameters did not "
                             f"move, {len([n for n in moved if n.startswith(fixed)])} fixed moved")
    for r in records:
        if not all(np.isfinite(r[k]) for k in ("loss", "bpp_loss", "mse_loss", "aux_loss")):
            raise AssertionError(f"non-finite training metrics: {r}")
        if r["launches"] != expect:
            raise AssertionError(f"step {r['step']}: launches {r['launches']}, "
                                 f"expected {expect}")
    if not all(np.isfinite(history + history2)):
        raise AssertionError(f"eval losses {history} {history2}")
    timed = [r["seconds"] for r in records[1:steps]]  # after the first (warm-up) step
    result = dict(
        batch=B, size=size, steps=steps, resumed_steps=resumed_steps,
        train_img_per_s=B / float(np.median(timed)),
        step_seconds=[r["seconds"] for r in records],
        loss=[r["loss"] for r in records], bpp=[r["bpp_loss"] for r in records],
        aux_loss=[r["aux_loss"] for r in records], eval_loss=history + history2,
        peak_mem_gb=peak_gb, launches_per_step=records[-1]["launches"],
        launches_by_shape_per_step=records[-1]["shapes"])
    for r in records:
        log(f"  step {r['step']}: {r['seconds'] * 1e3:.1f} ms loss {r['loss']:.4f} "
            f"bpp {r['bpp_loss']:.4f} aux {r['aux_loss']:.2f} launches {r['launches']}")
    log(f"  train {result['train_img_per_s']:.2f} img/s (median of {len(timed)} steps "
        f"after warm-up, batch {B} x {size}^2), peak {peak_gb:.2f} GB, eval losses "
        f"{history + history2}{f', resumed at step {steps}' if resumed_steps else ''} ({card})")
    return result


def bf16_train_phase(model, init_state: dict, seed: int, card: str, expect: dict,
                     f32_train: dict, steps: int = 3):
    """Phases 10b and 17: ``train_phase`` under the bfloat16 policy from the
    weights ``init_state`` the float32 phase started from, on its batches
    and noise: each step's launches exactly ``expect``, all of them the
    bfloat16 builds'; the gradients
    float32 on the float32 masters; the first step's bpp within
    BF16_BPP_RTOL of the float32 phase's first. -> results."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    model.load_state_dict(init_state)
    set_activation_dtype(torch.bfloat16)
    try:
        result = train_phase(model, seed, card, expect, steps=steps, resumed_steps=0,
                             dtype="bfloat16")
    finally:
        set_activation_dtype(None)
    grad_types = {p.grad.dtype for p in model.parameters() if p.grad is not None}
    param_types = {p.dtype for p in model.parameters()}
    bpp_rel = result["bpp"][0] / f32_train["bpp"][0] - 1
    result["against_f32"] = dict(first_step_bpp_rel=bpp_rel, bpp_rtol=BF16_BPP_RTOL,
                                 f32_train_img_per_s=f32_train["train_img_per_s"],
                                 grad_dtypes=sorted(map(str, grad_types)))
    log(f"  bf16 training: first step's bpp {result['bpp'][0]:.5f} against f32 "
        f"{f32_train['bpp'][0]:.5f} ({bpp_rel:+.2e}, bar {BF16_BPP_RTOL}); gradients "
        f"{sorted(map(str, grad_types))}; {result['train_img_per_s']:.2f} img/s (f32 "
        f"{f32_train['train_img_per_s']:.2f}), peak {result['peak_mem_gb']:.2f} GB (f32 "
        f"{f32_train['peak_mem_gb']:.2f}) ({card})")
    if grad_types != {torch.float32} or param_types != {torch.float32}:
        raise AssertionError(f"bf16 training: gradients {grad_types}, parameters {param_types}")
    if abs(bpp_rel) > BF16_BPP_RTOL:
        raise AssertionError(f"bf16 training: first step's bpp strays from f32 ({bpp_rel:+.3e})")
    return result


def cpu_twin(name: str, model, **overrides):
    """The registry's ``name`` (its config with ``overrides``) on the CPU
    with ``model``'s weights: built on the meta device and loaded, so that
    no weight is drawn (a full-width family model takes minutes to draw on
    the CPU)."""
    import torch

    from icm_tpu_torch.models import models

    cls, kwargs = models[name]
    with torch.device("meta"):
        cpu_model = cls(**{**kwargs, **overrides})
    cpu_model = cpu_model.to_empty(device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    return cpu_model


def train_vs_cpu_phase(name: str, model, seed: int, criterion=None, **overrides):
    """Phases 10, 16 and 25: one training step's loss terms and gradients,
    card vs CPU, same weights, same noise (one seeded CPU generator for
    each side: the noise is drawn on the generator's device), float32, no
    stochastic depth (its rates set to 0 on the card for the step);
    ``overrides``: the CPU model's config beyond the registry's (the
    forward the card model runs); ``criterion``: RateDistortionLoss(0.01)
    by default. A parameter no loss term reaches (the CRC family's split
    decoder) has no gradient on either side."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.nn.swin import DropPath
    from icm_tpu_torch.train import RateDistortionLoss

    criterion = criterion or RateDistortionLoss(0.01)
    swin = name not in ("cnn",) + CRC
    cpu_model = cpu_twin(name, model, **({"drop_path_rate": 0.0} if swin else {}), **overrides)
    xs = torch.from_numpy(make_images(seed + 2, 1, 64))
    drop_paths = [m for m in model.modules() if isinstance(m, DropPath)]
    rates = [m.rate for m in drop_paths]

    def step_grads(m, x):
        m.train()
        m.zero_grad(set_to_none=True)
        out = m(x, generator=torch.Generator().manual_seed(seed))
        rd = criterion(out, x)
        aux = m.aux_loss()
        (rd["loss"] + aux).backward()
        terms = {k: float(v.detach()) for k, v in {**rd, "aux_loss": aux}.items()}
        return terms, {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                       if p.grad is not None}

    for m in drop_paths:
        m.rate = 0.0
    try:
        got_terms, got = step_grads(model, xs.cuda())
    finally:
        for m, rate in zip(drop_paths, rates):
            m.rate = rate
    ref_terms, ref = step_grads(cpu_model, xs)
    model.zero_grad(set_to_none=True)
    worst = {k: abs(got_terms[k] - v) / max(abs(v), 1e-30) for k, v in ref_terms.items()}
    if set(got) != set(ref):
        raise AssertionError(f"gradients of {len(got)} parameters on the card, {len(ref)} on "
                             "the CPU")
    grad_err = {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item()
                for n in ref}
    worst_grad, err = max(grad_err.items(), key=lambda kv: kv[1])
    log(f"  {name}: loss terms card {got_terms} cpu {ref_terms}; relative errors {worst}")
    log(f"  largest gradient error relative to its max: {err:.3e} ({worst_grad}); "
        f"tolerance {TRAIN_TOLERANCE}")
    if max(worst.values()) > TRAIN_TOLERANCE or err > TRAIN_TOLERANCE:
        raise AssertionError("training step: card and CPU disagree")
    return dict(loss_terms_rel_err=worst, max_grad_rel_err=err, worst_grad=worst_grad,
                tolerance=TRAIN_TOLERANCE, parameters_with_gradients=len(ref))


def bf16_layer_replay(model, cpu_model, x) -> dict:
    """Under the bfloat16 policy: the card's eval forward of ``x`` with every
    policy layer, GDN and window attention recorded (its inputs and output),
    then each call replayed on the CPU twin's module of the same name from
    the same inputs, under the policy and, for the control, in float32.
    -> per module kind: calls, and the largest share of differing outputs
    and relative difference over its calls; and the control's smallest
    share over the calls with a nonzero output (with untrained weights z_hat
    is 0, and the hyper decoders' layers output exact zeros)."""
    import torch

    from icm_tpu_torch.nn import GDN, set_activation_dtype
    from icm_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Linear, WindowAttention

    kinds = (Conv2d, ConvTranspose2d, Linear, GDN, WindowAttention)
    calls = []

    def record(name, module, args, out):
        calls.append((name, type(module).__name__, [a.detach().cpu() for a in args],
                      out.detach().cpu()))

    hooks = [m.register_forward_hook(lambda mod, a, o, n=n: record(n, mod, a, o))
             for n, m in model.named_modules() if isinstance(m, kinds)]
    cpu_modules = dict(cpu_model.named_modules())
    out = {}
    try:
        with torch.no_grad():
            set_activation_dtype(torch.bfloat16)
            model(x.cuda())
            for name, kind, args, got in calls:
                ref = cpu_modules[name](*args)
                d = (got.float() - ref.float()).abs()
                set_activation_dtype(None)
                control = cpu_modules[name](*(a.float() if a.is_floating_point() else a
                                              for a in args))
                set_activation_dtype(torch.bfloat16)
                row = out.setdefault(kind, {"calls": 0, "zero_calls": 0, "share": 0.0,
                                            "relative": 0.0, "control_share": 1.0})
                row["calls"] += 1
                row["share"] = max(row["share"], (d > 0).float().mean().item())
                row["relative"] = max(row["relative"], (d.max() / ref.float().abs().max()
                                                        .clamp_min(1e-30)).item())
                if not control.any():
                    row["zero_calls"] += 1
                    continue
                row["control_share"] = min(row["control_share"],
                                           (got.float() != control.float()).float().mean().item())
                if got.dtype != ref.dtype:
                    raise AssertionError(f"{name}: card {got.dtype}, cpu {ref.dtype}")
    finally:
        set_activation_dtype(None)
        for h in hooks:
            h.remove()
    return out


def bf16_spread(got: dict, ref: dict) -> dict:
    """Two eval forwards' outputs -> BF16_EVAL_TOL's measures of their
    difference."""
    def diff(a, b):
        return (a.detach().float().cpu() - b.detach().float().cpu()).abs()

    return {"x_hat_mean": diff(got["x_hat"], ref["x_hat"]).mean().item(),
            "y_likelihood_share": (diff(got["likelihoods"]["y"], ref["likelihoods"]["y"])
                                   > 1e-3).float().mean().item(),
            "z_likelihood_max": diff(got["likelihoods"]["z"], ref["likelihoods"]["z"]).max().item()}


def eval_vs_cpu_phase(name: str, model, seed: int):
    """Phases 8 and 14: the same weights' eval forward on the card against
    the plain CPU path on a small input, in float32, then under the
    bfloat16 policy on both sides end to end (BF16_EVAL_TOL; beside it the
    card's bfloat16 against the CPU's float32) and layer by layer
    (BF16_LAYER_TOL, with its control). -> the differences."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.nn import set_activation_dtype

    xs = torch.from_numpy(make_images(seed + 1, 1, 64))
    cpu_model = create_model(name, device="cpu", seed=seed)
    cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = cpu_model(xs)
        got = model(xs.cuda())
        set_activation_dtype(torch.bfloat16)
        try:
            ref16 = cpu_model(xs)
            got16 = model(xs.cuda())
        finally:
            set_activation_dtype(None)
    worst = {}
    for key, a, b in (("x_hat", got["x_hat"], ref["x_hat"]),
                      ("y likelihoods", got["likelihoods"]["y"], ref["likelihoods"]["y"]),
                      ("z likelihoods", got["likelihoods"]["z"], ref["likelihoods"]["z"])):
        worst[key] = (a.cpu() - b).abs().max().item()
    log(f"  max |card - cpu| ({name}): {worst}")
    # f32 on both, through 70-80 layers with sums in other orders
    if not worst["x_hat"] <= 1e-3 or not worst["y likelihoods"] <= 1e-3:
        raise AssertionError(f"card and CPU disagree: {worst}")
    bf16, against_f32 = bf16_spread(got16, ref16), bf16_spread(got16, ref)
    log(f"  bf16 on both ({name}): {bf16}; bf16 card against f32 cpu: {against_f32}; "
        f"bars {BF16_EVAL_TOL}")
    if got16["x_hat"].dtype != ref16["x_hat"].dtype or any(
            bf16[k] > tol for k, tol in BF16_EVAL_TOL.items()):
        raise AssertionError(f"card and CPU disagree under the bf16 policy: {bf16}")
    layers = bf16_layer_replay(model, cpu_model, xs)
    log(f"  bf16 layer by layer ({name}): {layers}; bars {BF16_LAYER_TOL}")
    for kind, row in layers.items():
        if row["share"] > BF16_LAYER_TOL["share"] or row["relative"] > BF16_LAYER_TOL["relative"]:
            raise AssertionError(f"{kind}: card and CPU disagree under the bf16 policy: {row}")
        if not row["control_share"] > BF16_LAYER_TOL["share"]:
            raise AssertionError(f"{kind}: the bar cannot tell bf16 from f32: {row}")
    return {"f32_max_abs": worst, "bf16": bf16, "bf16_card_against_f32_cpu": against_f32,
            "bf16_tolerance": BF16_EVAL_TOL, "bf16_layers": layers,
            "bf16_layer_tolerance": BF16_LAYER_TOL}


class _RefDraw:
    """A reference state dict drawn from ``rng`` at a trained model's scale:
    fan-in scaled kernels, small biases, GDN near its init, ordered
    bottleneck quantiles; ``dtype``: the draws' (float64 draws are rounded
    to float32)."""

    def __init__(self, rng, dtype=np.float64):
        self.rng, self.dtype, self.sd = rng, dtype, {}

    def normal(self, shape):
        return self.rng.standard_normal(shape, dtype=self.dtype)

    def put(self, name, shape, scale, shift=0.0):
        self.sd[name] = (shift + scale * self.normal(shape)).astype(np.float32)

    def conv(self, name, o, i, k, transposed=False):
        self.put(f"{name}.weight", (i, o, k, k) if transposed else (o, i, k, k),
                 (i * k * k) ** -0.5)
        self.put(f"{name}.bias", (o,), 0.01)

    def gdn(self, name, c):
        self.sd[f"{name}.beta"] = (1.0 + 0.05 * np.abs(self.normal(c))).astype(np.float32)
        self.sd[f"{name}.gamma"] = np.sqrt(0.1 * np.eye(c) + 0.005 * np.abs(
            self.normal((c, c)))).astype(np.float32)

    def win(self, prefix, dim, ws):
        for unit in [f"{prefix}.conv_a.{i}" for i in range(3)] + [
                f"{prefix}.conv_b.{i}" for i in (1, 2, 3)]:
            self.conv(f"{unit}.conv.0", dim // 2, dim, 1)
            self.conv(f"{unit}.conv.2", dim // 2, dim // 2, 3)
            self.conv(f"{unit}.conv.4", dim, dim // 2, 1)
        a = f"{prefix}.conv_b.0.attn"
        for name, o in (("qkv", 3 * dim), ("proj", dim)):
            self.put(f"{a}.{name}.weight", (o, dim), dim ** -0.5)
            self.put(f"{a}.{name}.bias", (o,), 0.01)
        self.put(f"{a}.relative_position_bias_table", ((2 * ws - 1) ** 2, 8), 0.02)
        self.conv(f"{prefix}.conv_b.4", dim, dim, 1)

    def hyper_dec(self, tag, z, dec, extra=0):
        self.conv(f"{tag}.0", dec[0], z, 3)
        self.conv(f"{tag}.2.0", dec[1] * 4, dec[0], 3)
        self.conv(f"{tag}.4", dec[2], dec[1], 3)
        self.conv(f"{tag}.6.0", dec[3] * 4, dec[2], 3)
        self.conv(f"{tag}.8", dec[4], dec[3], 3)
        for j in range(extra):
            self.conv(f"{tag}.{10 + 2 * j}", dec[4], dec[4], 3)

    def bottleneck(self, prefix, C, legacy=False):
        """(legacy: the ParameterList keys ``_matrices.{i}`` ...)"""
        fdims = (1, 3, 3, 3, 3, 1)
        q = np.array([-8.0, 0.0, 8.0]) + 0.2 * self.normal((C, 1, 3))
        self.sd[f"{prefix}.quantiles"] = np.sort(q, axis=-1).astype(np.float32)
        for i in range(5):
            names = ((f"_matrices.{i}", f"_biases.{i}", f"_factors.{i}") if legacy
                     else (f"_matrix{i}", f"_bias{i}", f"_factor{i}"))
            self.put(f"{prefix}.{names[0]}", (C, fdims[i + 1], fdims[i]), 0.5)
            self.put(f"{prefix}.{names[1]}", (C, fdims[i + 1], 1), 0.5)
            if i < 4:
                self.put(f"{prefix}.{names[2]}", (C, fdims[i + 1], 1), 0.5)


def reference_wacnn_state_dict(seed: int) -> dict:
    """A reference CompressAI WACNN state dict at full width (N=192,
    M=320, 10 slices of support 5): the reference's module names
    (``g_a.4.conv_b.0.attn.qkv.weight`` ...) and shapes, the bottleneck's
    legacy ParameterList keys, DataParallel's ``module.`` prefix and a
    stray ``h_s`` entry, values drawn from ``seed`` at a trained model's
    scale (``_RefDraw``)."""
    import torch

    ref = _RefDraw(np.random.default_rng(seed))
    N, M, S, K = 192, 320, 10, 5
    enc, dec, cc = (320, 288, 256, 224, 192), (192, 224, 256, 288, 320), (224, 176, 128, 64)
    ref.conv("g_a.0", N, 3, 5)
    ref.gdn("g_a.1", N)
    ref.conv("g_a.2", N, N, 5)
    ref.gdn("g_a.3", N)
    ref.win("g_a.4", N, 8)
    ref.conv("g_a.5", N, N, 5)
    ref.gdn("g_a.6", N)
    ref.conv("g_a.7", M, N, 5)
    ref.win("g_a.8", M, 4)
    ref.win("g_s.0", M, 4)
    ref.conv("g_s.1", N, M, 5, transposed=True)
    ref.gdn("g_s.2", N)
    ref.conv("g_s.3", N, N, 5, transposed=True)
    ref.gdn("g_s.4", N)
    ref.win("g_s.5", N, 8)
    ref.conv("g_s.6", N, N, 5, transposed=True)
    ref.gdn("g_s.7", N)
    ref.conv("g_s.8", 3, N, 5, transposed=True)
    for i, (o, c) in enumerate(zip(enc, (M,) + enc[:-1])):
        ref.conv(f"h_a.{2 * i}", o, c, 3)
    for tag in ("h_mean_s", "h_scale_s"):
        ref.hyper_dec(tag, enc[-1], dec)
    sc = M // S
    for i in range(S):
        for tag, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0),
                           ("lrp_transforms", sc)):
            cin = [dec[-1] + sc * min(i, K) + extra] + list(cc)
            for j in range(4):
                ref.conv(f"{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            ref.conv(f"{tag}.{i}.8", sc, cc[-1], 3)
    ref.bottleneck("entropy_bottleneck", enc[-1], legacy=True)
    ref.sd["h_s.0.weight"] = np.zeros((3, 3), np.float32)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def reference_phase(x, card: str, zero_counts, read_counts, seed: int):
    """Phase 18: a reference checkpoint at full width. The seeded reference
    WACNN state dict is converted (``zoo.convert_reference_state_dict``)
    and loaded strictly; the converted model's own tables are written into
    the dict as the reference's CDF buffers and read back
    (``zoo.import_reference_tables``), equal; then 2 x 512^2 on the host
    wire with the imported tables in the reference symbol order, held as in
    phase 5 (launch counts zeroed and read around each side), its blobs
    equal to those of the built tables in that order. -> results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import CharmCodec, build_codec_tables, create_model

    t = time.time()
    sd = reference_wacnn_state_dict(seed)
    model = create_model("cnn", seed=seed)
    model.load_state_dict(zoo.convert_reference_state_dict("cnn", sd), strict=True)
    built = build_codec_tables(model)
    for prefix, tab in (("entropy_bottleneck", built.bottlenecks["entropy_bottleneck"]),
                        ("gaussian_conditional", built.gaussian)):
        for field in ("quantized_cdf", "offset", "cdf_length"):
            sd[f"module.{prefix}._{field}"] = torch.from_numpy(getattr(tab, field))
    sd["module.gaussian_conditional.scale_table"] = torch.from_numpy(built.scale_table)
    imported = zoo.import_reference_tables(sd)
    for name, got, want in (("gaussian", imported.gaussian, built.gaussian),
                            ("bottleneck", imported.bottlenecks["entropy_bottleneck"],
                             built.bottlenecks["entropy_bottleneck"])):
        for field in ("quantized_cdf", "offset", "cdf_length"):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"imported {name} {field} differs from the stored one")
    if not np.array_equal(imported.scale_table, built.scale_table):
        raise AssertionError("imported scale table differs from the stored one")
    log(f"  {len(sd)} reference tensors converted, loaded strictly and tables imported in "
        f"{time.time() - t:.1f}s")
    codec = CharmCodec(model, tables=imported, ref_layout=True, narrow=0.2)
    at_least_one = (1, None)
    on_path = {"window_attention": at_least_one, "gdn_forward": at_least_one,
               "rans_encode": 0, "rans_decode": 0}
    result, enc, enc_l, dec_l = host_wire_phase(codec, x, card, zero_counts, read_counts,
                                                {"compress": on_path, "decompress": on_path})
    built_enc = CharmCodec(model, ref_layout=True, narrow=0.2).compress(x)
    if built_enc["strings"] != enc["strings"]:
        raise AssertionError("imported tables' blobs differ from the built tables' ones")
    result.update(tensors=len(sd), blob_sha256={
        name: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
        for k, name in enumerate("yz")})
    log(f"  blobs with imported tables = built tables (reference order); sha256 "
        f"{result['blob_sha256']}")
    del model, codec
    torch.cuda.empty_cache()
    return result, {"launches_reference_compress": enc_l, "launches_reference_decompress": dec_l}


def family_eval_vs_cpu(name: str, model, seed: int, bf16: bool = False) -> dict:
    """A family model's eval forward on the card against the plain CPU path
    with the same weights, one 256 x 256 image: x_hat and the y
    likelihoods within 1e-3 (f32, sums in other orders through ~100
    layers). With ``bf16``, then one 64 x 64 image under the bfloat16
    policy on both sides, end to end (BF16_EVAL_TOL, phase 14's bars; the
    card's bfloat16 against the CPU's float32 beside it)."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.nn import set_activation_dtype

    cpu_model = cpu_twin(name, model)
    xs = torch.from_numpy(make_images(seed + 1, 1, 256))
    with torch.no_grad():
        ref = cpu_model(xs)
        got = model(xs.cuda())
    worst = {key: (got[a][b] if b else got[a]).cpu().sub(ref[a][b] if b else ref[a]).abs()
             .max().item() for key, a, b in (("x_hat", "x_hat", None),
                                             ("y likelihoods", "likelihoods", "y"),
                                             ("z likelihoods", "likelihoods", "z"))}
    log(f"  max |card - cpu| ({name}, 256 x 256): {worst}")
    if not worst["x_hat"] <= 1e-3 or not worst["y likelihoods"] <= 1e-3:
        raise AssertionError(f"card and CPU disagree: {worst}")
    out = {"size": 256, "f32_max_abs": worst, "tolerance": 1e-3}
    if bf16:
        xs = torch.from_numpy(make_images(seed + 1, 1, 64))
        with torch.no_grad():
            ref = cpu_model(xs)
            set_activation_dtype(torch.bfloat16)
            try:
                ref16 = cpu_model(xs)
                got16 = model(xs.cuda())
            finally:
                set_activation_dtype(None)
        spread, against_f32 = bf16_spread(got16, ref16), bf16_spread(got16, ref)
        log(f"  bf16 on both ({name}, 64 x 64): {spread}; bf16 card against f32 cpu: "
            f"{against_f32}; bars {BF16_EVAL_TOL}")
        if got16["x_hat"].dtype != ref16["x_hat"].dtype or any(
                spread[k] > tol for k, tol in BF16_EVAL_TOL.items()):
            raise AssertionError(f"card and CPU disagree under the bf16 policy: {spread}")
        out.update(bf16_size=64, bf16=spread, bf16_card_against_f32_cpu=against_f32,
                   bf16_tolerance=BF16_EVAL_TOL)
    return out


def family_phase(name: str, x, card: str, zero_counts, read_counts, seed: int,
                 rans_rows: list):
    """Phases 19-22: a zigzag family model at its published full width,
    weights from ``seed``, on the images of phase 5: compress ->
    decompress on the host wire, then on the device wire, the launch
    counts zeroed right before and read right after each side: one
    window-attention launch a Swin block (compress g_a + g_s + the
    refiners', with the debug reconstruction; decompress g_s + the
    refiners'), no GDN launch, and on the device wire 2 encode and
    ctx_slices + 1 decode launches, no host round trip in decompress and
    the bytes within the host wire's plus each slice-lane's flush (the
    checks of phases 5 and 7); then its eval forward against the CPU's.
    stf8 also holds the rANS kernels at the zigzag blocks' lanes (stf5's
    and stf7's are stf's, phase 12). -> {model, codec (host wire), dev
    (device wire), enc (the host wire's debug encode), result, counts (by
    path), expect (the host wire's launches by side), transforms (window
    attention's launches of g_a and g_s by side)}."""
    import torch

    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.nn.swin import SwinBlock

    t = time.time()
    model = create_model(name, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    g_a, g_s = (sum(isinstance(m, SwinBlock) for m in g.modules())
                for g in (model.g_a, model.g_s))
    r = sum(isinstance(m, SwinBlock) for n, m in model.named_modules() if "_refine_" in n)
    log(f"  {name}: {n_params / 1e6:.1f} M parameters in {time.time() - t:.1f}s; "
        f"{model.ctx_slices} slices of {model.slice_ch} channels; Swin blocks g_a {g_a}, "
        f"g_s {g_s}, refiners {r}")
    if r != FAMILY_REFINER_BLOCKS[name]:
        raise AssertionError(f"{name}: {r} refiner blocks, expected {FAMILY_REFINER_BLOCKS[name]}")
    none = {"gdn_forward": 0, "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0}
    expect = {"compress": {**none, "window_attention": g_a + g_s + r},
              "decompress": {**none, "window_attention": g_s + r}}
    codec = CharmCodec(model, narrow=0.2)
    result, enc, enc_l, dec_l = host_wire_phase(codec, x, card, zero_counts, read_counts, expect,
                                                FAMILY_REPS)
    dev = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2)
    result["device_wire"], dev_enc_l, dev_dec_l = device_wire_phase(
        dev, enc, x, card, zero_counts, read_counts,
        {"compress": {**expect["compress"], "rans_encode": 2},
         "decompress": {**expect["decompress"], "rans_decode": model.ctx_slices + 1}},
        FAMILY_REPS)
    if name == "stf8":
        rans_rows += check_rans(dev.kit, dev.tables, seed, x.shape[0], x.shape[1], model, name)
    result["card_vs_cpu"] = family_eval_vs_cpu(name, model, seed, bf16=name == FAMILY_BF16_EVAL)
    result.update(params=n_params, ctx_slices=model.ctx_slices, slice_channels=model.slice_ch,
                  swin_blocks={"g_a": g_a, "g_s": g_s, "refiners": r},
                  lanes_per_slice_image=dev.kit.n_lanes(*y_slice_hw(model, x.shape[1])))
    counts = {"launches_compress": enc_l, "launches_decompress": dec_l,
              "launches_device_wire_compress": dev_enc_l,
              "launches_device_wire_decompress": dev_dec_l}
    return dict(model=model, codec=codec, dev=dev, enc=enc, result=result, counts=counts,
                expect=expect, transforms={"compress": g_a + g_s, "decompress": g_s})


def family_train_phase(fam: dict, name: str, seed: int, card: str) -> dict:
    """Phases 24-26 for a training preset: ``run_training`` on the card,
    each step launching window attention once a Swin block (g_a, g_s and
    the refiners) and no other kernel: 3 steps through the registry's
    unrolled forward (``tools/train.py``'s default), then 3 through the
    ``scan_charm=True`` forward at the preset's stochastic depth (0.2, the
    refiners' too); one ``scan_charm`` step card against CPU at depth 0
    (phase 16's rule); then 3 bfloat16 steps of the unrolled forward from
    the weights the first f32 step started from (phase 17's checks).
    -> results; the per-step launches by forward and dtype under
    "launches"."""
    model = fam["model"]
    expect = {"window_attention": fam["transforms"]["compress"] + fam["result"]["swin_blocks"][
        "refiners"], "gdn_forward": 0, "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0}
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    with Phase(f"full-width {name} training, unrolled forward"):
        out["unrolled"] = train_phase(model, seed, card, expect, steps=3, resumed_steps=0)
    with Phase(f"full-width {name} training, scan_charm forward (stochastic depth 0.2)"):
        model.scan_charm = True
        try:
            out["scan_charm"] = train_phase(model, seed, card, expect, steps=3, resumed_steps=0)
            out["scan_charm"]["drop_path_rate"] = max(
                m.rate for m in model.modules() if hasattr(m, "rate"))
        finally:
            model.scan_charm = False
    with Phase(f"{name} scan_charm training step, card vs CPU"):
        model.scan_charm = True
        try:
            out["card_vs_cpu"] = train_vs_cpu_phase(name, model, seed, scan_charm=True)
        finally:
            model.scan_charm = False
    with Phase(f"full-width {name} training under the bf16 policy"):
        out["bf16"] = bf16_train_phase(model, init_state, seed, card, expect, out["unrolled"])
    out["launches"] = {"float32": {"launches_train_step": out["unrolled"]["launches_per_step"],
                                   "launches_train_step_scan_charm":
                                       out["scan_charm"]["launches_per_step"]},
                       "bfloat16": {"launches_train_step": out["bf16"]["launches_per_step"]}}
    return out


def shape_counts() -> dict:
    """Window attention's launches by (dtype, head width) and GDN's by
    (direction, dtype, channels) since the counts were last zeroed."""
    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import window_attention as twa

    def name(dt) -> str:
        return str(dt).split('.')[-1]

    return {"window_attention": {f"{name(dt)} D{d}": n
                                 for (dt, d), n in sorted(twa.LAUNCHES.items(), key=str)},
            "gdn": {f"{k} {name(dt)} C{c}": n
                    for k, counter in (("forward", tgdn.FWD_LAUNCHES),
                                       ("backward", tgdn.BWD_LAUNCHES))
                    for (dt, c), n in sorted(counter.items(), key=str)}}


def crc_expect(name: str, side: str, **rans) -> tuple:
    """(the launch counts of one side of a CRC model, by kernel; by shape,
    as ``shape_counts`` gives them), float32."""
    per = CRC_SIDE_LAUNCHES[name][side]
    attn = {f"float32 D{d}": per[d] for d in (24, 48, 32) if per.get(d)}
    gdn = {f"forward float32 C{c}": per[f"gdn{c}"] for c in (192, 256) if per.get(f"gdn{c}")}
    counts = {"window_attention": sum(attn.values()), "gdn_forward": sum(gdn.values()),
              "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0, **rans}
    return counts, {"window_attention": attn, "gdn": gdn}


def aten_calls(fn) -> int:
    """ATen operator calls of one call of ``fn`` (host-side profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


def crc_side_runs(codec, x, enc):
    """(compress, decompress) of ``codec`` as argument-free calls."""
    return (lambda: codec.compress(x),
            lambda: codec.decompress(enc["strings"], enc["shape"], enc["human_shape"]))


def crc_timing(codec, x, enc, reps: int = 3) -> dict:
    """img/s of each side (median of ``reps`` host-clock calls ending in a
    synchronize), its device busy ms and idle share (one traced call) and
    its ATen calls."""
    import torch

    B = x.shape[0]
    out = {}
    for side, fn in zip(("compress", "decompress"), crc_side_runs(codec, x, enc)):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            walls.append(time.time() - t)
        busy = device_busy_ms(fn)
        wall = float(np.median(walls))
        out[side] = dict(img_per_s=B / wall, wall_ms=1e3 * wall, device_busy_ms=busy,
                         device_idle_share=max(0.0, 1.0 - busy / (1e3 * wall)),
                         aten_calls=aten_calls(fn))
    return out


def crc_roundtrip(codec, x, zero_counts, read_counts, what: str, expect: dict):
    """compress (debug) -> decompress of ``codec``, the launch counts zeroed
    right before and read right after each side and held to ``expect[side]``
    (kernel counts, shape counts); decompress watched for host round trips
    (``torch.cuda.set_sync_debug_mode``) off the host wire. Holds y_hat
    bit-exact and the decoder's x_hat equal to the encoder's, finite and
    of the images' shape. -> (enc, dec, counts by side, shape counts by
    side, host round trips in decompress)."""
    import warnings

    import torch

    counts, shapes = {}, {}
    zero_counts()
    enc = codec.compress(x, return_debug=True)
    torch.cuda.synchronize()
    counts["compress"], shapes["compress"] = read_counts(), shape_counts()
    zero_counts()
    watch = codec.wire == "device"
    if watch:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dec = codec.decompress(enc["strings"], enc["shape"], enc["human_shape"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught if "synchroniz" in str(c.message)]
    torch.cuda.synchronize()
    counts["decompress"], shapes["decompress"] = read_counts(), shape_counts()
    log(f"  {what}: launches {counts}; by shape {shapes}"
        + (f"; host round trips in decompress: {len(syncs)}" if watch else ""))
    if syncs:
        raise AssertionError(f"{what}: decompress waited for the card: {syncs[:3]}")
    if not torch.equal(dec["y_hat"], enc["y_hat"]) or not torch.equal(dec["x_hat"], enc["x_hat"]):
        raise AssertionError(f"{what}: the decoder's y_hat or x_hat differs from the encoder's")
    if dec["x_hat"].shape != x.shape or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"{what}: bad x_hat {tuple(dec['x_hat'].shape)}")
    for side in counts:
        check_launches(f"{what}, {side}", counts[side], expect[side][0])
        if shapes[side] != expect[side][1]:
            raise AssertionError(f"{what}, {side}: launches by shape {shapes[side]}, expected "
                                 f"{expect[side][1]}")
    return enc, dec, counts, shapes, len(syncs)


CRC_STREAMS = ("machine_y", "machine_z", "human_y", "human_z")


def crc_bytes(enc, size: int) -> dict:
    per = {name: sum(len(b) for b in enc["strings"][k]) for k, name in enumerate(CRC_STREAMS)}
    B = len(enc["strings"][0])
    return {"bytes": per, "bpp": [8 * sum(len(enc["strings"][k][b]) for k in range(4))
                                  / (size * size) for b in range(B)]}


def crc_eval_vs_cpu(name: str, model, seed: int) -> dict:
    """The eval forward on the card against the plain CPU path, the same
    weights, one 256 x 256 image: x_hat, machine_x_hat and the human and
    machine y likelihoods within 1e-3."""
    import torch

    from icm_tpu_torch.data import make_images

    cpu_model = cpu_twin(name, model)
    xs = torch.from_numpy(make_images(seed + 1, 1, 256))
    with torch.no_grad():
        ref = cpu_model(xs)
        got = model(xs.cuda())
    worst = {key: (got[a][b] if b else got[a]).cpu().sub(ref[a][b] if b else ref[a]).abs()
             .max().item() for key, a, b in (("x_hat", "x_hat", None),
                                             ("machine_x_hat", "machine_x_hat", None),
                                             ("human y likelihoods", "likelihoods", "y"),
                                             ("machine y likelihoods", "machine_likelihoods", "y"),
                                             ("human z likelihoods", "likelihoods", "z"))}
    log(f"  max |card - cpu| ({name}, 256 x 256): {worst}")
    if not all(worst[k] <= 1e-3 for k in ("x_hat", "machine_x_hat", "human y likelihoods",
                                          "machine y likelihoods")):
        raise AssertionError(f"card and CPU disagree: {worst}")
    del cpu_model
    gc.collect()
    return {"size": 256, "f32_max_abs": worst, "tolerance": 1e-3}


def crc_phase(name: str, x, card: str, zero_counts, read_counts, seed: int) -> dict:
    """Phases 27-28: a CRC model (stf9, stf14) at its published full width,
    weights from ``seed``, on the images of phase 5 at ``narrow=0.2``:
    compress -> decompress on the host wire, the device wire and the scan
    wire (graphed and launch by launch), each held by ``crc_roundtrip``
    with the launches of CRC_SIDE_LAUNCHES (window attention by head
    width, GDN by channels; the device and scan wires: 4 encode launches,
    ctx_slices + 3 decode launches); the device wire's y_hat and x_hat
    equal to the host wire's and each stream's bytes within the host
    wire's x 1.02 plus each lane's flush and header; the scan wire's graphs
    held as phase 7a's (``graph_replays``), its blobs and bits equal to
    launch by launch, its y_hat within JAX's bar of the device wire's, and
    the bf16 policy refused; each side's img/s, device idle share and ATen
    calls on each wire; then the eval forward against the CPU's. -> {model,
    result, counts}."""
    import torch

    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.crc_codec import CRCCodec
    from icm_tpu_torch.nn import set_activation_dtype

    B, size = x.shape[0], x.shape[1]
    t = time.time()
    model = create_model(name, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    c = model.coder
    log(f"  {name}: {n_params / 1e6:.1f} M parameters in {time.time() - t:.1f}s; "
        f"{c.ctx_slices} slices of {c.slice_ch} channels, support {c.max_support}, "
        f"conditioning window {c.cond_blocks}")
    host_expect = {side: crc_expect(name, side) for side in ("compress", "decompress")}
    dev_expect = {"compress": crc_expect(name, "compress", rans_encode=4),
                  "decompress": crc_expect(name, "decompress", rans_decode=c.ctx_slices + 3)}
    result = {"params": n_params, "ctx_slices": c.ctx_slices, "slice_channels": c.slice_ch}
    counts = {}

    codec = CRCCodec(model, narrow=0.2)
    enc, _, l, sh, _ = crc_roundtrip(codec, x, zero_counts, read_counts,
                                     f"{name} host wire", host_expect)
    counts.update(launches_compress=l["compress"], launches_decompress=l["decompress"])
    result["host_wire"] = {**crc_bytes(enc, size), "launches": l, "launches_by_shape": sh,
                           **crc_timing(codec, x, enc)}

    dev = CRCCodec(model, narrow=0.2, wire="device")
    denc, _, l, sh, syncs = crc_roundtrip(dev, x, zero_counts, read_counts,
                                          f"{name} device wire", dev_expect)
    counts.update(launches_device_wire_compress=l["compress"],
                  launches_device_wire_decompress=l["decompress"])
    if not torch.equal(denc["y_hat"], enc["y_hat"]) or not torch.equal(denc["x_hat"], enc["x_hat"]):
        raise AssertionError(f"{name}: the device wire's y_hat or x_hat differs from the host's")
    kit = dev.kit
    h = size // 16
    lanes = {"machine_y": kit.n_lanes(h // 2, h // 2),
             "machine_z": (size // 64) ** 2 * kit.z_groups(c.entropy_bottleneck.channels),
             "human_y": kit.n_lanes(h, h),
             "human_z": (size // 64) ** 2 * kit.z_groups(
                 model.human_hyper.entropy_bottleneck.channels)}
    host_b, dev_b = crc_bytes(enc, size)["bytes"], crc_bytes(denc, size)["bytes"]
    stream_bytes = {k: dict(device=dev_b[k], host=host_b[k], lanes=lanes[k],
                            limit=host_b[k] * 1.02 + B * (lanes[k] * 8 + 16)) for k in lanes}
    log(f"  {name} device wire bytes {stream_bytes}")
    for k, v in stream_bytes.items():
        if v["device"] > v["limit"]:
            raise AssertionError(f"{name} device wire {k}: {v['device']} bytes over {v['limit']}")
    result["device_wire"] = {**crc_bytes(denc, size), "stream_bytes": stream_bytes,
                             "launches": l, "launches_by_shape": sh,
                             "host_round_trips_in_decompress": syncs,
                             **crc_timing(dev, x, denc)}

    scan = CRCCodec(model, narrow=0.2, wire="device", scan_wire=True)
    t = time.time()
    first = scan.compress(x, return_debug=True)
    scan.decompress(first["strings"], first["shape"], first["human_shape"])
    torch.cuda.synchronize()
    first_s = time.time() - t
    stats = scan.graphs.stats()
    graphs = {" ".join(str(p) for p in key): st for key, st in stats.items()}
    capture_s = sum(st["capture_s"] for st in stats.values())
    pool_bytes = sum(st["pool_bytes"] for st in stats.values())
    log(f"  {name} scan wire: first compress + decompress {first_s:.2f}s, captures "
        f"{capture_s:.2f}s of it, pools {pool_bytes / 2**20:.1f} MiB, {len(graphs)} graphs")
    senc, sdec, l, sh, syncs = crc_roundtrip(scan, x, zero_counts, read_counts,
                                             f"{name} scan wire", dev_expect)
    counts.update(launches_scan_wire_compress=l["compress"],
                  launches_scan_wire_decompress=l["decompress"])
    per_replay = graph_replays(scan, c.ctx_slices)
    plain = CRCCodec(model, narrow=0.2, wire="device", scan_wire=True, cuda_graphs=False)
    penc = plain.compress(x, return_debug=True)
    pdec = plain.decompress(senc["strings"], senc["shape"], senc["human_shape"])
    if penc["strings"] != senc["strings"]:
        raise AssertionError(f"{name} scan wire: graphed blobs differ from launch by launch")
    for got, want, what in ((penc, senc, "compress"), (pdec, sdec, "decompress")):
        for k in ("y_hat", "x_hat"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{name} scan wire: graphed {what} {k} differs from launch "
                                     "by launch")
    d = (senc["y_hat"] - enc["y_hat"]).abs()
    vs_device = {"share_above_1e-2": float((d > 1e-2).float().mean()),
                 "median": float(d.median()), "max": float(d.max())}
    log(f"  {name} scan wire y_hat against the device wire's: {vs_device} (bars "
        f"{SCAN_VS_DEVICE})")
    if not (vs_device["share_above_1e-2"] < SCAN_VS_DEVICE["share_above_1e-2"]
            and vs_device["median"] < SCAN_VS_DEVICE["median"]):
        raise AssertionError(f"{name} scan wire y_hat strays from the device wire's: {vs_device}")
    set_activation_dtype(torch.bfloat16)
    try:
        CRCCodec(model, wire="device", scan_wire=True)
    except ValueError as e:
        refused = str(e).split(";")[0]
    else:
        raise AssertionError(f"{name}: the scan wire took the bf16 policy")
    finally:
        set_activation_dtype(None)
    result["scan_wire"] = {
        **crc_bytes(senc, size), "launches": l, "launches_by_shape": sh,
        "host_round_trips_in_decompress": syncs, "tier": sorted({b[4] for b in senc["strings"][0]}),
        "first_call_s": first_s, "capture_s": capture_s, "pool_bytes": pool_bytes,
        "graphs": graphs, "launches_per_replay": per_replay, "y_hat_vs_device_wire": vs_device,
        "bf16_refused": refused, **crc_timing(scan, x, senc),
        "launch_by_launch": crc_timing(plain, x, penc)}
    sides = {w: {s: result[w][s] for s in ("compress", "decompress")}
             for w in ("host_wire", "device_wire", "scan_wire")}
    sides["scan_launch_by_launch"] = result["scan_wire"]["launch_by_launch"]
    log(f"  {name} img/s, device idle, ATen calls (median of 3, batch {B}, {card}): " + "; ".join(
        f"{w} " + " / ".join(f"{v['img_per_s']:.2f} img/s idle {v['device_idle_share']:.3f} "
                             f"{v['aten_calls']} ATen" for v in per.values())
        for w, per in sides.items()))
    del scan, plain, dev, codec
    gc.collect()
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = crc_eval_vs_cpu(name, model, seed)
    return dict(model=model, result=result, counts=counts)


def crc_train_phase(model, name: str, seed: int, card: str) -> dict:
    """Phase 29: ``run_training`` of a CRC model on the card, its
    RateDistortionLoss over both layers' likelihoods (the JAX model's
    docstring for training from scratch): 3 steps of 8 x 256^2, each
    finite, each launching CRC_STEP, every parameter moved but the split
    decoder's (machine_x_hat enters no loss term); then one step on the
    card against the plain CPU path on a small input. -> results."""
    from icm_tpu_torch.train import RateDistortionLoss

    criterion = RateDistortionLoss(0.01, likelihood_keys=CRC_LIKELIHOODS)
    out = train_phase(model, seed, card, CRC_STEP, steps=3, resumed_steps=0,
                      criterion=criterion, fixed=("g_s1.", "g_s2."))
    if out["launches_by_shape_per_step"] != CRC_STEP_SHAPES:
        raise AssertionError(f"{name} step: launches by shape {out['launches_by_shape_per_step']}"
                             f", expected {CRC_STEP_SHAPES}")
    out["card_vs_cpu"] = train_vs_cpu_phase(name, model, seed, criterion=criterion)
    return out


def reference_crc_state_dict(seed: int, N: int = 192, M: int = 384, mid: int = 256,
                             enc=(384, 336, 288, 240, 192), dec=(240, 288, 336, 384, 384),
                             cc=(224, 176, 128, 64), K: int = 12) -> dict:
    """A reference stf9 state dict at full width: the reference's module
    names (stf9.py: ``g_a``, the inline coder's ``h_a``, ``h_mean_s``,
    ``cc_*_transforms2`` and the ``lrp_transforms2`` its forward discards,
    ``g_s1``, ``g_s2``, ``human_g_s2``, ``human_g_a``, ``human_g_s``, the
    ``human_h_*`` hyperprior, ``human_context_decoder``, both bottlenecks)
    and shapes (the published widths by default), DataParallel's ``module.``
    prefix, values drawn from ``seed`` as ``reference_wacnn_state_dict``
    draws them."""
    import torch

    S = Wc = 24  # 6 x 2x2 zigzag slices, all of them in the conditioning window
    ref = _RefDraw(np.random.default_rng(seed), np.float32)
    ref.conv("g_a.0", N, 3, 5)
    ref.gdn("g_a.1", N)
    ref.conv("g_a.2", N, N, 5)
    ref.gdn("g_a.3", N)
    ref.win("g_a.4", N, 8)
    ref.conv("g_a.5", N, N, 5)
    ref.gdn("g_a.6", N)
    ref.conv("g_a.7", M, N, 5)
    ref.win("g_a.8", M, 4)
    for prefix, extra in (("", 0), ("human_", 5)):
        for i, (o, c) in enumerate(zip(enc, (M,) + enc[:-1])):
            ref.conv(f"{prefix}h_a.{2 * i}", o, c, 3)
        for tag in ("h_mean_s", "h_scale_s"):
            ref.hyper_dec(f"{prefix}{tag}", enc[-1], dec, extra)
    sc = M // 6
    for i in range(S):
        for tag, lrp in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                         ("lrp_transforms2", sc)):
            cin = [Wc * sc + sc * min(i, K) + lrp] + list(cc)
            for j in range(4):
                ref.conv(f"{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            ref.conv(f"{tag}.{i}.8", sc, cc[-1], 3)
    ref.bottleneck("entropy_bottleneck", enc[-1])
    ref.bottleneck("entropy_bottleneck_human", enc[-1])
    for prefix, part in (("g_s1", 1), ("g_s2", 2), ("human_g_s2", None)):
        if part != 2:
            ref.win(f"{prefix}.0", M, 4)
            ref.conv(f"{prefix}.1", N, M, 5, transposed=True)
            ref.gdn(f"{prefix}.2", N)
            ref.conv(f"{prefix}.3", mid, N, 5, transposed=True)
            ref.gdn(f"{prefix}.4", mid)
            ref.win(f"{prefix}.5", mid, 8)
        if part != 1:
            o = 0 if part == 2 else 6
            ref.conv(f"{prefix}.{o}", N, mid, 5, transposed=True)
            ref.gdn(f"{prefix}.{o + 1}", N)
            ref.conv(f"{prefix}.{o + 2}", 3, N, 5, transposed=True)
    for j, (i, o) in enumerate(zip((6, N, N, N), (N, N, N, M))):
        ref.conv(f"human_g_a.{2 * j}", o, i, 5)
    for j, (i, o) in enumerate(zip((2 * M, N, N, N), (N, N, N, 3))):
        ref.conv(f"human_g_s.{2 * j}", o, i, 5, transposed=True)
    for j in range(5):
        ref.conv(f"human_context_decoder.{2 * j}", M, M, 3)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def crc_reference_phase(model, x, card: str, zero_counts, read_counts, seed: int) -> dict:
    """Phase 30: a reference stf9 checkpoint at full width, as phase 18:
    the seeded reference dict converted (``zoo.convert_reference_state_dict``)
    and loaded strictly into ``model``; the converted model's own CDF tables
    (both bottlenecks and the Gaussian) written into it as the reference's
    buffers and imported back equal; the images of phase 5 on the host wire
    with the imported tables in the reference symbol order
    (``ref_layout=True``), held by ``crc_roundtrip``, the blobs equal to the
    built tables' in that order. -> results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import build_codec_tables
    from icm_tpu_torch.models.crc_codec import CRCCodec

    t = time.time()
    sd = reference_crc_state_dict(seed)
    model.load_state_dict(zoo.convert_reference_state_dict("stf9", sd), strict=True)
    built = build_codec_tables(model)
    stored = {"gaussian_conditional": built.gaussian, **built.bottlenecks}
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            sd[f"module.{prefix}._{field}"] = torch.from_numpy(getattr(tab, field))
    sd["module.gaussian_conditional.scale_table"] = torch.from_numpy(built.scale_table)
    imported = zoo.import_reference_tables(sd)
    got = {"gaussian_conditional": imported.gaussian, **imported.bottlenecks}
    if set(got) != set(stored):
        raise AssertionError(f"imported tables {sorted(got)}, stored {sorted(stored)}")
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            if not np.array_equal(getattr(got[prefix], field), getattr(tab, field)):
                raise AssertionError(f"imported {prefix} {field} differs from the stored one")
    log(f"  {len(sd)} reference tensors converted, loaded strictly and tables imported in "
        f"{time.time() - t:.1f}s")
    codec = CRCCodec(model, tables=imported, ref_layout=True, narrow=0.2)
    expect = {side: crc_expect("stf9", side) for side in ("compress", "decompress")}
    enc, _, l, shapes, _ = crc_roundtrip(codec, x, zero_counts, read_counts,
                                         "stf9 reference, host wire", expect)
    built_enc = CRCCodec(model, ref_layout=True, narrow=0.2).compress(x)
    if built_enc["strings"] != enc["strings"]:
        raise AssertionError("imported tables' blobs differ from the built tables' ones")
    sha = {name: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
           for k, name in enumerate(CRC_STREAMS)}
    log(f"  blobs with imported tables = built tables (reference order); sha256 {sha}")
    return {"tensors": len(sd), **crc_bytes(enc, x.shape[1]), "blob_sha256": sha,
            "launches_reference_compress": l["compress"],
            "launches_reference_decompress": l["decompress"],
            "shapes_reference_compress": shapes["compress"],
            "shapes_reference_decompress": shapes["decompress"]}


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
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.nn import window_attention as twa
    from icm_tpu_torch.nn.swin import SwinBlock

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

        for name, fn in _native.BUILDERS.items():
            threads.append(threading.Thread(target=build, args=(name, fn)))
            threads[-1].start()
        for t in threads:
            t.join()
        for name, res in results.items():
            if isinstance(res, BaseException):
                raise res
            log(f"  built {name}: {os.path.relpath(res[0], REPO)} in {res[1]:.1f}s")
        for lib in ("libwindow_attention", "libgdn", "librans_lanes"):
            for line in _native.BUILD_LOG.get(lib, "").splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"  ptxas ({lib}): {line.strip()}")

    # the codec's numerics (full f32, deterministic cuDNN) for every phase
    from icm_tpu_torch.models import cuda_numerics
    cuda_numerics()

    with Phase("window attention vs plain"):
        rows = check_kernel(twa)

    with Phase("GDN kernels vs plain"):
        gdn_rows = check_gdn(tgdn)

    zero_counts, read_counts = launch_counts("float32")
    B, size = 2, 512
    x = torch.from_numpy(make_images(args.seed, B, size)).cuda()
    at_least_one = (1, None)

    with Phase("full-width WACNN compress/decompress"):
        t = time.time()
        model = create_model("cnn", seed=args.seed)  # N=192, M=320, 10 slices, on cuda
        n_params = sum(p.numel() for p in model.parameters())
        codec = CharmCodec(model, narrow=0.2)
        torch.cuda.synchronize()
        log(f"  model {n_params / 1e6:.1f} M parameters and codec tables in "
            f"{time.time() - t:.1f}s")
        on_path = {"window_attention": at_least_one, "gdn_forward": at_least_one,
                   "rans_encode": 0, "rans_decode": 0}
        slice_result, enc, enc_launches, dec_launches = host_wire_phase(
            codec, x, card, zero_counts, read_counts,
            {"compress": on_path, "decompress": on_path})

    with Phase("device-wire rANS kernels vs plain"):
        t = time.time()
        dev_codec = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2)
        torch.cuda.synchronize()
        log(f"  device-wire codec and its coder tables in {time.time() - t:.1f}s")
        table_bytes = {name: {"compact": 4 * tab.ctab.numel(), "lut2": 8 * tab.num_rows << 16}
                       for name, tab in (("y", dev_codec.kit.gauss_dev),
                                         ("z", dev_codec.kit.eb_dev["entropy_bottleneck"]))}
        log(f"  the decode kernel's compact tables against lut2, bytes: {table_bytes}")
        rans_rows = [row for images in (B, RANS_BENCH_IMAGES) for row in
                     check_rans(dev_codec.kit, dev_codec.tables, args.seed, images, size,
                                model, "cnn")]

    with Phase("full-width WACNN on the device wire"):
        (slice_result["device_wire"], dev_enc_launches,
         dev_dec_launches) = device_wire_phase(
            dev_codec, enc, x, card, zero_counts, read_counts,
            {"compress": {**on_path, "rans_encode": 2},
             "decompress": {**on_path, "rans_decode": model.ctx_slices + 1}})
    with Phase("full-width WACNN on the scan wire, CUDA graphs"):
        slice_result["scan_wire"], scan_enc_launches, scan_dec_launches = scan_wire_phase(
            model, dev_codec, x, card, zero_counts, read_counts,
            {"compress": {**on_path, "rans_encode": 2},
             "decompress": {**on_path, "rans_decode": model.ctx_slices + 1}},
            {"compress": dev_enc_launches, "decompress": dev_dec_launches})
    f32_counts = {"compress": enc_launches, "decompress": dec_launches,
                  "device_compress": dev_enc_launches, "device_decompress": dev_dec_launches}

    with Phase("full-width WACNN under the bf16 policy, both wires"):
        slice_result["bf16"], bf16_counts = bf16_serving_phase(
            codec, dev_codec, x, card, {"result": slice_result, "enc": enc, "counts": f32_counts})

    with Phase("card vs CPU reference, small input"):
        slice_result["card_vs_cpu"] = eval_vs_cpu_phase("cnn", model, args.seed)

    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with Phase("full-width WACNN training"):
        slice_result["train"] = train_phase(model, args.seed, card, TRAIN_STEP_LAUNCHES)
        train_launches = slice_result["train"]["launches_per_step"]

    with Phase("training step, card vs CPU"):
        slice_result["train"]["card_vs_cpu"] = train_vs_cpu_phase("cnn", model, args.seed)

    with Phase("full-width WACNN training under the bf16 policy"):
        slice_result["bf16"]["train"] = bf16_train_phase(
            model, init_state, args.seed, card, TRAIN_STEP_LAUNCHES, slice_result["train"])

    # each kernel's launches on each path of the main-path runs, by dtype
    paths = {"float32": {"cnn": {"launches_compress": enc_launches,
                                 "launches_decompress": dec_launches,
                                 "launches_device_wire_compress": dev_enc_launches,
                                 "launches_device_wire_decompress": dev_dec_launches,
                                 "launches_scan_wire_compress": scan_enc_launches,
                                 "launches_scan_wire_decompress": scan_dec_launches,
                                 "launches_train_step": train_launches}},
             "bfloat16": {"cnn": {
                 "launches_compress": bf16_counts["compress"],
                 "launches_decompress": bf16_counts["decompress"],
                 "launches_device_wire_compress": bf16_counts["device_compress"],
                 "launches_device_wire_decompress": bf16_counts["device_decompress"],
                 "launches_train_step": slice_result["bf16"]["train"]["launches_per_step"]}}}
    del model, codec, dev_codec, init_state
    torch.cuda.empty_cache()

    with Phase("full-width stf compress/decompress"):
        t = time.time()
        stf = create_model("stf", seed=args.seed)  # embed 48, M=384, 12 slices, on cuda
        n_params = sum(p.numel() for p in stf.parameters())
        codec = CharmCodec(stf, narrow=0.2)
        torch.cuda.synchronize()
        log(f"  model {n_params / 1e6:.1f} M parameters and codec tables in "
            f"{time.time() - t:.1f}s")
        # one launch a Swin block: g_a's and g_s's on compress (the debug
        # reconstruction runs g_s), g_s's on decompress
        g_a_blocks, g_s_blocks = (sum(isinstance(m, SwinBlock) for m in g.modules())
                                  for g in (stf.g_a, stf.g_s))
        none = {"gdn_forward": 0, "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0}
        stf_expect = {"compress": {**none, "window_attention": g_a_blocks + g_s_blocks},
                      "decompress": {**none, "window_attention": g_s_blocks}}
        log(f"  Swin blocks: g_a {g_a_blocks}, g_s {g_s_blocks}")
        stf_result, stf_enc, stf_enc_launches, stf_dec_launches = host_wire_phase(
            codec, x, card, zero_counts, read_counts, stf_expect)

    with Phase("device-wire rANS kernels vs plain at stf's shapes"):
        dev_codec = DeviceWireCodec(stf, lanes_per_image=1024, narrow=0.2)
        rans_rows += check_rans(dev_codec.kit, dev_codec.tables, args.seed, B, size, stf, "stf")

    with Phase("full-width stf on the device wire"):
        (stf_result["device_wire"], stf_dev_enc_launches,
         stf_dev_dec_launches) = device_wire_phase(
            dev_codec, stf_enc, x, card, zero_counts, read_counts,
            {"compress": {**stf_expect["compress"], "rans_encode": 2},
             "decompress": {**stf_expect["decompress"], "rans_decode": stf.ctx_slices + 1}})

    with Phase("full-width stf on the scan wire, CUDA graphs"):
        stf_result["scan_wire"], stf_scan_enc_launches, stf_scan_dec_launches = scan_wire_phase(
            stf, dev_codec, x, card, zero_counts, read_counts,
            {"compress": {**stf_expect["compress"], "rans_encode": 2},
             "decompress": {**stf_expect["decompress"], "rans_decode": stf.ctx_slices + 1}},
            {"compress": stf_dev_enc_launches, "decompress": stf_dev_dec_launches})

    with Phase("full-width stf under the bf16 policy, both wires"):
        stf_result["bf16"], stf_bf16_counts = bf16_serving_phase(
            codec, dev_codec, x, card,
            {"result": stf_result, "enc": stf_enc,
             "counts": {"compress": stf_enc_launches, "decompress": stf_dec_launches,
                        "device_compress": stf_dev_enc_launches,
                        "device_decompress": stf_dev_dec_launches}})

    with Phase("stf card vs CPU reference, small input"):
        stf_result["card_vs_cpu"] = eval_vs_cpu_phase("stf", stf, args.seed)

    stf_init = {k: v.detach().clone() for k, v in stf.state_dict().items()}
    stf_step = {**none, "window_attention": g_a_blocks + g_s_blocks}
    with Phase("full-width stf training"):
        # one window-attention launch a Swin block forward; no GDN, no coding
        stf_result["train"] = train_phase(stf, args.seed, card, stf_step, steps=4,
                                          resumed_steps=0)

    with Phase("stf training step, card vs CPU"):
        stf_result["train"]["card_vs_cpu"] = train_vs_cpu_phase("stf", stf, args.seed)

    with Phase("full-width stf training under the bf16 policy"):
        stf_result["bf16"]["train"] = bf16_train_phase(
            stf, stf_init, args.seed, card, stf_step, stf_result["train"])
    slice_result["stf"] = stf_result
    paths["float32"]["stf"] = {"launches_compress": stf_enc_launches,
                               "launches_decompress": stf_dec_launches,
                               "launches_device_wire_compress": stf_dev_enc_launches,
                               "launches_device_wire_decompress": stf_dev_dec_launches,
                               "launches_scan_wire_compress": stf_scan_enc_launches,
                               "launches_scan_wire_decompress": stf_scan_dec_launches,
                               "launches_train_step": stf_result["train"]["launches_per_step"]}
    paths["bfloat16"]["stf"] = {
        "launches_compress": stf_bf16_counts["compress"],
        "launches_decompress": stf_bf16_counts["decompress"],
        "launches_device_wire_compress": stf_bf16_counts["device_compress"],
        "launches_device_wire_decompress": stf_bf16_counts["device_decompress"],
        "launches_train_step": stf_result["bf16"]["train"]["launches_per_step"]}

    with Phase("reference checkpoint: full-width WACNN, imported tables, reference order"):
        slice_result["reference"], ref_counts = reference_phase(x, card, zero_counts,
                                                                read_counts, args.seed)
    paths["float32"]["cnn"].update(ref_counts)  # the reference path runs cnn's kernels

    family_transforms = {}  # each family model's g_a and g_s launches by side
    for name in FAMILY:
        with Phase(f"full-width {name}: host wire, device wire, card vs CPU"):
            fam = family_phase(name, x, card, zero_counts, read_counts, args.seed, rans_rows)
        result = slice_result[name] = fam["result"]
        counts = paths["float32"][name] = fam["counts"]
        family_transforms[name] = fam["transforms"]
        with Phase(f"full-width {name} on the scan wire, CUDA graphs"):
            result["scan_wire"], scan_enc_l, scan_dec_l = scan_wire_phase(
                fam["model"], fam["dev"], x, card, zero_counts, read_counts,
                {"compress": {**fam["expect"]["compress"], "rans_encode": 2},
                 "decompress": {**fam["expect"]["decompress"],
                                "rans_decode": fam["model"].ctx_slices + 1}},
                {"compress": counts["launches_device_wire_compress"],
                 "decompress": counts["launches_device_wire_decompress"]}, FAMILY_REPS)
            counts.update(launches_scan_wire_compress=scan_enc_l,
                          launches_scan_wire_decompress=scan_dec_l)
        with Phase(f"full-width {name} under the bf16 policy, both wires"):
            result["bf16"], bf16_l = bf16_serving_phase(
                fam["codec"], fam["dev"], x, card,
                {"result": result, "enc": fam["enc"],
                 "counts": {"compress": counts["launches_compress"],
                            "decompress": counts["launches_decompress"],
                            "device_compress": counts["launches_device_wire_compress"],
                            "device_decompress": counts["launches_device_wire_decompress"]}},
                FAMILY_REPS)
            # the scan wire runs in float32 only, as the JAX package's
            set_activation_dtype(torch.bfloat16)
            try:
                DeviceWireCodec(fam["model"], lanes_per_image=1024, scan_wire=True)
            except ValueError as e:
                result["bf16"]["scan_wire_refused"] = str(e).split(";")[0]
            else:
                raise AssertionError(f"{name}: the scan wire took the bf16 policy")
            finally:
                set_activation_dtype(None)
            log(f"  scan wire under the bf16 policy: refused ({result['bf16']['scan_wire_refused']})")
        paths["bfloat16"][name] = {
            "launches_compress": bf16_l["compress"],
            "launches_decompress": bf16_l["decompress"],
            "launches_device_wire_compress": bf16_l["device_compress"],
            "launches_device_wire_decompress": bf16_l["device_decompress"]}
        if name in FAMILY_TRAIN:
            result["train"] = family_train_phase(fam, name, args.seed, card)
            for dtype, per_step in result["train"].pop("launches").items():
                paths[dtype][name].update(per_step)
        del fam
        gc.collect()  # the model, its codecs and their graphs, before the next model
        torch.cuda.empty_cache()

    crc_shapes = {}  # each CRC path's launches by head width and GDN channels
    for name in CRC:
        with Phase(f"full-width {name}: host, device and scan wires, card vs CPU"):
            crc = crc_phase(name, x, card, zero_counts, read_counts, args.seed)
        result = slice_result[name] = crc["result"]
        paths["float32"][name] = crc["counts"]
        crc_shapes[name] = {
            f"launches{'' if w == 'host_wire' else '_' + w}_{side}":
                result[w]["launches_by_shape"][side]
            for w in ("host_wire", "device_wire", "scan_wire") for side in ("compress", "decompress")}
        if name == "stf9":
            with Phase("full-width stf9 training, card vs CPU"):
                result["train"] = crc_train_phase(crc["model"], name, args.seed, card)
            paths["float32"][name]["launches_train_step"] = result["train"]["launches_per_step"]
            crc_shapes[name]["launches_train_step"] = result["train"][
                "launches_by_shape_per_step"]
            with Phase("reference checkpoint: full-width stf9, imported tables, reference order"):
                result["reference"] = crc_reference_phase(crc["model"], x, card, zero_counts,
                                                          read_counts, args.seed)
            for side in ("compress", "decompress"):
                key = f"launches_reference_{side}"
                paths["float32"][name][key] = result["reference"][key]
                crc_shapes[name][key] = result["reference"][f"shapes_reference_{side}"]
        del crc
        gc.collect()  # the model, its codecs and their graphs, before the next model
        torch.cuda.empty_cache()

    def family_attention(models, part: str, dtype: str = "float32") -> dict:
        """Window attention's launches (its ``dtype`` build) on the family
        paths of ``models``, split by the phases' exact counts: its
        transforms' (g_a and g_s blocks, stf's shapes; a training step runs
        both) or its refiners' (the rest)."""
        out = {}
        for m in models:
            for key, counts in paths[dtype][m].items():
                g = family_transforms[m]["decompress" if key.endswith("decompress") else
                                         "compress"]
                out[f"{key}_{m}_{part}"] = (g if part == "transforms"
                                            else counts["window_attention"] - g)
        return {"launches": sum(out.values()), **out}

    def launch_keys(name, models=("cnn", "stf"), dtype="float32"):
        """The kernel's launches on each path of ``models``' main-path runs
        in ``dtype`` (its build of that dtype) and their sum."""
        per_path = {(key if m == "cnn" else f"{key}_{m}"): counts[name]
                    for m in models for key, counts in paths[dtype][m].items()}
        return {"launches": sum(per_path.values()), **per_path}

    def attention_entries(dtype: str, suffix: str):
        """Window attention's entries for ``dtype``: WACNN's path (head
        widths 24 and 40: one launch at each of its two shapes, times
        summed) and stf's D 16 build (one g_a or g_s pass, its twelve
        launches at its four shapes, times weighted by the launches);
        every row is under "cases"."""
        main = [r for r in rows if r["model"] == "cnn" and r["dtype"] == dtype
                and r["n_cls"] == 4 and r["W"] in (256 * B, 64 * B)]
        stf_main = [(r, STF_SIDE_LAUNCHES[r["W"], r["heads"]]) for r in rows
                    if r["model"] == "stf" and r["dtype"] == dtype and r["n_cls"] == 4
                    and (r["W"], r["heads"]) in STF_SIDE_LAUNCHES]
        unit = ("3xTF32 on the tensor cores (495 TFLOP/s dense), softmax at 67"
                if dtype == "float32" else
                "bf16 on the tensor cores (989 TFLOP/s dense), softmax at 67")
        d16_launches = launch_keys("window_attention", ("stf",), dtype)
        fam = family_attention(FAMILY, "transforms", dtype)
        d16_launches = {**d16_launches, **fam,
                        "launches": d16_launches["launches"] + fam["launches"]}
        return [{
            "name": "window_attention" + suffix,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/window_attention.cu",
            "replaces": "icm_tpu/nn/pallas_kernels.py:33",
            "dtype": dtype,
            **launch_keys("window_attention", ("cnn",), dtype),
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main) else "operations",
            "bound_unit": unit,
            "f32_fma_bound_ms": sum(r["f32_fma_bound_ms"] for r in main),
            "library_ms": sum(r["library_ms"] for r in main),
            "tolerance": TOLERANCE[dtype],
            "cases": [r for r in rows if r["model"] == "cnn" and r["dtype"] == dtype],
        }, {
            # the same kernel's head-width-16 build on stf's path (and, in
            # f32, the family's transforms)
            "name": "window_attention_d16" + suffix,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/window_attention.cu",
            "replaces": "icm_tpu/nn/pallas_kernels.py:33",
            "dtype": dtype,
            **d16_launches,
            "per": "one g_a or g_s pass of 2 x 512^2: " + ", ".join(
                f"{n} launches at W={w}, H={h}" for (w, h), n in STF_SIDE_LAUNCHES.items()),
            "max_abs_err": max(r["max_abs_err"] for r, _ in stf_main),
            **{key: sum(n * r[key] for r, n in stf_main)
               for key in ("ms", "plain_ms", "bound_ms", "f32_fma_bound_ms", "library_ms")},
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r, _ in stf_main)
                         else "operations"),
            "bound_unit": unit,
            "tolerance": TOLERANCE[dtype],
            "cases": [r for r in rows if r["model"] == "stf" and r["dtype"] == dtype],
        }]

    def refiner_entry(name: str, models: tuple, dtype: str = "float32") -> dict:
        """Window attention on the family refiners of ``models`` (its
        ``dtype`` build): one side's refiner launches of each, half at the
        unshifted shape's row and half at the shifted one's, times weighted
        by them; every row of these models in ``dtype`` under "cases"."""
        main = [(r, FAMILY_REFINER_BLOCKS[r["model"]] // 2) for r in rows
                if r["model"] in models and r["dtype"] == dtype
                and (r["W"], r["N"], r["D"]) == FAMILY_REFINER_SHAPES[r["model"]]]
        return {
            "name": name,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/window_attention.cu",
            "replaces": "icm_tpu/nn/pallas_kernels.py:33",
            "dtype": dtype,
            **family_attention(models, "refiners", dtype),
            "per": "one side's refiner launches at 2 x 512^2: " + ", ".join(
                f"{m} {FAMILY_REFINER_BLOCKS[m]} at W={FAMILY_REFINER_SHAPES[m][0]}, H=4, "
                f"N={FAMILY_REFINER_SHAPES[m][1]}, D={FAMILY_REFINER_SHAPES[m][2]}, half at 1 "
                "window class and half at 4" for m in models),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["model"] in models and r["dtype"] == dtype),
            **{key: sum(n * r[key] for r, n in main)
               for key in ("ms", "plain_ms", "bound_ms", "f32_fma_bound_ms", "library_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r, _ in main) else "operations",
            "bound_unit": ("3xTF32 on the tensor cores (495 TFLOP/s dense), softmax at 67"
                           if dtype == "float32" else
                           "bf16 on the tensor cores (989 TFLOP/s dense), softmax at 67"),
            "tolerance": TOLERANCE[dtype],
            "cases": [r for r in rows if r["model"] in models and r["dtype"] == dtype],
        }

    kernels = attention_entries("float32", "")
    # the family's refiners: head width 8 (stf5, stf7) and 16 (stf6 at N 16,
    # stf8 at N 64)
    kernels += [refiner_entry("window_attention_d8", ("stf5", "stf7")),
                refiner_entry("window_attention_d16_refiners", ("stf6", "stf8"))]

    def crc_launches(group: str, key: str) -> dict:
        """A kernel build's launches on every CRC path, by shape key."""
        per = {f"{path}_{m}": shapes[group].get(key, 0)
               for m, by_path in crc_shapes.items() for path, shapes in by_path.items()}
        return {"launches": sum(per.values()), **per}

    # the CRC family's head widths 32 and 48, float32 (their bfloat16 rows,
    # on no path yet, under "cases"); one launch at the path's shape
    for D, (W, N) in CRC_ATTENTION_SHAPES.items():
        main = [r for r in rows if r["model"] == "crc" and r["D"] == D and r["W"] == W
                and r["n_cls"] == 4 and r["dtype"] == "float32"]
        kernels.append({
            "name": f"window_attention_d{D}",
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/window_attention.cu",
            "replaces": "icm_tpu/nn/pallas_kernels.py:33",
            "dtype": "float32",
            **crc_launches("window_attention", f"float32 D{D}"),
            "per": f"one launch at W={W}, H=8, N={N}, D={D}, 4 window classes (2 x 512^2 "
                   "serving, 8 x 256^2 training)",
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["model"] == "crc" and r["D"] == D and r["dtype"] == "float32"),
            **{key: main[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "f32_fma_bound_ms", "library_ms")},
            "bound_unit": "3xTF32 on the tensor cores (495 TFLOP/s dense), softmax at 67",
            "tolerance": TOLERANCE["float32"],
            "cases": [r for r in rows if r["model"] == "crc" and r["D"] == D],
        })
    # the GDN layers of one training step: 8 x 192 at 128^2, 64^2, 32^2, GDN
    # and IGDN, one launch each; times summed. The serving and ragged rows
    # are in "cases", and every row's errors are under the tolerances
    no_library = ("no single PyTorch call computes the fused GDN function; "
                  "the plain version takes several")
    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        gdn_rows_d = [r for r in gdn_rows if r["dtype"] == dtype]
        gdn_main = [r for r in gdn_rows_d if r["path"] == "train"]
        for name, part, err_key, line in (("gdn_forward", "forward", "y", 50),
                                          ("gdn_backward", "backward", "dx", 64)):
            kernels.append({
                "name": name + suffix,
                "route": "cuda",
                "source": "icm_tpu_torch/csrc/gdn.cu",
                "replaces": f"icm_tpu/nn/gdn_pallas.py:{line}",
                "dtype": dtype,
                **launch_keys(name, dtype=dtype),
                "max_abs_err": max(r["max_abs_err"][err_key] for r in gdn_rows_d
                                   if r["path"] in ("train", "serve")),
                "max_err": max(r["err"][err_key] for r in gdn_rows_d
                               if r["path"] in ("train", "serve")),
                "ms": sum(r[part]["ms"] for r in gdn_main),
                "plain_ms": sum(r[part]["plain_ms"] for r in gdn_main),
                "bound_ms": sum(r[part]["bound_ms"] for r in gdn_main),
                "bound_by": ("operations" if all(r[part]["bound_by"] == "operations"
                                                 for r in gdn_main) else "bytes"),
                "bound_unit": (
                    "3xTF32 on the tensor cores (495 TFLOP/s dense), elementwise at 67; "
                    "4-byte activations" if dtype == "float32" else
                    f"{GDN_BF16_PASSES[part]} bfloat16 passes of its products on the tensor "
                    "cores (989 TFLOP/s dense), elementwise at 67; 2-byte activations"),
                "f32_fma_bound_ms": sum(r[part]["f32_fma_bound_ms"] for r in gdn_main),
                "library_ms": None,
                "library_note": no_library,
                "tolerance": GDN_TOLERANCE if dtype == "float32" else GDN_BF16_TOLERANCE,
                "cases": [{k: v for k, v in r.items()
                           if k not in ("forward", "backward")} | r[part] for r in gdn_rows_d],
            })
    # the GDN kernels' designs above 192 channels on the CRC path (the
    # forward on the FMA units, the backward's dx streaming gamma): the
    # forward at the serving shape, the backward at the training step's
    for name, part, err_key, line, path in (
            ("gdn_forward", "forward", "y", 50, "crc_serve"),
            ("gdn_backward", "backward", "dx", 64, "crc_train")):
        rows_256 = [r for r in gdn_rows if r["C"] == 256]
        main = [r for r in rows_256 if r["path"] == path and r["inverse"]
                and r["dtype"] == "float32"][0]
        kernels.append({
            "name": f"{name}_c256",
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/gdn.cu",
            "replaces": f"icm_tpu/nn/gdn_pallas.py:{line}",
            "dtype": "float32",
            **crc_launches("gdn", f"{part} float32 C256"),
            "per": f"one IGDN launch at {main['B']} x 256 x {main['H']}^2",
            "max_abs_err": max(r["max_abs_err"][err_key] for r in rows_256
                               if r["dtype"] == "float32"),
            **{key: main[part][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "f32_fma_bound_ms")},
            "bound_unit": "3xTF32 on the tensor cores (495 TFLOP/s dense), elementwise at 67; "
                          "4-byte activations",
            "library_ms": None,
            "library_note": no_library,
            "tolerance": GDN_TOLERANCE,
            "cases": [{k: v for k, v in r.items() if k not in ("forward", "backward")} | r[part]
                      for r in rows_256],
        })
    kernels += attention_entries("bfloat16", "_bf16")
    # the refiners' bfloat16 builds: head width 8 padded to 16 (stf5, stf7)
    # and 16 (stf6, stf8)
    kernels += [refiner_entry("window_attention_d8_bf16", ("stf5", "stf7"), "bfloat16"),
                refiner_entry("window_attention_d16_refiners_bf16", ("stf6", "stf8"), "bfloat16")]
    # the device wire's coder: integer kernels, held byte for byte (the
    # phase fails on any nonzero max_abs_err); y and z of one compress /
    # decompress of WACNN's B images, times summed; the rows at bench.py's
    # batch and at stf's shapes are under "cases"
    rans_main = [r for r in rans_rows if r["images"] == B and r["model"] == "cnn"]
    for name, part, line in (("rans_decode", "decode", 178), ("rans_encode", "encode", 231)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/rans_lanes.cu",
            "replaces": f"icm_tpu/coding/device_rans.py:{line}",
            "replaces_note": "not Pallas in JAX: integer jnp under lax.scan",
            **launch_keys(name, ("cnn", "stf") + FAMILY + CRC),
            "max_abs_err": max(r["max_abs_err"] for r in rans_rows),
            "ms": sum(r[part]["ms"] for r in rans_main),
            "plain_ms": sum(r[part]["plain_ms"] for r in rans_main),
            "bound_ms": sum(r[part]["bound_ms"] for r in rans_main),
            "bound_by": ("bytes" if all(r[part]["bound_by"] == "bytes" for r in rans_main)
                         else "operations"),
            "bound_unit": "bytes at 3.35 TB/s; 32-bit integer operations at 33.5 TOP/s",
            "library_ms": None,
            "library_note": "none: no one PyTorch call computes it",
            "tolerance": "byte for byte",
            "table_bytes": table_bytes,
            "cases": [{k: v for k, v in r.items() if k not in ("encode", "decode")} | r[part]
                      for r in rans_rows],
        })
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
