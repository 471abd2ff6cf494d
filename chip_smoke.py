"""Smoke run of icm_tpu_torch on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout. It needs one CUDA card, nvcc and g++,
and exits non-zero (printing no result) without a card or without the
package beside it. Phases, each printed with its elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), versions;
2. build: the window-attention, GDN and lane-rANS kernels (nvcc, sm_90a)
   and the host rANS coder (g++), from the sources in the checkout, all
   at once; phase 4 runs while window attention's build finishes, then
   phase 3;
3. window attention against its plain PyTorch version on the card, at
   the shapes of the full-width WACNN's path (head widths 24 and 40), of
   the full-width stf's (head width 16, windows of 16 tokens: 3, 6, 12
   and 24 heads over 8192, 2048, 512 and 128 windows) and of the zigzag
   family's refiners (4 heads: head width 8 over 128 windows of 16
   tokens (stf5) and 32 of 64 (stf7), head width 16 over 32 of 16 (stf6)
   and 8 of 64 (stf8), each at 1 and 4 window classes) and of the CRC
   family (8 heads: head width 32 over 512 windows of 64 tokens, 48 and
   96 (stf12's decoder head) over 128 of 16, each at 1 and 4 classes),
   then a ragged window count of each, in f32 and bf16; two launches must
   give the same bits; timed
   beside the plain version and F.scaled_dot_product_attention (a
   yardstick the port never calls);
4. the fused GDN forward and backward kernels against their plain
   versions at the training step's shapes (8 x 192 x 128^2, 64^2, 32^2,
   GDN and IGDN), the serving path's and one ragged shape, and the CRC
   family's 256 channels (2 x 256 x 128^2 serving, 8 x 256 x 64^2
   training), and 2 x 512 x 64^2, the widest the kernels take (on no
   model's path: gamma staged, the FMA forward and the streamed dx),
   timed beside
   the plain versions; two launches of each must give the same bits; in
   float32 and then the bfloat16 builds (x, g, y, dx bfloat16, gamma
   rounded to it, beta float32); above 192 channels (at 256 gamma held
   by a two-block cluster) the backward's device time split into its
   three kernels from a profiler trace (dx, dgamma, reduce), on a line of
   its own;
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
18a. cnn2 (113.2 M parameters: cnn's codec and a RetinaNet-ResNet-50
    student, P3-P7, 9 anchors x 80 classes, on the decoded image) at full
    width from ``--seed`` (its codec weights are cnn's; its student's stem
    and classification kernels scaled by CNN2_GAIN) on phase 5's images:
    the device wire held as phase 7 with phase 7's launch counts and blobs
    (sha256) and y_hat phase 5's; the serving call ``decompress_detect``
    (decompress, the student on x_hat, NMS on the host) with the counts
    zeroed right before and read right after: the decompress's launches
    and no more, y_hat and x_hat the encoder's, the maps finite, every
    detection above 0.05 and inside the image, some in each image; the
    scan wire held as phase 7a with phase 7a's blobs, the serving call on
    its graphs; the student's device time (CUDA events and profiled busy)
    against the decompress's, the host's decode seconds; the student on
    the card against its CPU twin on the card's x_hat (classification and
    regression within CNN2_STUDENT_TOL of their max, anchors equal); under
    the bfloat16 policy the device wire's compress and serving call with
    phase 7b's launch counts, x_hat bfloat16 and the student's maps
    float32;
18b. cnn2 training (8 x 256 x 256, RateDistortionLoss, 2 steps in float32
    and 2 under the bfloat16 policy from the same weights, as phases 9 and
    10b): the student runs in each forward and no loss term reads it, so
    its parameters and BatchNorm statistics must not move (every codec
    parameter must); the student's forward time in a step logged, and
    CNN2_AB_TURNS float32 steps with it and without it, in turns;
18c. a reference cnn2 checkpoint at full width (phase 18's WACNN dict with
    a seeded RetinaNet student in the reference's torchvision names and
    BatchNorm statistics, and a teacher's stem) converted and loaded
    strictly, its codec's tensors phase 18's cnn conversion bit for bit,
    the tables stored and imported; on the host wire in the reference
    order its blobs and launches phase 18's, and the serving call on them;
19-22. the zigzag family stf5, stf6, stf7 and stf8 at their published
    full width (weights from ``--seed``, f32), each on 2 images of 256 x
    256 (``FAMILY_WIRE_SIZE``, a quarter of phase 5's pixels, to keep the
    run inside its time) on the host wire and the device wire, held as in
    phases 5 and 7:
    one window-attention launch a Swin block (compress 24 + r with its
    debug reconstruction, decompress 12 + r, r the refiners' 432, 288,
    240 and 480 blocks), no GDN launch, 2 encode and ctx_slices + 1 (13,
    25, 13, 25) decode launches, no host round trip in decompress, the
    device wire's y_hat the host wire's and its bytes within the bound
    counted with each slice's lanes (an 8 x 8 zigzag block at 256 px: 64
    an image); each model's eval forward on the card against the plain CPU
    path on one 256 x 256 image (x_hat and y likelihoods within 1e-3);
    stf8's phase also holds the lane-rANS kernels at the zigzag blocks'
    shapes at 512 px (y 512 lanes x 1536 steps in 24 decode launches); stf7's eval
    forward is also held under the bfloat16 policy on both sides at 64 x
    64, as phase 14's end to end;
23. each family model on the scan wire (``ZigzagSwinScanWire``: the chain
    with its refiners, padded first convolutions) on phase 5's 512 px
    images, held as in phase 7a (the device wire's launch counts of phases
    19-22, which do not depend on the size):
    capture seconds and pool bytes of each graph, bit-exact, equal to
    launch by launch, counted launches a replay equal to a traced
    replay's, the device wire's launch counts (one decode launch a slice
    inside the decode graph, none of the encode kernel inside the encode
    graph), no host round trip in decompress, y_hat and bytes against the
    device wire's, img/s graphed, launch by launch and on the device wire,
    the idle share graphed (``FAMILY_SCAN_IDLE``); its graphs and stacked
    weights are freed before the next model;
24. each family model under the bfloat16 policy on both wires at 256 px,
    as phase 7b (the refiners' window attention in its bfloat16 builds: head width
    8 padded to 16, and 16), and its scan wire refusing the policy; phases
    19-24 time each wire once (``FAMILY_REPS``), not the median of 3;
25. stf7 and stf8 training (``run_training``, 8 x 256 x 256): 2 steps
    (``TRAIN_STEPS``) of the registry's unrolled forward, then 2 of the
    ``scan_charm=True``
    forward at the presets' stochastic depth 0.2 (the refiners' too), each
    step finite, the parameters moved, one window-attention launch a Swin
    block (g_a, g_s and the refiners) and no other kernel's; img/s and
    peak memory of both; one ``scan_charm`` step against the CPU at depth
    0, as phase 16;
26. 2 bfloat16 training steps of each, as phase 17;
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
    img/s (one call: ``CRC_REPS``), device idle share and ATen
    calls on each wire;
    the eval forward against the CPU's on one 256 x 256 image (x_hat,
    machine_x_hat, both y likelihoods within 1e-3);
29. stf9 training (``run_training``, 8 x 256 x 256, RateDistortionLoss
    over both layers' likelihoods): 2 steps (``TRAIN_STEPS``), each
    finite, 6 window
    attention, 9 GDN forward and 6 GDN backward launches (the split
    decoder g_s1 / g_s2 gives machine_x_hat, which no loss term reads:
    its parameters must not move, all others must), by width and
    channels as CRC_STEP_SHAPES; img/s and peak memory; one step card
    against CPU as phase 10;
30. a reference stf9 checkpoint at full width, as phase 18 (both
    bottlenecks' and the Gaussian's tables stored and imported, the host
    wire in the reference symbol order);
31. stf14 training (after phase 28) as phase 29: the port's one forward,
    which computes both of JAX's (the unrolled and ``scan_charm=True``);
32. stf12 (N=192, M=384, mid=256; 363.8 M parameters) at full width as
    phases 27-28 (its launches: CRC_SIDE_LAUNCHES, window attention at
    head width 96 in its decoder head);
33. stf12 training as phase 29 (9 window-attention launches a step, one
    at head width 96; 10 GDN forward, 7 backward);
34. stf12 under the bfloat16 policy from phase 32's weights: the device
    wire held as phase 32's (bit-exact, no host round trip, the same
    launches by head width and channels, every one a bfloat16 build's:
    head widths 24, 32, 48 and 96, GDN at 192 and 256 channels), its bpp
    within 5% and mean |x_hat - x_hat_f32| under 0.01 of phase 32's
    device wire (the seeded weights saturate x_hat, so that bar cannot
    catch a wrong bf16 path: the layer replay, bpp and likelihoods do),
    img/s and idle; the eval forward card against CPU as
    phase 8 (float32, then bfloat16 end to end and layer by layer with
    its control); 2 bfloat16 training steps as phase 10b (both layers'
    rates, the split decoder fixed);
35. a reference stf12 checkpoint at full width, as phase 30;
36. stf13 (N=192, M=384, mid=256; 801.8 M parameters: a machine layer, a
    segmentation layer and a human layer conditioned on both through
    learned masks; both zigzag coders with LRP and 3-conv context stacks)
    at full width as phases 27-28 with ``CRC3Codec``, from its seeded
    weights with the segmentation analysis's last convolution scaled by 16
    (CRC_GAIN: unscaled, its latent rounds to 0 everywhere and mu and LRP
    are 0, so every check of it would compare zeros): each zigzag layer's
    nonzero symbols held above 0; six streams; every wire's y_hat,
    seg_y_hat and x_hat bit-exact, the device wire's the host wire's; 6
    encode and 52 decode launches on the device and scan wires (24 + 24
    slices, three z, the human y); a chain graph each way for each zigzag
    layer on the scan wire, each decode graph with its 24 slices' decode
    launches (the LRP step inside); window attention and GDN by head width
    and channels as CRC_SIDE_LAUNCHES; the eval forward card against CPU
    (seg_x_hat and the segmentation y likelihoods too);
37. stf13 training as phase 29 over the three layers' rates (CRC_STEP: 16
    window-attention, 21 GDN forward and 15 GDN backward launches a step;
    g_s and seg_g_s, whose outputs no loss term reads, fixed);
38. stf13 under the bfloat16 policy from phase 36's weights, as phase 34;
39. a reference stf13 checkpoint at full width, as phase 30 (three
    bottlenecks' tables stored and imported, six streams in the reference
    order);
40. stf3 (92.6 M parameters: stf's transforms, two 5-block masked context
    stacks over [hyper tokens | y tokens] of D = 768, a global LRP) at full
    width with its reference mask, from its seeded weights with its context
    stacks' MLP outputs x0.25 (MASKED_GAIN) on 2 images of 512 x 512 at
    latent scale 0.3 (MASKED_LATENT_SCALE): its nonzero y symbols held
    above 0; the context pass at full width on the card with the buffer's
    rows >= i zeroed and set to 1, rows <= i of mu and scale bit-identical
    (i = 0, 1, N/2, N - 1); the host wire and the device wire (``Stf3Codec``:
    one lane per image and token element, 2 encode launches and N + 1 = 513
    decode launches, the y blob in the scan-wire format with its tier
    byte), each side's counts zeroed right before and read right after: y_hat
    and x_hat bit-exact, the device wire's the host wire's, 24 / 12
    window-attention launches at head width 16 and no GDN, no host round
    trip in a device-wire decompress, the device wire's bytes within the
    host wire's x 1.02 plus each lane's flush and header (768 lanes an image
    for y), each side's img/s (one call), device idle share and ATen calls;
    the eval forward card against CPU on one 256 x 256 image (x_hat and y
    likelihoods within 1e-3);
41. stf3 training (``run_training``, 8 x 256 x 256, stochastic depth 0.2): 3
    steps, each finite, 24 window-attention launches and no other kernel's,
    every parameter moved; one step card against CPU as phase 16;
42. a reference stf3 checkpoint at full width, as phase 18 (the bottleneck's
    and the Gaussian's tables stored and imported), on the host wire at the
    phase's latent scale, its nonzero symbols above 0;
43-45. stf4 (135.5 M parameters: one 2-head attention and the fused conv
    heads over 27-token windows; its dead scale head) as phases 40-42 with
    ``causal=True`` (its reference mask lets token 0 see every token) on 2
    images of 256 x 256 at latent scale 0.5 (129 decode launches); its
    training through its reference mask, as the JAX package trains it,
    every parameter moved but the scale head's;
40b, 43b. stf3 and stf4 under the bfloat16 policy from their f32 phases'
    weights (``masked_bf16_phase``): the device wire on the same images,
    held as phase 40's with its launches, all of them the bfloat16 builds'
    (window attention at head width 16), the encoder's y_hat bfloat16, its
    bpp within 5% of the f32 device wire's; the context pass's rows <= i
    unmoved under the policy at full width; the eval forward card against
    CPU as phase 8 (float32, then the policy end to end and layer by layer
    with its control); after phases 41 and 44, 2 bfloat16 training steps
    from the f32 training's starting weights (phase 10b's checks);
46. stf2 (337.1 M parameters: stf's transforms, 4 slices of 96 in 8 x 8
    windows, tokens of D = 6144, 64 an image at 512 px; a token loop whose
    step attends over 6 hyper and 6 decoded tokens, then three conv
    heads) at full width from its seeded weights on 2 images of 512 x 512
    at ``STF2_NARROW`` (0.5): its nonzero y symbols held at 1 or more;
    ``Stf2Codec`` on the host wire, on the device wire's token scan as CUDA
    graphs (captured by a first compress and decompress: seconds, capture
    seconds, pool bytes; the 64 token decodes inside the decode graph,
    each graph's launches a replay equal to a traced replay's) and on the
    same functions launch by launch, each side held as phase 40's (24 / 12
    window-attention launches, 2 encode and 65 decode launches, no host
    round trip), the two device runs' blobs and bits equal and their y_hat
    / x_hat the host wire's, the bytes within the host wire's x 1.02 plus
    each lane's flush and header (6,144 lanes an image), img/s, idle and
    ATen calls on the three; the eval forward card against CPU at 256 px;
46b. stf2 under the bfloat16 policy, as 40b (its y_hat bfloat16, as the
    JAX package's ``Stf2Codec`` gives it; its graphs captured anew);
47-48. stf2 training (3 steps at stochastic depth 0.2, one card against
    CPU, then 2 bfloat16 steps) and a reference stf2 checkpoint, as phases
    41-42;
49. czigzag (242.7 M parameters: stf's transforms with cross window
    attention to a second image up_x4, two Swin hyper stacks at 384 and
    192 channels, 4 x 2x2 = 16 zigzag slices of 96 with a third
    conditioning, the hyper context's blocks, and LRP) at full width from
    its seeded weights on phase 5's images and their up_x4
    (``conditioning_image``: x average-pooled by 4 and bilinearly
    upsampled back, on the card) at ``CZIGZAG_NARROW`` (0.5): its nonzero
    y symbols held at 1 or more; ``CzigzagCodec`` on the host wire, the
    device wire and the scan wire (graphed, held as phase 7a, the 16 slice
    decodes inside the decode graph; and launch by launch), each side held
    by ``codec_roundtrip`` with window attention by head width
    (``CZIGZAG_SIDE_LAUNCHES``: 16, 48, 96) and 2 encode / 17 decode
    launches on the device and scan wires, no host round trip; the device
    wire's y_hat and x_hat the host wire's, the scan wire's against them,
    each stream's bytes within the host wire's x 1.02 plus its lanes'
    flushes; img/s, idle and ATen calls of each; the bf16 policy refused
    by the scan wire; the eval forward card against CPU at 256 px;
50. czigzag training (3 steps of 8 x 256 x 256 at stochastic depth 0.2,
    each launching CZIGZAG_STEP_LAUNCHES, every parameter moved; one step
    card against CPU);
51. czigzag under the bfloat16 policy from the weights training started
    from: the device wire bit-exact with every attention launch a bfloat16
    build's, y_hat bfloat16, bpp within 5% and x_hat within 0.01 of the
    float32 device wire's, the eval forward card against CPU end to end
    and layer by layer as phase 8, 2 bfloat16 training steps;
52. a reference czigzag checkpoint at full width with imported tables on
    the host wire, as phase 42.

Each serving phase also logs its sides' device idle share: one profiled
compress and decompress (the union of the card's kernel, copy and memset
intervals, read from the profiler's events: ``profiled_call``) against the
median unprofiled wall time.

The masked family's phases add their window-attention launches to
``window_attention_d16`` and, under the bfloat16 policy, to
``window_attention_d16_bf16`` (its transforms are stf's), and their f32
lane-rANS launches to ``rans_encode`` / ``rans_decode``, under their own
path keys.

czigzag's phases add its window-attention launches at head width 16 to
``window_attention_d16`` (and its bfloat16 entry) and those at 48 and 96
(its hyper stacks) to ``window_attention_d48`` / ``_d96`` beside the CRC
paths' (with its shape's times under ``czigzag_shape``), and its lane-rANS
launches to ``rans_encode`` / ``rans_decode``.

cnn2's phases add their launches (its device, scan and reference wires,
each detecting decompress, its training steps; under the bfloat16 policy
its device wire and steps) to WACNN's entries: window attention at head
widths 24 and 40, the GDN kernels at 192 channels and the lane-rANS
kernels, each under its own path keys ending in ``_cnn2``.

The kernels line lists window attention's head widths 32, 48 and 96 and
the GDN kernels at 256 channels (``window_attention_d32``, ``_d48``,
``_d96``, ``gdn_forward_c256``, ``gdn_backward_c256`` and their ``_bf16``
builds, the GDN entries naming their CUDA function,
``gdn_fwd_kernel_cluster`` or ``gdn_bwd_kernel_dx_cluster``, in bfloat16
``gdn_fwd_kernel_bf16`` or ``gdn_bwd_kernel_dx_bf16``; the backward's with
its split) with their launches on the CRC paths (the
bfloat16 builds' on stf12's bfloat16 paths), read from the wrappers'
counts by width and channels; WACNN's attention and 192-channel GDN
entries keep their own paths' sum as ``launches`` and list the CRC paths'
launches at head width 24 and 192 channels beside it (``launches_crc``).
It
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
import re
import struct
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
# lo*lo: 5). Up to 256 channels the kernels run these passes
# (csrc/gdn.cu's bfloat16 design: gdn_fwd_kernel_bf16,
# gdn_bwd_kernel_dx_bf16, gdn_bwd_kernel_dgamma_bf16); above, in TF32
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
# kernels each profiled session runs before the call (see profile_session),
# and the name of the call's marker in the session
TRACE_WARMUP_KERNELS = 64
TRACE_MARK = "chip_smoke_traced_call"
# the ATen utility calls the profiler's summaries (``key_averages``) leave
# out, and profiled_call too
ATEN_UNCOUNTED = ("aten::is_leaf", "aten::output_nr", "aten::_version")
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
# the zigzag family's host and device wires and its bfloat16 wires (phases
# 19-22 and 24) at 2 x 256^2, a quarter of phase 5's pixels, to keep the run
# inside its time (their sides are host-bound: ~2 s a model saved); its
# graphed scan wire (phase 23) stays at 512. Their device idle share is
# measured on the float32 device wire only (a profiled side of 40,000-93,000
# ATen calls takes 2-4 s)
FAMILY_WIRE_SIZE = 256
# and on its scan wire (phase 23) the idle share of the graphed wire only:
# profiling its launch-by-launch and device wires' 38,000-93,000 ATen calls
# a side took 8-14 s a model (cut for time; their img/s stay)
FAMILY_SCAN_IDLE = ("graphed",)
# cut for time, every check kept (PERF.md section 4): the window-
# attention rows timed as the median of 10 calls (20 before); the zigzag
# family's and the CRC family's training phases at 2 steps each (3 before)
ATTENTION_ITERS = 10
TRAIN_STEPS = 2


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
# 4), 8 heads; stf12's decoder head over 768 channels (32 x 32 at window 4:
# head width 96); a training step of 8 x 256^2 gives the same shapes. Its
# launches by side and model (g_a, human_g_s2; stf14's decoder runs
# human_g_s2 again; stf12's encoder and decoder each run its two
# conditioning decoders, human_g_enc2 a whole MainCNNDecoder and
# human_g_enc3 a 384-channel block and an IGDN, and its decoder head, and
# its encoder tail a 384-channel block): by head width 24, 48, 32, 96, and
# the GDN forward's at 192 and 256 channels
CRC = ("stf9", "stf14", "stf12", "stf13")
CRC_ATTENTION_SHAPES = {32: (512, 64), 48: (128, 16), 96: (128, 16)}
CRC_SIDE_LAUNCHES = {
    "stf9": {"compress": {24: 1, 48: 2, 32: 1, "gdn192": 5, "gdn256": 1},
             "decompress": {}},
    "stf14": {"compress": {24: 1, 48: 3, 32: 2, "gdn192": 7, "gdn256": 2},
              "decompress": {48: 1, 32: 1, "gdn192": 2, "gdn256": 1}},
    "stf12": {"compress": {24: 1, 48: 6, 32: 2, 96: 1, "gdn192": 9, "gdn256": 2},
              "decompress": {48: 2, 32: 1, 96: 1, "gdn192": 3, "gdn256": 1}},
}
# a training step's forward: stf9 and stf14 run g_a, g_s1 and human_g_s2 (6
# attention, 9 GDN: 2 at 256 channels), stf12 g_a, g_s1, its two
# conditioning decoders once, its encoder tail and decoder head (9
# attention, 10 GDN); backward: the split decoder g_s1 / g_s2 feeds no loss
# term (machine_x_hat), so 6 (stf12: 7) GDN backward launches, 1 at 256
CRC_STEP = {
    "stf9": {"window_attention": 6, "gdn_forward": 9, "gdn_backward": 6,
             "rans_encode": 0, "rans_decode": 0},
    "stf12": {"window_attention": 9, "gdn_forward": 10, "gdn_backward": 7,
              "rans_encode": 0, "rans_decode": 0},
}
CRC_STEP["stf14"] = CRC_STEP["stf9"]
CRC_STEP_SHAPES = {
    "stf9": {"window_attention": {"D24": 1, "D32": 2, "D48": 3},
             "gdn": {"backward C192": 5, "backward C256": 1, "forward C192": 7,
                     "forward C256": 2}},
    "stf12": {"window_attention": {"D24": 1, "D32": 2, "D48": 5, "D96": 1},
              "gdn": {"backward C192": 6, "backward C256": 1, "forward C192": 8,
                      "forward C256": 2}},
}
CRC_STEP_SHAPES["stf14"] = CRC_STEP_SHAPES["stf9"]
# stf13 (phases 36-39): three layers, its machine and segmentation coders with
# LRP (3-conv context stacks), five MainCNNDecoders (g_s, seg_g_enc2, seg_g_s,
# human_g_enc2, human_g_enc4: attention at 48 and 32, IGDN at 192 twice and
# 256 once) and three ContextScale2 (seg_g_enc3, human_g_enc3, human_g_enc5:
# attention at 48, an IGDN at 192). A compress runs g_a, seg_g_enc2 and _enc3,
# seg_g_a2's block and the human layer's four conditioning decoders, and again
# the four for its debug reconstruction (the decoder's function); a
# decompress the four; neither runs g_s or seg_g_s. A training step's forward
# runs all of them once (the masks and conditioning signals once), its
# backward none of g_s or seg_g_s (no loss term reads machine_x_hat or
# seg_x_hat): 12 + 3 GDN backward launches
CRC_SIDE_LAUNCHES["stf13"] = {
    "compress": {24: 1, 48: 12, 32: 5, "gdn192": 18, "gdn256": 5},
    "decompress": {48: 4, 32: 2, "gdn192": 6, "gdn256": 2}}
CRC_STEP["stf13"] = {"window_attention": 16, "gdn_forward": 21, "gdn_backward": 15,
                     "rans_encode": 0, "rans_decode": 0}
CRC_STEP_SHAPES["stf13"] = {"window_attention": {"D24": 1, "D32": 5, "D48": 10},
                            "gdn": {"backward C192": 12, "backward C256": 3,
                                    "forward C192": 16, "forward C256": 5}}
# weights scaled after the seeded draw, by model: parameter -> factor. stf13's
# segmentation latent is small at untrained draws (at most 0.16-0.62 on
# narrow CPU twins, seeded or drawn at a reference's scale), so at narrow 0.2
# the seeded model codes no nonzero segmentation symbol, and with zero
# biases its mu and LRP are 0 too (JAX's init gives the same zero latent:
# tests/test_torch_crc.py). Its analysis's last convolution scaled by 16
# codes 4.3% of them nonzero and none escaped (crc_phase holds the count
# above 0); at 24 and 32 the untrained scales let 1,475 and 11,403 escape,
# 8 bytes each on the device wire, past its byte bar (PERF.md section 6;
# tools/torch_smoke_models.py --probe-gains)
CRC_GAIN = {"stf13": {"seg_g_a2.Conv_1.weight": 16.0}}
# host-clock calls whose median gives a CRC wire's img/s: one since the
# masked family's phases took the run near 1,000 s (before them, the median of 3)
CRC_REPS = 1
# the CRC models whose bfloat16 policy is held on the card (stf12 runs every
# CRC head width and both GDN widths; stf13 its two LRP coders and masks)
CRC_BF16 = ("stf12", "stf13")
# the CRC models served from a reference checkpoint
CRC_REFERENCE = ("stf9", "stf12", "stf13")
# the masked family (phases 40-45): stf3 and stf4 at their published width
# (stf's transforms; 8 slices of 48 in windows of 4 x 4: tokens of D = 768).
# Their decoder runs the whole context pass once a token, N passes a
# decompress (N = 512 an image at 512 px): stf3 serves 2 x 512^2, stf4,
# whose pass runs its conv heads over every token (~0.7 TFLOP at 256 px, 16x
# that at 512), 2 x 256^2. The codec's model: stf3 with its reference mask,
# stf4 with causal=True (its reference mask lets token 0 see every token);
# stf4 trains through its reference mask, as the JAX package trains it.
# stf2 (4 slices of 96 in windows of 8 x 8: tokens of D = 6144, 64 an image
# at 512 px) codes one step a token on both sides, O(N) work: 2 x 512^2
MASKED = ("stf3", "stf4", "stf2")
MASKED_SIZE = {"stf3": 512, "stf4": 256, "stf2": 512}
MASKED_CAUSAL = {"stf3": False, "stf4": True}
# stf2's codec narrows its symbols as the ChARM codecs do (Stf2Codec's
# ``narrow``: its decoder rebuilds y_hat from the coded symbols, so the
# context stays the encoder's), chosen on the CPU from the seeded weights on
# a 256 px image (tools/probe_stf2_narrow.py): at 1.0 37% of the y symbols
# are nonzero (up to 2), at 0.5 6.4% (up to 1), at 0.3 0.4%, at 0.2 none
STF2_NARROW = 0.5
# y and z scaled before rounding (Stf3Codec's latent_scale: the context reads
# the coded tokens, so no per-symbol narrowing can stand in), chosen on the
# CPU from the seeded weights on each phase's images so that some symbols are
# nonzero and none escapes: stf4 at 0.5 codes 6.5% of them nonzero, none
# escaped (0.7: 4 escapes a 2 x 256^2 batch). stf3's untrained context
# lifts any nonzero row to unit scale through its LayerNorms, so one nonzero
# token makes mu round to +-1..3 on a fifth of the later tokens, at scales
# that escape: at every latent scale up to 0.225 it codes only zeros, from
# 0.23 on 22-47% nonzero with 1-2.5% escaped (8 device-wire bytes each, past
# the byte bar). Its context stacks' MLP outputs scaled by 0.25
# (MASKED_GAIN) at 0.3: 0.49% nonzero, mu among them, none escaped
MASKED_LATENT_SCALE = {"stf3": 0.3, "stf4": 0.5}
MASKED_GAIN = {"stf3": {f"maskedContextModel_{s}.Dense_{2 * i + 1}.weight": 0.25
                        for s in ("mu", "sigma") for i in range(5)}}
# the end-to-end bfloat16 measures a masked model's phase 8 logs without
# holding them. stf3's y likelihoods: its seeded context lifts any changed
# token to unit scale through its LayerNorms, so one y element rounded the
# other way (an ulp of a bfloat16 y) moves mu and scale of every later
# token: card against CPU both under the policy 13.6% of its y likelihoods
# moved by more than 1e-3 on 64 x 64, and the card's bfloat16 against the
# CPU's float32 12.7% (on an H100 80GB HBM3 at 700 W), so the bar cannot tell a
# broken path from the policy there. The layer replay holds every layer
MASKED_BF16_UNHELD = {"stf3": ("y_likelihood_share",)}
# the sides whose device idle share and ATen calls a masked phase reads from
# one profiled call, on its host wire and its bfloat16 device wire (the f32
# device wire profiles both): a stf3 decompress runs ~400,000 operators and
# profiling one takes ~12 s, so its host wire's and its bf16 decompress are
# timed by the host clock alone
SIDES = ("compress", "decompress")
MASKED_PROFILED = {"stf3": ("compress",)}
# czigzag (phases 49-52), the cross-attention conditional codec at its
# published width (embed 48, depths 2/2/6/2, M 384, 16 zigzag steps of 96),
# on phase 5's images and their up_x4 (conditioning_image). Window attention
# by head width: 16 in every analysis and synthesis block (12 each), 96 in
# the 384-channel hyper stacks (hyper_enc0 2 blocks, hyper_dec_mean1 and
# _scale1 6 each), 48 in the 192-channel ones (hyper_enc1 6, hyper_dec_*0 2
# each), all at window 4. A compress with its debug reconstruction runs the
# analysis, both hyper stacks and the synthesis; a decompress the hyper
# decoders and the synthesis; a training step's forward all of them (its
# backward differentiates the plain attention). No GDN
CZIGZAG_SIDE_LAUNCHES = {"compress": {16: 24, 48: 10, 96: 14},
                         "decompress": {16: 12, 48: 4, 96: 12}}
CZIGZAG_STEP_LAUNCHES = CZIGZAG_SIDE_LAUNCHES["compress"]
# the codecs' narrowing, chosen on the CPU from the seeded weights on phase
# 5's images and up_x4 (tools/probe_czigzag_narrow.py)
CZIGZAG_NARROW = 0.5
# cnn2 (phases 18a-18c): WACNN2, cnn's codec with a RetinaNet-ResNet-50
# student (P3-P7, 9 anchors x 80 classes) detecting on the decoded image.
# Its codec weights from one seed are cnn's (the student is drawn after
# them), and its wires are cnn's code, so its blobs and launch counts are
# held equal to cnn's (phases 7, 7a, 7b and 18); the student's convolutions
# are cuDNN's and launch no kernel of the port. Seeded, the codec decodes a
# faint x_hat (phase 5's images at narrow 0.2: mean 3e-4, max 0.016), on
# which the student's logits stay at the focal-loss prior and no score
# passes the 0.05 detection threshold. Without biases (BatchNorm at its
# init) the seeded student is positively homogeneous, so its stem kernel
# x64 shows it x_hat at an image's scale, and its classification kernel x16
# spreads the logits: on the CPU from the device wire's x_hat of phase 5's
# images, 1.1% of the scores pass and NMS keeps 11,000-17,000 detections an
# image
CNN2_GAIN = {"studentNet.backbone.Conv_0.weight": 64.0,
             "studentNet.classification.output.weight": 16.0}
# the student on the card against its CPU twin on the same x_hat: its
# classification and regression maps, max |card - cpu| relative to the
# CPU map's max (float32 on both, ~70 convolutions summed in other orders)
CNN2_STUDENT_TOL = 1e-4
# steps of each side timed, in turns, for the unread student's cost in a
# training step (step_with_without_student)
CNN2_AB_TURNS = 4


def crc_step_shapes(name: str, dtype: str = "float32") -> dict:
    """CRC_STEP_SHAPES of ``name`` keyed as ``shape_counts`` gives them."""
    return {"window_attention": {f"{dtype} {k}": n
                                 for k, n in CRC_STEP_SHAPES[name]["window_attention"].items()},
            "gdn": {f"{k.split()[0]} {dtype} {k.split()[1]}": n
                    for k, n in CRC_STEP_SHAPES[name]["gdn"].items()}}


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
    # the CRC family's widths (CRC_ATTENTION_SHAPES), at the shifted
    # blocks' 4 classes and at 1, then a ragged window count of each
    cases += [("crc", W, 8, N, D, n_cls) for D, (W, N) in CRC_ATTENTION_SHAPES.items()
              for n_cls in (4, 1)]
    cases += [("crc", 100, 8, 64, 32, 4), ("crc", 37, 8, 16, 48, 4), ("crc", 37, 8, 16, 96, 4)]
    # czigzag's hyper stacks: 192 and 384 channels at 4 heads (head widths 48
    # and 96), 2 x 32 x 32 at window 4: 128 windows, the shifted blocks' 4
    # classes and the unshifted one's (its D 16 blocks are stf's shapes)
    cases += [("czigzag", 128, 4, 16, D, n_cls) for D in (48, 96) for n_cls in (4, 1)]
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
                ms=cuda_ms(lambda: twa.window_attention_cuda(*ins), ATTENTION_ITERS),
                plain_ms=cuda_ms(lambda: twa.window_attention_reference(*ins), ATTENTION_ITERS),
                library_ms=cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                    ATTENTION_ITERS),
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


# (path, B, C, H, W): the GDN layers of the training step (8 x 256 px)
# and of compress/decompress (2 x 512 px), then a ragged row count
GDN_CASES = [("train", 8, 192, s, s) for s in (128, 64, 32)]
GDN_CASES += [("serve", 2, 192, s, s) for s in (256, 128, 64)]
GDN_CASES.append(("ragged", 3, 192, 13, 21))  # 273 pixels, 9 tiles of 32
# the CRC family's 256-channel IGDN (MainCNNDecoder's): serving 2 x 512^2,
# training 8 x 256^2
GDN_C256_CASES = [("crc_serve", 2, 256, 128, 128), ("crc_train", 8, 256, 64, 64)]
GDN_CASES += GDN_C256_CASES
# 512 channels, the kernels' widest (MAX_CHANNELS), which no model uses:
# gdn_fwd_kernel_fma and gdn_bwd_kernel_dx_streamed
GDN_CASES.append(("wide", 2, 512, 64, 64))


def gdn_kernel_split(fn, reps: int = 10) -> dict:
    """Device ms of each GDN kernel one call of ``fn`` launches, by the
    kernel's function name (``gdn_bwd_kernel_dx_cluster``, ...): the
    kernels' durations in one traced run of ``reps`` calls, summed by name
    and divided by ``reps``."""
    split: dict = {}
    events = marked_events(profile_session(lambda: [fn() for _ in range(reps)]))
    for a, b, name in card_spans(events, kernels_only=True):
        found = re.search(r"gdn_\w+", name)
        if found:
            split[found.group(0)] = split.get(found.group(0), 0.0) + (b - a) / 1e6 / reps
    return split


def check_gdn(tgdn, cases=GDN_CASES, split_all: bool = False):
    """Phase 4: the GDN kernels vs their plain versions at ``cases``,
    float32 and then bfloat16; the backward above 192 channels (with
    ``split_all`` at every case) also split into its kernels. -> rows."""
    import torch

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
            if C > 192 or split_all:
                row["backward"]["split_ms"] = gdn_kernel_split(
                    lambda: tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse))
                log(f"  gdn {dtype} backward split {B}x{C}x{H}x{W} inverse={inverse}: "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in row["backward"]["split_ms"].items()))
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
            # the plain version (host-bound, 0.1-0.4 s a call) once: its
            # measured call holds the card for four times its host time
            row[part] = dict(ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=1), bound_ms=ms,
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


def profile_session(fn):
    """One profiler session (CPU and CUDA) around one call of ``fn`` on the
    card. The profiler has lost the first records of a session (late in a
    long run, the first 14-15 kernels of a traced call, launch by launch as
    in a graph replay), so the session first runs TRACE_WARMUP_KERNELS tiny
    kernels and waits for them, then calls ``fn`` under the marker
    TRACE_MARK. -> the profiler."""
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
    return prof


def marked_events(prof) -> list:
    """The events of a ``profile_session`` from the call's marker on, read
    from the profiler's own records (name, start_ns, duration_ns,
    device_type) without a chrome-trace export: a masked-family decompress
    runs ~400,000 operators and as many kernels, whose trace takes the
    better part of a minute to write and read
    (tests/test_torch_cuda.py::test_profiler_events_read_what_the_trace_export_reads
    holds the two readings equal)."""
    events = prof.profiler.kineto_results.events()
    start = min(e.start_ns() for e in events if e.name() == TRACE_MARK)
    return [e for e in events if e.start_ns() >= start]


def card_spans(events, kernels_only: bool = False) -> list:
    """(start ns, end ns, name) of the card's events among ``events``, in
    time order: its kernels, copies and memsets (``kernels_only``: its
    kernels), without the marker's span on the card's timeline."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CUDA and e.name() != TRACE_MARK
                  and not (kernels_only and e.name().startswith(("Memcpy", "Memset"))))


def profiled_call(fn) -> tuple:
    """(ATen operator calls, device busy ms) of one call of ``fn`` from one
    ``profile_session``: the ATen calls as ``key_averages`` counts them
    (without ATEN_UNCOUNTED); busy is the length of the union of the card's
    kernel, copy and memset intervals."""
    from torch.autograd import DeviceType

    events = marked_events(profile_session(fn))
    aten = sum(1 for e in events if e.device_type() == DeviceType.CPU
               and e.name().startswith("aten::") and e.name() not in ATEN_UNCOUNTED)
    busy_ns, end = 0, float("-inf")
    for a, b, _ in card_spans(events):
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
    return aten, busy_ns / 1e6


def idle_shares(codec, x, enc_s, dec_s) -> dict:
    """Each side's device busy ms (one profiled call) and idle share against
    the median untraced wall time ``enc_s`` / ``dec_s``."""
    enc = codec.compress(x)
    out = {}
    for side, fn, walls in (("compress", lambda: codec.compress(x), enc_s),
                            ("decompress", lambda: codec.decompress(enc["strings"], enc["shape"]),
                             dec_s)):
        _, busy = profiled_call(fn)
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
                    reps: int = 3, idle: bool = True):
    """Phases 5 and 11: compress -> decompress on the host wire, the
    launch counts zeroed right before and read right after each side and
    held to ``expect[side]``; img/s the median of ``reps`` calls; with
    ``idle``, each side's device idle share (one profiled call). ->
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
        device=idle_shares(codec, x, enc_s, dec_s) if idle else "not measured",
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


def blob_sha256(enc) -> dict:
    """The sha256 of an encoder output's y and z blobs, each stream's
    blobs joined."""
    return {name: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
            for k, name in enumerate("yz")}


def device_wire_phase(codec, host_enc, x, card: str, zero_counts, read_counts,
                      expect: dict, reps: int = 3, idle: bool = True):
    """Phases 7 and 13: compress -> decompress on the device wire, the
    launch counts held to ``expect[side]``, img/s the median of ``reps``
    calls, with ``idle`` each side's device idle share; -> results."""
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
    sha = blob_sha256(enc)
    log(f"  launches: compress {enc_launches}, decompress {dec_launches}; host round "
        f"trips in decompress: {len(syncs)}; blobs' sha256 {sha}")
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
        blob_sha256=sha,
        device=idle_shares(codec, x, enc_s, dec_s) if idle else "not measured")
    log(f"  bytes {stream_bytes}; bpp {[round(b, 4) for b in bpp]}, PSNR "
        f"{[round(p, 2) for p in psnr]} dB, encode {result['encode_img_per_s']:.2f} img/s, "
        f"decode {result['decode_img_per_s']:.2f} img/s (median of {reps}, batch {B}, {card}); "
        f"device {result['device']}")
    return result, enc_launches, dec_launches


def traced_kernels(fn, last: int = 0):
    """The names of the kernels one traced call of ``fn`` ran, counted;
    with ``last``, also the names of its last ``last`` kernels in time
    order."""
    kernels = [name for _, _, name in card_spans(marked_events(profile_session(fn)),
                                                 kernels_only=True)]
    names: dict = {}
    for name in kernels:
        names[name] = names.get(name, 0) + 1
    return (names, [n[:60] for n in kernels[-last:]]) if last else names


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
                    dev_counts: dict, reps: int = 3, serve=None,
                    idle_wires=("graphed", "launches", "device_wire")):
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
    each side's device idle share on ``idle_wires``. ``serve``: called with
    the graphed codec
    and its encoder output after these checks, its result kept under
    "serve". -> (results, compress and decompress counts)."""
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

    serving = {"serve": serve(codec, enc)} if serve else {}

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
                           device=(idle_shares(c, x, enc_s, dec_s) if wire in idle_wires
                                   else "not measured"))
    log("  encode / decode img/s (median of {}, batch {}, {}): {}; device idle {}".format(
        reps, B, card, {w: f"{t['encode_img_per_s']:.2f} / {t['decode_img_per_s']:.2f}"
                  for w, t in times.items()},
        {w: f"{t['device']['compress']['device_idle_share']:.3f} / "
            f"{t['device']['decompress']['device_idle_share']:.3f}"
         for w, t in times.items() if w in idle_wires}))
    bpp = [8 * (len(y) + len(z)) / (size * size) for y, z in zip(*enc["strings"])]
    result = dict(
        images=B, size=size, lanes_per_image=1024, bpp=bpp, tier=tiers,
        stream_bytes=stream_bytes, y_hat_vs_device_wire=vs_device,
        first_call_s=first_s, capture_s=capture_s, pool_bytes=pool_bytes, graphs=graphs,
        launches_per_replay=per_replay, host_round_trips_in_decompress=0,
        launches_compress=enc_launches, launches_decompress=dec_launches,
        blob_sha256=blob_sha256(enc), **serving,
        **times["graphed"], launch_by_launch=times["launches"], device_wire=times["device_wire"])
    del codec, plain
    torch.cuda.empty_cache()
    return result, enc_launches, dec_launches


def bf16_serving_phase(codec, dev_codec, x, card, f32: dict, reps: int = 3, idle: bool = True):
    """Phases 7b and 17: compress -> decompress under the bfloat16 policy on
    the host wire and the device wire, held as the float32 phases are and
    to their launch counts, every launch the bfloat16 build's (``f32``: the
    float32 phases' results, encoder output and counts), then to
    tests/test_bf16.py's bars against them; ``idle``: each side's device
    idle share too. -> (results, the launch counts of each side)."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    counts = f32["counts"]
    zero_counts, read_counts = launch_counts("bfloat16")
    set_activation_dtype(torch.bfloat16)  # read at forward time; both sides
    try:
        result, enc, enc_l, dec_l = host_wire_phase(
            codec, x, card, zero_counts, read_counts,
            {"compress": counts["compress"], "decompress": counts["decompress"]}, reps, idle)
        result["device_wire"], dev_enc_l, dev_dec_l = device_wire_phase(
            dev_codec, enc, x, card, zero_counts, read_counts,
            {"compress": counts["device_compress"], "decompress": counts["device_decompress"]},
            reps, idle)
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
    def batch(seed_):  # the images, or a conditional model's (x, up_x4)
        args = model_args(model, make_images(seed_, B, size))
        return args if len(args) > 1 else args[0]

    batches = [batch(seed + 100 + i) for i in range(steps + resumed_steps)]
    eval_batch = batch(seed + 99)
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
        still = [n for n in before if n not in moved and not n.startswith(fixed or ("\0",))]
        raise AssertionError(f"{len(before) - len(moved)} of {len(before)} parameters did not "
                             f"move, {len([n for n in moved if n.startswith(fixed)])} fixed moved; "
                             f"unfixed that did not: {still[:8]}")
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
                     f32_train: dict, steps: int = 3, **train_kw):
    """Phases 10b, 17 and 34: ``train_phase`` under the bfloat16 policy from
    the weights ``init_state`` the float32 phase started from, on its
    batches and noise (``train_kw``: its criterion and fixed parameters):
    each step's launches exactly ``expect``, all of them the bfloat16
    builds'; the gradients float32 on the float32 masters; the first
    step's bpp within BF16_BPP_RTOL of the float32 phase's first. ->
    results."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    model.load_state_dict(init_state)
    set_activation_dtype(torch.bfloat16)
    try:
        result = train_phase(model, seed, card, expect, steps=steps, resumed_steps=0,
                             dtype="bfloat16", **train_kw)
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


def conditioning_image(x):
    """czigzag's up_x4 for the images x (B, H, W, 3), a tensor (on any
    device) or an array, returned as the same: x average-pooled by 4, then
    bilinearly upsampled back. A seeded, deterministic stand-in for the
    reference's base-layer reconstruction (a GAN-upsampled low-rate image);
    the same tensor goes to both coder sides."""
    import torch
    import torch.nn.functional as F

    t = torch.as_tensor(x).permute(0, 3, 1, 2)
    up = F.interpolate(F.avg_pool2d(t, 4), scale_factor=4, mode="bilinear", align_corners=False)
    up = up.permute(0, 2, 3, 1).contiguous()
    return up if isinstance(x, torch.Tensor) else up.numpy()


def model_args(model, x) -> tuple:
    """The positional inputs of ``model``'s forward for the images x: (x,),
    or a conditional model's (x, up_x4) (``conditioning_image``)."""
    return (x, conditioning_image(x)) if getattr(model, "conditioning_inputs", 0) else (x,)


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
        out = m(*model_args(m, x), generator=torch.Generator().manual_seed(seed))
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
            model(*model_args(model, x.cuda()))
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


def eval_vs_cpu_phase(name: str, model, seed: int, cpu_model=None, unheld: tuple = ()):
    """Phases 8, 14 and 34: the same weights' eval forward on the card
    against the plain CPU path on a small input, in float32, then under the
    bfloat16 policy on both sides end to end (BF16_EVAL_TOL but its
    ``unheld`` measures, which are logged; beside it the card's bfloat16
    against the CPU's float32) and layer by layer (BF16_LAYER_TOL, with its
    control); ``cpu_model``: the CPU twin, by default one drawn and loaded.
    -> the differences."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.nn import set_activation_dtype

    xs = torch.from_numpy(make_images(seed + 1, 1, 64))
    if cpu_model is None:
        cpu_model = create_model(name, device="cpu", seed=seed)
        cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = cpu_model(*model_args(cpu_model, xs))
        got = model(*model_args(model, xs.cuda()))
        set_activation_dtype(torch.bfloat16)
        try:
            ref16 = cpu_model(*model_args(cpu_model, xs))
            got16 = model(*model_args(model, xs.cuda()))
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
            bf16[k] > tol for k, tol in BF16_EVAL_TOL.items() if k not in unheld):
        raise AssertionError(f"card and CPU disagree under the bf16 policy: {bf16}")
    layers = bf16_layer_replay(model, cpu_model, xs)
    log(f"  bf16 layer by layer ({name}): {layers}; bars {BF16_LAYER_TOL}")
    for kind, row in layers.items():
        if row["share"] > BF16_LAYER_TOL["share"] or row["relative"] > BF16_LAYER_TOL["relative"]:
            raise AssertionError(f"{kind}: card and CPU disagree under the bf16 policy: {row}")
        if not row["control_share"] > BF16_LAYER_TOL["share"]:
            raise AssertionError(f"{kind}: the bar cannot tell bf16 from f32: {row}")
    return {"f32_max_abs": worst, "bf16": bf16, "bf16_card_against_f32_cpu": against_f32,
            "bf16_tolerance": {k: v for k, v in BF16_EVAL_TOL.items() if k not in unheld},
            "bf16_unheld": list(unheld), "bf16_layers": layers,
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


def stored_wacnn_tables(sd: dict, model):
    """``model``'s own tables (WACNN's bottleneck and Gaussian) written into
    the reference dict ``sd`` as the reference's CDF buffers
    (``module.entropy_bottleneck._quantized_cdf`` ...) and read back by
    ``zoo.import_reference_tables``, held equal. -> the imported tables."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import build_codec_tables

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
    return imported


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
    from icm_tpu_torch.models import CharmCodec, create_model

    t = time.time()
    sd = reference_wacnn_state_dict(seed)
    model = create_model("cnn", seed=seed)
    model.load_state_dict(zoo.convert_reference_state_dict("cnn", sd), strict=True)
    imported = stored_wacnn_tables(sd, model)
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
    result.update(tensors=len(sd), blob_sha256=blob_sha256(enc))
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
                                                FAMILY_REPS, idle=False)
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
    the refiners) and no other kernel: ``TRAIN_STEPS`` steps through the
    registry's unrolled forward (``tools/train.py``'s default), then as many
    through the
    ``scan_charm=True`` forward at the preset's stochastic depth (0.2, the
    refiners' too); one ``scan_charm`` step card against CPU at depth 0
    (phase 16's rule); then ``TRAIN_STEPS`` bfloat16 steps of the unrolled
    forward from
    the weights the first f32 step started from (phase 17's checks).
    -> results; the per-step launches by forward and dtype under
    "launches"."""
    model = fam["model"]
    expect = {"window_attention": fam["transforms"]["compress"] + fam["result"]["swin_blocks"][
        "refiners"], "gdn_forward": 0, "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0}
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    with Phase(f"full-width {name} training, unrolled forward"):
        out["unrolled"] = train_phase(model, seed, card, expect, steps=TRAIN_STEPS,
                                      resumed_steps=0)
    with Phase(f"full-width {name} training, scan_charm forward (stochastic depth 0.2)"):
        model.scan_charm = True
        try:
            out["scan_charm"] = train_phase(model, seed, card, expect, steps=TRAIN_STEPS,
                                            resumed_steps=0)
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
        out["bf16"] = bf16_train_phase(model, init_state, seed, card, expect, out["unrolled"],
                                       steps=TRAIN_STEPS)
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


def crc_expect(name: str, side: str, dtype: str = "float32", **rans) -> tuple:
    """(the launch counts of one side of a CRC model, by kernel; by shape,
    as ``shape_counts`` gives them), in ``dtype``'s builds."""
    per = CRC_SIDE_LAUNCHES[name][side]
    attn = {f"{dtype} D{d}": per[d] for d in (24, 48, 32, 96) if per.get(d)}
    gdn = {f"forward {dtype} C{c}": per[f"gdn{c}"] for c in (192, 256) if per.get(f"gdn{c}")}
    counts = {"window_attention": sum(attn.values()), "gdn_forward": sum(gdn.values()),
              "gdn_backward": 0, "rans_encode": 0, "rans_decode": 0, **rans}
    return counts, {"window_attention": attn, "gdn": gdn}


def crc_codec(model, **kw):
    """The codec of a CRC model: ``CRC3Codec`` for stf13's class, else
    ``CRCCodec``."""
    from icm_tpu_torch.models.crc import ConditionalResidualCoding3
    from icm_tpu_torch.models.crc_codec import CRC3Codec, CRCCodec

    return (CRC3Codec if isinstance(model, ConditionalResidualCoding3) else CRCCodec)(model,
                                                                                     **kw)


def crc_loss(model):
    """(RateDistortionLoss over every layer's rates, the prefixes of the
    parameters no loss term reaches) of a CRC model."""
    from icm_tpu_torch.train import RateDistortionLoss

    return RateDistortionLoss(0.01, likelihood_keys=model.likelihood_keys), model.no_loss


def codec_dec_args(codec, enc) -> list:
    """A compress's output -> ``codec``'s decompress arguments: its streams,
    then ``codec.DECOMPRESS_KEYS``."""
    return [enc["strings"], *[enc[k] for k in codec.DECOMPRESS_KEYS]]


def codec_side_runs(codec, x, enc):
    """(compress, decompress) of ``codec`` as argument-free calls."""
    return (lambda: codec.compress(x), lambda: codec.decompress(*codec_dec_args(codec, enc)))


def codec_timing(codec, x, enc, reps: int = 3, profiled=("compress", "decompress")) -> dict:
    """img/s of each side (median of ``reps`` host-clock calls ending in a
    synchronize), and for the sides in ``profiled`` its device busy ms and
    idle share and its ATen calls (one profiled call, ``profiled_call``)."""
    import torch

    B = x.shape[0]
    out = {}
    for side, fn in zip(("compress", "decompress"), codec_side_runs(codec, x, enc)):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            walls.append(time.time() - t)
        wall = float(np.median(walls))
        out[side] = dict(img_per_s=B / wall, wall_ms=1e3 * wall)
        if side in profiled:
            aten, busy = profiled_call(fn)
            out[side].update(device_busy_ms=busy, aten_calls=aten,
                             device_idle_share=max(0.0, 1.0 - busy / (1e3 * wall)))
        else:
            out[side].update(device_busy_ms=None, device_idle_share=None, aten_calls=None)
    return out


def timing_text(side: dict) -> str:
    """One side of ``codec_timing`` for the log."""
    if side["aten_calls"] is None:
        return f"{side['img_per_s']:.3f} img/s (not profiled)"
    return (f"{side['img_per_s']:.3f} img/s idle {side['device_idle_share']:.3f} "
            f"{side['aten_calls']} ATen")


def codec_roundtrip(codec, x, zero_counts, read_counts, what: str, expect: dict):
    """compress (debug) -> decompress of ``codec``, the launch counts zeroed
    right before and read right after each side and held to ``expect[side]``
    (kernel counts, shape counts); decompress watched for host round trips
    (``torch.cuda.set_sync_debug_mode``) off the host wire. Holds the
    codec's latents (``LATENT_KEYS``: y_hat, stf13's seg_y_hat too)
    bit-exact and the decoder's x_hat equal to the encoder's, finite and of
    the images' shape. -> (enc, dec, counts by side, shape counts by side,
    host round trips in decompress)."""
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
            dec = codec.decompress(*codec_dec_args(codec, enc))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message).splitlines()[0] for c in caught if "synchroniz" in str(c.message)]
    torch.cuda.synchronize()
    counts["decompress"], shapes["decompress"] = read_counts(), shape_counts()
    log(f"  {what}: launches {counts}; by shape {shapes}"
        + (f"; host round trips in decompress: {len(syncs)}" if watch else ""))
    if syncs:
        raise AssertionError(f"{what}: decompress waited for the card: {syncs[:3]}")
    for k in codec.LATENT_KEYS + ("x_hat",):
        if not torch.equal(dec[k], enc[k]):
            raise AssertionError(f"{what}: the decoder's {k} differs from the encoder's")
    if dec["x_hat"].shape != x.shape or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"{what}: bad x_hat {tuple(dec['x_hat'].shape)}")
    for side in counts:
        check_launches(f"{what}, {side}", counts[side], expect[side][0])
        if shapes[side] != expect[side][1]:
            raise AssertionError(f"{what}, {side}: launches by shape {shapes[side]}, expected "
                                 f"{expect[side][1]}")
    return enc, dec, counts, shapes, len(syncs)


def wire_escapes(blobs) -> int:
    """Escaped symbols in a stream's device- or scan-wire blobs (the
    header's n_esc; each costs 8 bytes: its position and raw value)."""
    from icm_tpu_torch.coding.wire import WIRE_SCAN

    return sum(struct.unpack_from("<I", b, (5 if b[3] == WIRE_SCAN else 4) + 8)[0]
               for b in blobs)


def crc_bytes(enc, size: int, streams) -> dict:
    """Each stream's bytes (``streams``: the codec's names) and each image's
    bpp."""
    per = {name: sum(len(b) for b in enc["strings"][k]) for k, name in enumerate(streams)}
    B = len(enc["strings"][0])
    return {"bytes": per, "bpp": [8 * sum(len(s[b]) for s in enc["strings"]) / (size * size)
                                  for b in range(B)]}


def crc_stream_bytes(model, dev, enc, denc, size: int) -> dict:
    """Each stream's bytes on the device wire (``dev``'s compress ``denc``)
    against the host wire's (``enc``), its lanes (a zigzag layer's y and z,
    then the human y and z), its escapes and its limit: the host wire's x
    1.02 plus each lane's flushed state and length and the header."""
    B, h, kit = len(enc["strings"][0]), size // 16, dev.kit
    ebs = [get(model).entropy_bottleneck for *_, get in dev.LAYERS]
    lanes = {}
    for (y_name, z_name), eb in zip(zip(dev.STREAMS[::2], dev.STREAMS[1::2]),
                                    ebs + [model.human_hyper.entropy_bottleneck]):
        lanes[y_name] = kit.n_lanes(h, h) if y_name == "human_y" else kit.n_lanes(h // 2, h // 2)
        lanes[z_name] = (size // 64) ** 2 * kit.z_groups(eb.channels)
    host_b = crc_bytes(enc, size, dev.STREAMS)["bytes"]
    dev_b = crc_bytes(denc, size, dev.STREAMS)["bytes"]
    return {k: dict(device=dev_b[k], host=host_b[k], lanes=lanes[k],
                    escapes=wire_escapes(denc["strings"][dev.STREAMS.index(k)]),
                    limit=host_b[k] * 1.02 + B * (lanes[k] * 8 + 16)) for k in lanes}


def crc_eval_vs_cpu(name: str, model, seed: int) -> dict:
    """The eval forward on the card against the plain CPU path, the same
    weights, one 256 x 256 image: each reconstruction (x_hat,
    machine_x_hat; stf13's seg_x_hat) and each layer's y likelihoods within
    1e-3."""
    import torch

    from icm_tpu_torch.data import make_images

    cpu_model = cpu_twin(name, model)
    xs = torch.from_numpy(make_images(seed + 1, 1, 256))
    t = time.time()
    with torch.no_grad():
        ref = cpu_model(xs)
        cpu_s = time.time() - t
        got = model(xs.cuda())
    held = ([(k, k, None) for k in ("x_hat", "machine_x_hat", "seg_x_hat") if k in ref]
            + [(f"{k.split('_')[0] if '_' in k else 'human'} y likelihoods", k, "y")
               for k in model.likelihood_keys])
    worst = {key: (got[a][b] if b else got[a]).cpu().sub(ref[a][b] if b else ref[a]).abs()
             .max().item() for key, a, b in held + [("human z likelihoods", "likelihoods", "z")]}
    log(f"  max |card - cpu| ({name}, 256 x 256; the CPU side {cpu_s:.1f}s): {worst}")
    if not all(worst[k] <= 1e-3 for k, _, _ in held):
        raise AssertionError(f"card and CPU disagree: {worst}")
    del cpu_model
    gc.collect()
    return {"size": 256, "f32_max_abs": worst, "tolerance": 1e-3, "cpu_s": cpu_s}


def crc_phase(name: str, x, card: str, zero_counts, read_counts, seed: int) -> dict:
    """Phases 27-28, 32 and 36: a CRC model (stf9, stf14, stf12, stf13) at
    its published full width, weights from ``seed`` (scaled as CRC_GAIN
    says), on the images of phase 5 at ``narrow=0.2``: each zigzag layer's
    nonzero y symbols counted on the host wire's chain (``symbols``) and
    held above 0, so that no wire's check compares a latent made of its
    context alone; compress -> decompress on the host wire, the device wire
    and the scan wire (graphed and launch by launch), each held by
    ``codec_roundtrip`` with the launches of CRC_SIDE_LAUNCHES (window
    attention by head width, GDN by channels; the device and scan wires: 2
    encode launches a zigzag layer and 2 for the human layer, ctx_slices +
    1 decode launches a zigzag layer and 2: 4 and 27, stf13 6 and 52); the
    device wire's latents and x_hat equal to the host wire's and each
    stream's bytes within the host wire's x 1.02 plus each lane's flush and
    header; the scan wire's graphs held as phase 7a's (``graph_replays``:
    a chain graph each way for each zigzag layer), its blobs and bits
    equal to launch by launch, its latents within JAX's bar of the device
    wire's, and the bf16 policy refused; each side's img/s (the median of
    CRC_REPS calls), device idle share and ATen calls on each wire; then
    the eval forward against the CPU's. -> {model, result, counts}."""
    import torch

    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.nn import set_activation_dtype

    B, size = x.shape[0], x.shape[1]
    t = time.time()
    model = create_model(name, seed=seed)
    with torch.no_grad():
        for pname, gain in CRC_GAIN.get(name, {}).items():
            model.get_parameter(pname).mul_(gain)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    codec = crc_codec(model, narrow=0.2)
    coders = [layer[3](model) for layer in codec.LAYERS]
    c = coders[0]
    log(f"  {name}: {n_params / 1e6:.1f} M parameters in {time.time() - t:.1f}s; "
        f"{len(coders)} zigzag coder(s) of {c.ctx_slices} slices of {c.slice_ch} channels, "
        f"support {c.max_support}, conditioning window {c.cond_blocks}, LRP {c.apply_lrp}; "
        f"scaled {CRC_GAIN.get(name, {})}")
    n_layers = len(coders)
    host_expect = {side: crc_expect(name, side) for side in ("compress", "decompress")}
    dev_expect = {"compress": crc_expect(name, "compress", rans_encode=2 * n_layers + 2),
                  "decompress": crc_expect(name, "decompress",
                                           rans_decode=n_layers * (c.ctx_slices + 1) + 2)}
    symbols = {k: [sum(int(s.count_nonzero()) for s in syms), sum(s.numel() for s in syms)]
               for k, syms in codec.symbols(x).items()}
    log(f"  {name}: nonzero y symbols of each zigzag layer, of all: {symbols}")
    if not all(n for n, _ in symbols.values()):
        raise AssertionError(f"{name}: a zigzag layer codes only zero symbols: {symbols}")
    result = {"params": n_params, "ctx_slices": c.ctx_slices, "slice_channels": c.slice_ch,
              "zigzag_layers": n_layers, "lrp": c.apply_lrp, "gain": CRC_GAIN.get(name, {}),
              "nonzero_y_symbols": symbols}
    counts = {}

    enc, _, l, sh, _ = codec_roundtrip(codec, x, zero_counts, read_counts,
                                     f"{name} host wire", host_expect)
    counts.update(launches_compress=l["compress"], launches_decompress=l["decompress"])
    result["host_wire"] = {**crc_bytes(enc, size, codec.STREAMS), "launches": l,
                           "launches_by_shape": sh, **codec_timing(codec, x, enc, CRC_REPS)}

    dev = crc_codec(model, narrow=0.2, wire="device")
    denc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts,
                                          f"{name} device wire", dev_expect)
    counts.update(launches_device_wire_compress=l["compress"],
                  launches_device_wire_decompress=l["decompress"])
    for k in codec.LATENT_KEYS + ("x_hat",):
        if not torch.equal(denc[k], enc[k]):
            raise AssertionError(f"{name}: the device wire's {k} differs from the host's")
    stream_bytes = crc_stream_bytes(model, dev, enc, denc, size)
    log(f"  {name} device wire bytes {stream_bytes}")
    for k, v in stream_bytes.items():
        if v["device"] > v["limit"]:
            raise AssertionError(f"{name} device wire {k}: {v['device']} bytes over {v['limit']}")
    result["device_wire"] = {**crc_bytes(denc, size, dev.STREAMS), "stream_bytes": stream_bytes,
                             "launches": l, "launches_by_shape": sh,
                             "host_round_trips_in_decompress": syncs,
                             **codec_timing(dev, x, denc, CRC_REPS)}

    scan = crc_codec(model, narrow=0.2, wire="device", scan_wire=True)
    t = time.time()
    first = scan.compress(x, return_debug=True)
    scan.decompress(*codec_dec_args(scan, first))
    torch.cuda.synchronize()
    first_s = time.time() - t
    stats = scan.graphs.stats()
    graphs = {" ".join(str(p) for p in key): st for key, st in stats.items()}
    capture_s = sum(st["capture_s"] for st in stats.values())
    pool_bytes = sum(st["pool_bytes"] for st in stats.values())
    log(f"  {name} scan wire: first compress + decompress {first_s:.2f}s, captures "
        f"{capture_s:.2f}s of it, pools {pool_bytes / 2**20:.1f} MiB, {len(graphs)} graphs")
    senc, sdec, l, sh, syncs = codec_roundtrip(scan, x, zero_counts, read_counts,
                                             f"{name} scan wire", dev_expect)
    counts.update(launches_scan_wire_compress=l["compress"],
                  launches_scan_wire_decompress=l["decompress"])
    chains = {k for k in scan.graphs.graphs() if k[0] == "scan"}
    if len(chains) != 2 * n_layers:
        raise AssertionError(f"{name} scan wire: chain graphs {sorted(map(str, chains))}, "
                             f"expected an encode and a decode one for each of {n_layers} layers")
    per_replay = graph_replays(scan, c.ctx_slices)
    plain = crc_codec(model, narrow=0.2, wire="device", scan_wire=True, cuda_graphs=False)
    penc = plain.compress(x, return_debug=True)
    pdec = plain.decompress(*codec_dec_args(plain, senc))
    if penc["strings"] != senc["strings"]:
        raise AssertionError(f"{name} scan wire: graphed blobs differ from launch by launch")
    for got, want, what in ((penc, senc, "compress"), (pdec, sdec, "decompress")):
        for k in scan.LATENT_KEYS + ("x_hat",):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{name} scan wire: graphed {what} {k} differs from launch "
                                     "by launch")
    vs_device = {}
    for k in scan.LATENT_KEYS:
        d = (senc[k] - enc[k]).abs()
        vs_device[k] = v = {"share_above_1e-2": float((d > 1e-2).float().mean()),
                            "median": float(d.median()), "max": float(d.max())}
        log(f"  {name} scan wire {k} against the device wire's: {v} (bars {SCAN_VS_DEVICE})")
        if not (v["share_above_1e-2"] < SCAN_VS_DEVICE["share_above_1e-2"]
                and v["median"] < SCAN_VS_DEVICE["median"]):
            raise AssertionError(f"{name} scan wire {k} strays from the device wire's: {v}")
    set_activation_dtype(torch.bfloat16)
    try:
        crc_codec(model, wire="device", scan_wire=True)
    except ValueError as e:
        refused = str(e).split(";")[0]
    else:
        raise AssertionError(f"{name}: the scan wire took the bf16 policy")
    finally:
        set_activation_dtype(None)
    result["scan_wire"] = {
        **crc_bytes(senc, size, scan.STREAMS), "launches": l, "launches_by_shape": sh,
        "host_round_trips_in_decompress": syncs, "tier": sorted({b[4] for b in senc["strings"][0]}),
        "first_call_s": first_s, "capture_s": capture_s, "pool_bytes": pool_bytes,
        "graphs": graphs, "launches_per_replay": per_replay, "latents_vs_device_wire": vs_device,
        "bf16_refused": refused, **codec_timing(scan, x, senc, CRC_REPS),
        "launch_by_launch": codec_timing(plain, x, penc, CRC_REPS)}
    sides = {w: {s: result[w][s] for s in ("compress", "decompress")}
             for w in ("host_wire", "device_wire", "scan_wire")}
    sides["scan_launch_by_launch"] = result["scan_wire"]["launch_by_launch"]
    log(f"  {name} img/s, device idle, ATen calls (median of {CRC_REPS}, batch {B}, {card}): "
        + "; ".join(
        f"{w} " + " / ".join(f"{v['img_per_s']:.2f} img/s idle {v['device_idle_share']:.3f} "
                             f"{v['aten_calls']} ATen" for v in per.values())
        for w, per in sides.items()))
    del scan, plain, dev, codec
    gc.collect()
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = crc_eval_vs_cpu(name, model, seed)
    return dict(model=model, result=result, counts=counts, device_enc=denc)


def crc_bf16_phase(name: str, crc: dict, x, card: str, init_state: dict, f32_train: dict,
                   seed: int) -> dict:
    """Phases 34 and 38: a CRC model under the bfloat16 policy, from the weights
    ``init_state`` its float32 phases served and trained from: the device
    wire held by ``codec_roundtrip`` with CRC_SIDE_LAUNCHES in the bfloat16
    builds (every head width and both GDN widths), its bpp within 5% and
    mean |x_hat - x_hat_f32| under 0.01 of the float32 device wire's
    (``crc["device_enc"]``), its img/s and idle; the eval forward card
    against CPU end to end and layer by layer (phase 8's
    ``eval_vs_cpu_phase``); 2 bfloat16 training steps (``bf16_train_phase``,
    every layer's rates), each launching CRC_STEP in the bfloat16 builds.
    -> results, with the launches by shape of each path under "shapes"."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    model = crc["model"]
    model.load_state_dict(init_state)
    zero_counts, read_counts = launch_counts("bfloat16")
    size = x.shape[1]
    f32_dev = crc["result"]["device_wire"]["launches"]
    expect = {side: crc_expect(name, side, "bfloat16",
                               rans_encode=f32_dev[side]["rans_encode"],
                               rans_decode=f32_dev[side]["rans_decode"])
              for side in ("compress", "decompress")}
    set_activation_dtype(torch.bfloat16)
    try:
        dev = crc_codec(model, narrow=0.2, wire="device")
        enc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts,
                                             f"{name} bf16 device wire", expect)
        timing = codec_timing(dev, x, enc, reps=CRC_REPS)
    finally:
        set_activation_dtype(None)
    f32 = crc["device_enc"]
    bpp_rel = [b16 / b32 - 1 for b16, b32 in zip(crc_bytes(enc, size, dev.STREAMS)["bpp"],
                                                  crc_bytes(f32, size, dev.STREAMS)["bpp"])]
    x_hat_mean = (enc["x_hat"].float() - f32["x_hat"].float()).abs().mean().item()
    log(f"  {name} bf16 device wire against f32: bpp {[f'{r:+.2e}' for r in bpp_rel]} (bar "
        f"{BF16_BPP_RTOL}), mean |x_hat - x_hat_f32| {x_hat_mean:.3e} (bar {BF16_XHAT_MEAN_TOL}); "
        f"img/s " + " / ".join(f"{v['img_per_s']:.2f} idle {v['device_idle_share']:.3f}"
                               for v in timing.values()) + f" ({card})")
    if max(abs(r) for r in bpp_rel) > BF16_BPP_RTOL or not x_hat_mean < BF16_XHAT_MEAN_TOL:
        raise AssertionError(f"{name} bf16 serving strays from f32: {bpp_rel}, {x_hat_mean}")
    out = {"device_wire": {**crc_bytes(enc, size, dev.STREAMS), "launches": l,
                           "launches_by_shape": sh,
                           "host_round_trips_in_decompress": syncs, **timing,
                           "against_f32": dict(bpp_rel=bpp_rel, x_hat_mean_abs=x_hat_mean,
                                               bpp_rtol=BF16_BPP_RTOL,
                                               x_hat_mean_tol=BF16_XHAT_MEAN_TOL)}}
    out["card_vs_cpu"] = eval_vs_cpu_phase(name, model, seed, cpu_model=cpu_twin(name, model))
    gc.collect()
    criterion, fixed = crc_loss(model)
    out["train"] = bf16_train_phase(model, init_state, seed, card, CRC_STEP[name], f32_train,
                                    steps=TRAIN_STEPS, criterion=criterion, fixed=fixed)
    want = crc_step_shapes(name, "bfloat16")
    if out["train"]["launches_by_shape_per_step"] != want:
        raise AssertionError(f"{name} bf16 step: launches by shape "
                             f"{out['train']['launches_by_shape_per_step']}, expected {want}")
    out["shapes"] = {"launches_bf16_device_wire_compress": sh["compress"],
                     "launches_bf16_device_wire_decompress": sh["decompress"],
                     "launches_bf16_train_step": out["train"]["launches_by_shape_per_step"]}
    return out


def crc_train_phase(model, name: str, seed: int, card: str) -> dict:
    """Phases 29, 31, 33 and 37: ``run_training`` of a CRC model on the
    card, its RateDistortionLoss over every layer's likelihoods (the JAX
    model's docstring for training from scratch): ``TRAIN_STEPS`` steps of
    8 x 256^2,
    each finite, each launching CRC_STEP, every
    parameter moved but those of the decoders no loss term reads (the
    split decoder of machine_x_hat; stf13's g_s and seg_g_s); then one
    step on the card against the plain CPU path on a small input. ->
    results."""
    criterion, fixed = crc_loss(model)
    out = train_phase(model, seed, card, CRC_STEP[name], steps=TRAIN_STEPS, resumed_steps=0,
                      criterion=criterion, fixed=fixed)
    want = crc_step_shapes(name)
    if out["launches_by_shape_per_step"] != want:
        raise AssertionError(f"{name} step: launches by shape {out['launches_by_shape_per_step']}"
                             f", expected {want}")
    out["card_vs_cpu"] = train_vs_cpu_phase(name, model, seed, criterion=criterion)
    return out


def reference_crc_state_dict(seed: int, name: str = "stf9", N: int = 192, M: int = 384,
                             mid: int = 256, enc=(384, 336, 288, 240, 192),
                             dec=(240, 288, 336, 384, 384), cc=(224, 176, 128, 64),
                             K: int = 12) -> dict:
    """A reference stf9 or stf12 state dict at full width: the reference's
    module names (stf9.py, stf12.py: ``g_a``, the inline coder's ``h_a``,
    ``h_mean_s``, ``cc_*_transforms2`` and the ``lrp_transforms2`` its
    forward discards, ``g_s1``, ``g_s2``, the ``human_h_*`` hyperprior,
    both bottlenecks; stf9's ``human_g_s2``, ``human_g_a``, ``human_g_s``
    and ``human_context_decoder``; stf12's ``human_g_enc2``,
    ``human_g_enc3``, ``human_context_decoder`` (3 convs), ``human_g_a1``,
    ``human_g_a2``, ``human_g_s1``, ``human_g_s2`` and
    ``human_context_decoder2``) and shapes (the published widths by
    default), DataParallel's ``module.`` prefix, values drawn from
    ``seed`` as ``reference_wacnn_state_dict`` draws them."""
    import torch

    if name == "stf13":
        return reference_stf13_state_dict(seed, N, M, mid, enc, dec, K=K)
    S = Wc = 24  # 6 x 2x2 zigzag slices, all of them in the conditioning window
    ref = _RefDraw(np.random.default_rng(seed), np.float32)
    _ref_g_a(ref, N, M)
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
    decoders = (("g_s1", 1), ("g_s2", 2),
                ("human_g_enc2" if name == "stf12" else "human_g_s2", None))
    for prefix, part in decoders:
        _ref_decoder(ref, prefix, N, M, mid, part)
    if name == "stf12":
        _ref_context_scale2(ref, "human_g_enc3", N, M)
        for j in range(3):
            ref.conv(f"human_context_decoder.{2 * j}", M, M, 3)
        ref.conv("human_g_a1.0", N, 6, 3)
        ref.conv("human_g_a1.2", N, N, 3)
        ref.conv("human_g_a2.0", N, 2 * N, 5)
        ref.conv("human_g_a2.2", M, N, 5)
        ref.win("human_g_a2.4", M, 4)
        ref.win("human_g_s1.0", 2 * M, 4)
        ref.conv("human_g_s1.2", N, 2 * M, 3, transposed=True)
        ref.conv("human_g_s1.4", N, N, 3, transposed=True)
        ref.conv("human_g_s2.0", N, 2 * N, 3, transposed=True)
        ref.conv("human_g_s2.2", N, N, 3)
        ref.conv("human_g_s2.4", 3, N, 3, transposed=True)
        ref.conv("human_context_decoder2.0", M, M, 3)
        ref.conv("human_context_decoder2.2", M, M, 3)
        ref.conv("human_context_decoder2.4.0", 4 * N, M, 3)
        ref.conv("human_context_decoder2.6.0", 4 * N, N, 3)
    else:
        for j, (i, o) in enumerate(zip((6, N, N, N), (N, N, N, M))):
            ref.conv(f"human_g_a.{2 * j}", o, i, 5)
        for j, (i, o) in enumerate(zip((2 * M, N, N, N), (N, N, N, 3))):
            ref.conv(f"human_g_s.{2 * j}", o, i, 5, transposed=True)
        for j in range(5):
            ref.conv(f"human_context_decoder.{2 * j}", M, M, 3)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def _ref_g_a(ref, N: int, M: int) -> None:
    """The reference's mainCNNencoder ``g_a``."""
    ref.conv("g_a.0", N, 3, 5)
    ref.gdn("g_a.1", N)
    ref.conv("g_a.2", N, N, 5)
    ref.gdn("g_a.3", N)
    ref.win("g_a.4", N, 8)
    ref.conv("g_a.5", N, N, 5)
    ref.gdn("g_a.6", N)
    ref.conv("g_a.7", M, N, 5)
    ref.win("g_a.8", M, 4)


def _ref_decoder(ref, prefix: str, N: int, M: int, mid: int, part=None) -> None:
    """The reference's mainCNNdecoder, or its first (``part=1``) or second
    (``part=2``) half."""
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


def _ref_context_scale2(ref, prefix: str, N: int, M: int) -> None:
    """The reference's mainCNNcontextScale2."""
    ref.win(f"{prefix}.0", M, 4)
    ref.conv(f"{prefix}.1", N, M, 3, transposed=True)
    ref.gdn(f"{prefix}.2", N)
    ref.conv(f"{prefix}.3", N, N, 3, transposed=True)


def reference_stf13_state_dict(seed: int, N: int = 192, M: int = 384, mid: int = 256,
                               enc=(384, 336, 288, 240, 192), dec=(240, 288, 336, 384, 384),
                               cc=(224, 64), K: int = 12) -> dict:
    """A reference stf13 state dict at full width (stf13.py's names and the
    published shapes, DataParallel's ``module.`` prefix, values drawn from
    ``seed`` as ``reference_wacnn_state_dict`` draws them): ``g_a``; the
    machine coder (``h_a``, ``h_mean_s``, ``h_scale_s``, 3-conv
    ``cc_*_transforms2`` and the ``lrp_transforms2`` it applies) and the
    segmentation coder (the same names with ``seg_``); ``g_s`` and the
    split decoder ``g_s1`` / ``g_s2`` the reference builds and never runs;
    ``seg_g_enc2`` / ``seg_g_enc3``, ``seg_g_a1`` / ``seg_g_a2``,
    ``seg_g_s``; the human layer's ``human_h_a``, deconv-style
    ``human_h_mean_s_2`` / ``human_h_scale_s_2``, four conditioning
    decoders, two 2-conv context decoders, ``human_g_a1_2`` /
    ``human_g_a2_2``, the mask nets ``generate_mask_scale1`` / ``2``, the
    deconv context decoders and ``human_g_s1_2`` / ``human_g_s2_2``; three
    bottlenecks."""
    import torch

    S = Wc = 24
    sc = M // 6
    ref = _RefDraw(np.random.default_rng(seed), np.float32)
    _ref_g_a(ref, N, M)
    for prefix in ("", "seg_"):
        for i, (o, c) in enumerate(zip(enc, (M,) + enc[:-1])):
            ref.conv(f"{prefix}h_a.{2 * i}", o, c, 3)
        for tag in ("h_mean_s", "h_scale_s"):
            ref.hyper_dec(f"{prefix}{tag}", enc[-1], dec)
        for i in range(S):
            for tag, lrp in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                             ("lrp_transforms2", sc)):
                cin = [Wc * sc + sc * min(i, K) + lrp] + list(cc)
                for j in range(len(cc)):
                    ref.conv(f"{prefix}{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
                ref.conv(f"{prefix}{tag}.{i}.{2 * len(cc)}", sc, cc[-1], 3)
    for i, (o, c) in enumerate(zip(enc, (M,) + enc[:-1])):
        ref.conv(f"human_h_a.{2 * i}", o, c, 3)
    for tag in ("human_h_mean_s_2", "human_h_scale_s_2"):
        ref.conv(f"{tag}.0", dec[0], enc[-1], 3)
        ref.conv(f"{tag}.2", dec[1], dec[0], 3, transposed=True)
        ref.conv(f"{tag}.4", dec[-1], dec[1], 3, transposed=True)
    for prefix in ("entropy_bottleneck", "entropy_bottleneck_seg", "entropy_bottleneck_human"):
        ref.bottleneck(prefix, enc[-1])
    for prefix, part in (("g_s", None), ("g_s1", 1), ("g_s2", 2), ("seg_g_enc2", None),
                         ("seg_g_s", None), ("human_g_enc2", None), ("human_g_enc4", None)):
        _ref_decoder(ref, prefix, N, M, mid, part)
    for prefix in ("seg_g_enc3", "human_g_enc3", "human_g_enc5"):
        _ref_context_scale2(ref, prefix, N, M)
    for prefix in ("human_context_decoder", "human_context_decoder3"):
        ref.conv(f"{prefix}.0", M, M, 3)
        ref.conv(f"{prefix}.2", M, M, 3)
    ref.conv("seg_g_a1.0", N, 6, 3)
    ref.conv("seg_g_a1.2", N, N, 3)
    ref.conv("seg_g_a2.0", N, 2 * N, 5)
    ref.conv("seg_g_a2.2", M, N, 5)
    ref.win("seg_g_a2.4", M, 4)
    ref.conv("human_g_a1_2.0", N, 9, 3)
    ref.conv("human_g_a1_2.2", N, N, 3)
    ref.conv("human_g_a2_2.0", N, 3 * N, 5)
    ref.conv("human_g_a2_2.2", M, N, 5)
    for prefix, cin, widths in (("generate_mask_scale1", 6, (12, 12, 9)),
                                ("generate_mask_scale2", 2 * N, (4 * N, 4 * N, 3 * N))):
        for j, (o, c) in enumerate(zip(widths, (cin,) + widths)):
            ref.conv(f"{prefix}.{2 * j}", o, c, 3)
    for prefix in ("human_context_decoder2_2", "human_context_decoder4"):
        ref.conv(f"{prefix}.0", N, M, 3)
        ref.conv(f"{prefix}.2", N, N, 3, transposed=True)
        ref.conv(f"{prefix}.4", N, N, 3, transposed=True)
    ref.conv("human_g_s1_2.0", N, 3 * M, 3, transposed=True)
    ref.conv("human_g_s1_2.2", N, N, 3, transposed=True)
    ref.conv("human_g_s2_2.0", N, 3 * N, 3, transposed=True)
    ref.conv("human_g_s2_2.2", N, N, 3)
    ref.conv("human_g_s2_2.4", 3, N, 3, transposed=True)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def crc_reference_phase(model, name: str, x, card: str, zero_counts, read_counts,
                        seed: int) -> dict:
    """Phases 30, 35 and 39: a reference stf9 (stf12, stf13) checkpoint at
    full width, as phase 18:
    the seeded reference dict converted (``zoo.convert_reference_state_dict``)
    and loaded strictly into ``model``; the converted model's own CDF tables
    (every bottleneck and the Gaussian) written into it as the reference's
    buffers and imported back equal; the images of phase 5 on the host wire
    with the imported tables in the reference symbol order
    (``ref_layout=True``), held by ``codec_roundtrip``, the blobs equal to the
    built tables' in that order. -> results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import build_codec_tables

    t = time.time()
    sd = reference_crc_state_dict(seed, name)
    model.load_state_dict(zoo.convert_reference_state_dict(name, sd), strict=True)
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
    codec = crc_codec(model, tables=imported, ref_layout=True, narrow=0.2)
    expect = {side: crc_expect(name, side) for side in ("compress", "decompress")}
    enc, _, l, shapes, _ = codec_roundtrip(codec, x, zero_counts, read_counts,
                                         f"{name} reference, host wire", expect)
    built_enc = crc_codec(model, ref_layout=True, narrow=0.2).compress(x)
    if built_enc["strings"] != enc["strings"]:
        raise AssertionError("imported tables' blobs differ from the built tables' ones")
    sha = {stream: hashlib.sha256(b"".join(enc["strings"][k])).hexdigest()
           for k, stream in enumerate(codec.STREAMS)}
    log(f"  blobs with imported tables = built tables (reference order); sha256 {sha}")
    return {"tensors": len(sd), **crc_bytes(enc, x.shape[1], codec.STREAMS), "blob_sha256": sha,
            "launches_reference_compress": l["compress"],
            "launches_reference_decompress": l["decompress"],
            "shapes_reference_compress": shapes["compress"],
            "shapes_reference_decompress": shapes["decompress"]}


def environment() -> str:
    """Logs the card (``nvidia-smi``'s name and power limit) and the
    software. -> the card's line."""
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}, "
        f"name {torch.cuda.get_device_name(0)}")
    return card


def build_kernels(later: tuple = ()):
    """Starts the build of every native library of the port in parallel
    (one nvcc or g++ a source), waits for all but those named in ``later``
    (``_native.BUILDERS``' names) and logs each one's time and ptxas'
    register and spill lines. -> a function that waits for the rest and
    logs them, so that phases that need none of them run meanwhile."""
    from icm_tpu_torch import _native

    libs = {"kernels": "libwindow_attention", "gdn": "libgdn", "rans_lanes": "librans_lanes"}
    results, threads = {}, {}

    def build(name, fn):
        t = time.time()
        try:
            results[name] = (fn(), time.time() - t)
        except BaseException as e:  # re-raised below, in the main thread
            results[name] = e

    def finish(names):
        for name in names:
            threads[name].join()
            res = results[name]
            if isinstance(res, BaseException):
                raise res
            log(f"  built {name}: {os.path.relpath(res[0], REPO)} in {res[1]:.1f}s")
            for line in _native.BUILD_LOG.get(libs.get(name, ""), "").splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"  ptxas ({libs[name]}): {line.strip()}")

    for name, fn in _native.BUILDERS.items():
        threads[name] = threading.Thread(target=build, args=(name, fn))
        threads[name].start()
    finish([n for n in threads if n not in later])
    return lambda: finish(later)


def crc_model_phases(name: str, x, card: str, zero_counts, read_counts, seed: int) -> tuple:
    """Every phase of one CRC model, in order: its wires and eval forward
    (``crc_phase``), its training, its bfloat16 policy (CRC_BF16, from the
    weights training started from) and its reference checkpoint
    (CRC_REFERENCE). -> (results, float32 launch counts by path, launches
    by shape by path)."""
    import torch

    with Phase(f"full-width {name}: host, device and scan wires, card vs CPU"):
        crc = crc_phase(name, x, card, zero_counts, read_counts, seed)
    result, counts, model = crc["result"], crc["counts"], crc["model"]
    shapes = {f"launches{'' if w == 'host_wire' else '_' + w}_{side}":
              result[w]["launches_by_shape"][side]
              for w in ("host_wire", "device_wire", "scan_wire")
              for side in ("compress", "decompress")}
    init_state = None
    if name in CRC_BF16:  # the weights the float32 phases train from
        init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with Phase(f"full-width {name} training, card vs CPU"):
        result["train"] = crc_train_phase(model, name, seed, card)
    counts["launches_train_step"] = result["train"]["launches_per_step"]
    shapes["launches_train_step"] = result["train"]["launches_by_shape_per_step"]
    if init_state is not None:
        with Phase(f"full-width {name} under the bf16 policy: device wire, card vs CPU "
                   "layer by layer, training"):
            result["bf16"] = crc_bf16_phase(name, crc, x, card, init_state, result["train"],
                                            seed)
        shapes.update(result["bf16"].pop("shapes"))
        del init_state
    if name in CRC_REFERENCE:
        with Phase(f"reference checkpoint: full-width {name}, imported tables, reference order"):
            result["reference"] = crc_reference_phase(model, name, x, card, zero_counts,
                                                      read_counts, seed)
        for side in ("compress", "decompress"):
            key = f"launches_reference_{side}"
            counts[key] = result["reference"][key]
            shapes[key] = result["reference"][f"shapes_reference_{side}"]
    del crc, model
    gc.collect()  # the model, its codecs and their graphs, before the next model
    torch.cuda.empty_cache()
    return result, counts, shapes


def masked_expect(model, N: int = 0, dtype: str = "float32") -> dict:
    """Each side's launches of a masked-family codec: window attention once
    a Swin block at head width 16 (compress: g_a and g_s, whose debug
    reconstruction is the decoder's; decompress: g_s), no GDN; with ``N``
    tokens the device wire's 2 encode and N + 1 decode launches; in
    ``dtype``'s builds. -> side -> (counts, counts by shape)."""
    from icm_tpu_torch.nn.swin import SwinBlock

    g_a, g_s = (sum(isinstance(m, SwinBlock) for m in g.modules()) for g in (model.g_a, model.g_s))
    out = {}
    for side, attn, rans in (("compress", g_a + g_s, {"rans_encode": 2 if N else 0}),
                             ("decompress", g_s, {"rans_decode": N + 1 if N else 0})):
        counts = {"window_attention": attn, "gdn_forward": 0, "gdn_backward": 0,
                  "rans_encode": 0, "rans_decode": 0, **rans}
        out[side] = (counts, {"window_attention": {f"{dtype} D16": attn}, "gdn": {}})
    return out


def masked_codec(name: str, model, **kw):
    """The codec of a masked-family model: ``Stf2Codec`` at STF2_NARROW for
    stf2, else ``Stf3Codec`` at MASKED_LATENT_SCALE; ``kw``: its tables,
    wire, graphs."""
    from icm_tpu_torch.models.masked_codec import Stf2Codec, Stf3Codec

    if name == "stf2":
        return Stf2Codec(model, narrow=STF2_NARROW, **kw)
    return Stf3Codec(model, latent_scale=MASKED_LATENT_SCALE[name], **kw)


def masked_overrides(model) -> dict:
    """The registry config a CPU twin of ``model`` needs: stf3 / stf4's mask."""
    return {"causal": model.causal} if hasattr(model, "causal") else {}


def masked_rows(codec, x, rows) -> dict:
    """The decoder's invariant at full width on the card: the context pass
    on the encoder's tokens against the same pass with the buffer's rows >=
    i zeroed (the decoder's buffer at token i) and set to 1: rows <= i of mu
    and scale bit-identical, for each i of ``rows``. -> i -> the later rows
    that the fill of ones changed (they read the buffer)."""
    import torch

    mdl = codec.model
    out = {}
    with torch.no_grad():
        y_tok, m_tok, s_tok = codec._encode(x)["tokens"]
        base = mdl.causal_mu_scale(m_tok, s_tok, y_tok)
        for i in rows:
            for fill in (0.0, 1.0):
                buf = y_tok.clone()
                buf[:, i:] = fill
                got = mdl.causal_mu_scale(m_tok, s_tok, buf)
                if not all(torch.equal(a[:, :i + 1], b[:, :i + 1]) for a, b in zip(got, base)):
                    raise AssertionError(f"context rows <= {i} moved with the buffer's rows "
                                         f">= {i} (fill {fill})")
            out[i] = int(sum((a[:, i + 1:] != b[:, i + 1:]).any(-1).any(0).sum()
                             for a, b in zip(got, base)))
    if not all(n > 0 for i, n in out.items() if i + 1 < y_tok.shape[1]):
        raise AssertionError(f"later context rows ignore the buffer: {out}")
    return out


def masked_eval_vs_cpu(name: str, model, seed: int) -> dict:
    """The eval forward on the card against the plain CPU path, the same
    weights and mask, one 256 x 256 image (czigzag: and its up_x4): x_hat
    and the y likelihoods within 1e-3 (z's printed)."""
    import torch

    from icm_tpu_torch.data import make_images

    cpu_model = cpu_twin(name, model, **masked_overrides(model))
    xs = torch.from_numpy(make_images(seed + 1, 1, 256))
    t = time.time()
    with torch.no_grad():
        ref = cpu_model(*model_args(cpu_model, xs))
        cpu_s = time.time() - t
        got = model(*model_args(model, xs.cuda()))
    worst = {"x_hat": (got["x_hat"].cpu() - ref["x_hat"]).abs().max().item(),
             **{f"{k} likelihoods": (got["likelihoods"][k].cpu() - ref["likelihoods"][k]).abs()
                .max().item() for k in "yz"}}
    log(f"  max |card - cpu| ({name}, 256 x 256; the CPU side {cpu_s:.1f}s): {worst}")
    if not (worst["x_hat"] <= 1e-3 and worst["y likelihoods"] <= 1e-3):
        raise AssertionError(f"card and CPU disagree: {worst}")
    del cpu_model
    gc.collect()
    return {"size": 256, "f32_max_abs": worst, "tolerance": 1e-3, "cpu_s": cpu_s}


def masked_phase(name: str, card: str, zero_counts, read_counts, seed: int,
                 size: int = 0) -> dict:
    """Phases 40 and 43: a masked-family model at its published width, its
    codec's mask (MASKED_CAUSAL), weights from ``seed`` (scaled as
    MASKED_GAIN says), on 2 images of MASKED_SIZE (or ``size``) px made from
    ``seed``: its nonzero y symbols (of all, at MASKED_LATENT_SCALE) held
    above 0; the decoder's invariant held at full width (``masked_rows``);
    compress -> decompress on the host wire and the device wire, each held
    by ``codec_roundtrip`` with ``masked_expect``'s launches (one window
    attention launch a Swin block, no GDN; the device wire 2 encode and N + 1
    decode launches) and no host round trip in a device-wire decompress;
    the device wire's y_hat and x_hat the host wire's, its bytes within the
    host wire's x 1.02 plus each lane's flush and header (D lanes an image
    for y), its escapes counted; each side's img/s (one host-clock call),
    device idle share and ATen calls (``codec_timing``); then the eval forward
    against the CPU's. -> {model, result, counts}."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.masked_codec import Stf3Codec

    size = size or MASKED_SIZE[name]
    B = 2
    x = torch.from_numpy(make_images(seed, B, size)).cuda()
    t = time.time()
    model = create_model(name, seed=seed, causal=MASKED_CAUSAL[name])
    with torch.no_grad():
        for pname, gain in MASKED_GAIN.get(name, {}).items():
            model.get_parameter(pname).mul_(gain)
    n_params = sum(p.numel() for p in model.parameters())
    ls = MASKED_LATENT_SCALE[name]
    host = Stf3Codec(model, latent_scale=ls)
    sym = host.symbols(x)
    torch.cuda.synchronize()
    N, D = sym.shape[1:]
    nonzero = [int(sym.count_nonzero()), sym.numel()]
    log(f"  {name}: {n_params / 1e6:.1f} M parameters in {time.time() - t:.1f}s; {N} tokens of "
        f"{D} an image at {size} px, causal {model.causal}, latent scale {ls}, scaled "
        f"{sorted(set(MASKED_GAIN.get(name, {}).values()))}; nonzero y symbols {nonzero} "
        f"({nonzero[0] / nonzero[1]:.3%})")
    if nonzero[0] < 1:
        raise AssertionError(f"{name}: every y symbol is 0")
    rows = masked_rows(host, x, (0, 1, N // 2, N - 1))
    log(f"  {name}: context rows <= i unmoved by the buffer's rows >= i at i = {sorted(rows)}; "
        f"later rows that read it: {rows}")
    result = {"params": n_params, "size": size, "tokens": N, "token_dim": D,
              "causal": model.causal, "latent_scale": ls, "gain": MASKED_GAIN.get(name, {}),
              "nonzero_y_symbols": nonzero, "row_check": rows}
    host_expect = masked_expect(model)
    dev_expect = masked_expect(model, N)
    counts = {}
    enc, _, l, sh, _ = codec_roundtrip(host, x, zero_counts, read_counts, f"{name} host wire",
                                     host_expect)
    counts.update(launches_compress=l["compress"], launches_decompress=l["decompress"])
    result["host_wire"] = {**crc_bytes(enc, size, ("y", "z")), "launches": l,
                           "launches_by_shape": sh,
                           **codec_timing(host, x, enc, 1, MASKED_PROFILED.get(name, SIDES))}
    dev = Stf3Codec(model, latent_scale=ls, wire="device")
    denc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts, f"{name} device wire",
                                          dev_expect)
    counts.update(launches_device_wire_compress=l["compress"],
                  launches_device_wire_decompress=l["decompress"])
    for k in ("y_hat", "x_hat"):
        if not torch.equal(denc[k], enc[k]):
            raise AssertionError(f"{name}: the device wire's {k} differs from the host's")
    lanes = {"y": D, "z": (size // 64) ** 2 * dev.kit.z_groups(model.entropy_bottleneck.channels)}
    host_b, dev_b = crc_bytes(enc, size, "yz")["bytes"], crc_bytes(denc, size, "yz")["bytes"]
    stream_bytes = {k: dict(device=dev_b[k], host=host_b[k], lanes=lanes[k],
                            escapes=wire_escapes(denc["strings"]["yz".index(k)]),
                            limit=host_b[k] * 1.02 + B * (lanes[k] * 8 + 16)) for k in lanes}
    log(f"  {name} device wire bytes {stream_bytes}; y blobs' tier "
        f"{sorted({b[4] for b in denc['strings'][0]})}")
    for k, v in stream_bytes.items():
        if v["device"] > v["limit"]:
            raise AssertionError(f"{name} device wire {k}: {v['device']} bytes over {v['limit']}")
    result["device_wire"] = {**crc_bytes(denc, size, "yz"), "stream_bytes": stream_bytes,
                             "launches": l, "launches_by_shape": sh,
                             "host_round_trips_in_decompress": syncs,
                             **codec_timing(dev, x, denc, 1)}
    log(f"  {name} img/s, device idle, ATen calls (one call, batch {B} x {size}^2, {card}): "
        + "; ".join(f"{w} " + " / ".join(timing_text(result[w][s]) for s in SIDES)
                    for w in ("host_wire", "device_wire")))
    del host, dev
    gc.collect()
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = masked_eval_vs_cpu(name, model, seed)
    return dict(model=model, result=result, counts=counts, x_hat=denc["x_hat"])


def stf2_phase(name: str, card: str, zero_counts, read_counts, seed: int, size: int = 0) -> dict:
    """Phase 46: stf2 at its published width (337.1 M parameters), weights
    from ``seed``, on 2 images of MASKED_SIZE (or ``size``) px made from
    ``seed``, its codec at STF2_NARROW: its nonzero y symbols held at 1 or
    more; compress -> decompress, each side's counts zeroed right before
    and read right after, held by ``codec_roundtrip`` with
    ``masked_expect``'s launches (24 / 12 window-attention launches at head
    width 16, no GDN; the device wire 2 encode and N + 1 = 65 decode
    launches), on the host wire, on the device wire's graphed token scan
    (its programs captured by a first compress and decompress, whose
    seconds, capture seconds and pool bytes are logged; the 64 token
    decodes inside the decode graph, each graph's launches a replay equal
    to a traced replay's: ``graph_replays``) and on the same functions
    launch by launch (``cuda_graphs=False``): every side bit-exact, no host
    round trip in a device-wire decompress, the two device runs' blobs and
    y_hat / x_hat bits equal and equal to the host wire's y_hat / x_hat; the
    device wire's bytes within the host wire's x 1.02 plus each lane's
    flush and header (D = 6144 lanes an image for y), its escapes counted;
    each side's img/s (one call), device idle share and ATen calls on the
    three; then the eval forward against the CPU's at 256 px. -> {model,
    result, counts, x_hat}."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import create_model

    size = size or MASKED_SIZE[name]
    B = 2
    x = torch.from_numpy(make_images(seed, B, size)).cuda()
    t = time.time()
    model = create_model(name, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    host = masked_codec(name, model)
    sym = host.symbols(x)
    torch.cuda.synchronize()
    N, D = sym.shape[1:]
    nonzero = [int(sym.count_nonzero()), sym.numel()]
    log(f"  {name}: {n_params / 1e6:.1f} M parameters in {time.time() - t:.1f}s; {N} tokens of "
        f"{D} an image at {size} px, {model.num_sliding} sliding, narrow {STF2_NARROW}; nonzero y "
        f"symbols {nonzero} ({nonzero[0] / nonzero[1]:.3%})")
    if nonzero[0] < 1:
        raise AssertionError(f"{name}: every y symbol is 0")
    result = {"params": n_params, "size": size, "tokens": N, "token_dim": D,
              "num_sliding": model.num_sliding, "narrow": STF2_NARROW,
              "nonzero_y_symbols": nonzero}
    counts = {}
    enc, _, l, sh, _ = codec_roundtrip(host, x, zero_counts, read_counts, f"{name} host wire",
                                       masked_expect(model))
    counts.update(launches_compress=l["compress"], launches_decompress=l["decompress"])
    result["host_wire"] = {**crc_bytes(enc, size, "yz"), "launches": l, "launches_by_shape": sh,
                           **codec_timing(host, x, enc, 1)}

    dev = masked_codec(name, model, wire="device")
    t = time.time()
    first = dev.compress(x, return_debug=True)
    dev.decompress(*codec_dec_args(dev, first))
    torch.cuda.synchronize()
    first_s = time.time() - t
    stats = dev.graphs.stats()
    graphs = {" ".join(str(p) for p in key): st for key, st in stats.items()}
    capture_s = sum(st["capture_s"] for st in stats.values())
    pool_bytes = sum(st["pool_bytes"] for st in stats.values())
    log(f"  {name} graphed token scan: first compress + decompress {first_s:.2f}s, captures "
        f"{capture_s:.2f}s of it, pools {pool_bytes / 2**20:.1f} MiB; per graph: {graphs}")
    dev_expect = masked_expect(model, N)
    denc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts,
                                            f"{name} device wire (graphed token scan)", dev_expect)
    counts.update(launches_device_wire_compress=l["compress"],
                  launches_device_wire_decompress=l["decompress"])
    per_replay = graph_replays(dev, N)
    plain = masked_codec(name, model, wire="device", cuda_graphs=False)
    penc, _, pl, _, psyncs = codec_roundtrip(plain, x, zero_counts, read_counts,
                                             f"{name} device wire, launch by launch", dev_expect)
    counts.update(launches_launch_by_launch_compress=pl["compress"],
                  launches_launch_by_launch_decompress=pl["decompress"])
    if penc["strings"] != denc["strings"]:
        raise AssertionError(f"{name}: graphed blobs differ from launch by launch")
    for k in ("y_hat", "x_hat"):
        for what, other in (("launch by launch", penc), ("the host wire", enc)):
            if not torch.equal(denc[k], other[k]):
                raise AssertionError(f"{name}: the graphed device wire's {k} differs from {what}'s")
    lanes = {"y": D, "z": (size // 64) ** 2 * dev.kit.z_groups(model.entropy_bottleneck.channels)}
    host_b, dev_b = crc_bytes(enc, size, "yz")["bytes"], crc_bytes(denc, size, "yz")["bytes"]
    stream_bytes = {k: dict(device=dev_b[k], host=host_b[k], lanes=lanes[k],
                            escapes=wire_escapes(denc["strings"]["yz".index(k)]),
                            limit=host_b[k] * 1.02 + B * (lanes[k] * 8 + 16)) for k in lanes}
    log(f"  {name} device wire bytes {stream_bytes}; y blobs' tier "
        f"{sorted({b[4] for b in denc['strings'][0]})}")
    for k, v in stream_bytes.items():
        if v["device"] > v["limit"]:
            raise AssertionError(f"{name} device wire {k}: {v['device']} bytes over {v['limit']}")
    result["device_wire"] = {**crc_bytes(denc, size, "yz"), "stream_bytes": stream_bytes,
                             "launches": l, "launches_by_shape": sh,
                             "host_round_trips_in_decompress": syncs,
                             "first_call_s": first_s, "capture_s": capture_s,
                             "pool_bytes": pool_bytes, "graphs": graphs,
                             "launches_per_replay": per_replay,
                             **codec_timing(dev, x, denc, 1),
                             "launch_by_launch": {"host_round_trips_in_decompress": psyncs,
                                                  **codec_timing(plain, x, penc, 1)}}
    log(f"  {name} img/s, device idle, ATen calls (one call, batch {B} x {size}^2, {card}): "
        + "; ".join(f"{w} " + " / ".join(timing_text(r[s]) for s in SIDES)
                    for w, r in (("host wire", result["host_wire"]),
                                 ("graphed", result["device_wire"]),
                                 ("launch by launch", result["device_wire"]["launch_by_launch"]))))
    del host, dev, plain
    gc.collect()
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = masked_eval_vs_cpu(name, model, seed)
    return dict(model=model, result=result, counts=counts, x_hat=denc["x_hat"])


def masked_bf16_phase(name: str, model, card: str, seed: int, size: int, f32: dict) -> tuple:
    """Phases 40b, 43b and 46b: the masked-family model under the bfloat16
    policy, its f32 phase's weights: the device wire on that phase's images
    (stf2's graphed token scan, captured anew for the policy by a first
    call), held by ``codec_roundtrip`` with the f32 device wire's launches,
    every one a bfloat16 build's (head width 16), the encoder's y_hat
    bfloat16, bit-exact, no host round trip; its bpp within 5%
    (BF16_BPP_RTOL) of the f32 device wire's (``f32``: that phase's result
    and x_hat), mean |x_hat - x_hat_f32| logged; img/s, idle and ATen calls;
    stf3 / stf4's context pass under the policy at full width, rows <= i
    unmoved by the buffer's rows >= i (``masked_rows``); then the eval
    forward card against CPU on 64 x 64 as phase 8 (float32, then the
    policy end to end and layer by layer with its control). -> (results,
    the device wire's launches by side)."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.nn import set_activation_dtype

    zero16, read16 = launch_counts("bfloat16")
    B = 2
    x = torch.from_numpy(make_images(seed, B, size)).cuda()
    N = f32["result"]["tokens"]
    codec = masked_codec(name, model, wire="device")
    set_activation_dtype(torch.bfloat16)
    try:
        if name == "stf2":  # capture the policy's graphs outside the held call
            first = codec.compress(x)
            codec.decompress(*codec_dec_args(codec, first))
        denc, _, l, sh, syncs = codec_roundtrip(codec, x, zero16, read16,
                                                f"{name} bf16 device wire",
                                                masked_expect(model, N, "bfloat16"))
        if denc["y_hat"].dtype != torch.bfloat16:
            raise AssertionError(f"{name} bf16: the encoder's y_hat is {denc['y_hat'].dtype}")
        timing = codec_timing(codec, x, denc, 1, MASKED_PROFILED.get(name, SIDES))
        rows = (masked_rows(codec, x, (0, 1, N // 2, N - 1)) if name != "stf2" else None)
    finally:
        set_activation_dtype(None)
    bpp = crc_bytes(denc, size, "yz")["bpp"]
    f32_bpp = f32["result"]["device_wire"]["bpp"]
    bpp_rel = sum(bpp) / sum(f32_bpp) - 1
    x_hat_mean = float((denc["x_hat"].float() - f32["x_hat"].float()).abs().mean())
    log(f"  {name} bf16 device wire: bpp {bpp} against f32 {f32_bpp} ({bpp_rel:+.3e}, bar "
        f"{BF16_BPP_RTOL}); mean |x_hat - x_hat_f32| {x_hat_mean:.3e}; "
        + " / ".join(timing_text(timing[s]) for s in SIDES) + f" ({card})"
        + (f"; context rows under the policy: {rows}" if rows else ""))
    if abs(bpp_rel) > BF16_BPP_RTOL:
        raise AssertionError(f"{name} bf16: bpp strays from f32 ({bpp_rel:+.3e})")
    result = {"device_wire": {**crc_bytes(denc, size, "yz"), "launches": l,
                              "launches_by_shape": sh, "host_round_trips_in_decompress": syncs,
                              "bpp_rel_f32": bpp_rel, "x_hat_mean_abs_f32": x_hat_mean,
                              **timing},
              **({"row_check": rows} if rows else {})}
    del codec
    gc.collect()
    torch.cuda.empty_cache()
    cpu_model = cpu_twin(name, model, **masked_overrides(model))
    result["card_vs_cpu"] = eval_vs_cpu_phase(name, model, seed, cpu_model=cpu_model,
                                              unheld=MASKED_BF16_UNHELD.get(name, ()))
    del cpu_model
    gc.collect()
    return result, {"launches_device_wire_compress": l["compress"],
                    "launches_device_wire_decompress": l["decompress"]}


def masked_train_phase(model, name: str, seed: int, card: str, init_state=None,
                       f32_train=None) -> dict:
    """Phases 41, 44 and 47: ``run_training`` of a masked-family model
    through the JAX package's training forward (the reference mask: stf4's
    ``causal`` off for it, and back after), RateDistortionLoss(0.01), 3
    steps of 8 x 256^2 at the registry's stochastic depth 0.2, each finite,
    each launching window attention once a Swin block (24) and no other
    kernel, every parameter moved but stf4's scale head, which no forward
    applies; then one step on the card against the plain CPU path at depth
    0. With ``init_state`` and ``f32_train`` (phases 41b, 44b, 47b): 2 steps
    under the bfloat16 policy from those weights instead (``bf16_train_phase``:
    every launch a bfloat16 build's, float32 gradients, the first step's bpp
    within 5% of the float32 phase's first). -> results."""
    causal = getattr(model, "causal", None)
    if causal is not None:
        model.causal = False
    dtype = "float32" if init_state is None else "bfloat16"
    try:
        expect = {**masked_expect(model)["compress"][0], "rans_encode": 0, "rans_decode": 0}
        fixed = ("cc_scale_head.",) if name == "stf4" else ()
        if init_state is None:
            out = train_phase(model, seed, card, expect, steps=3, resumed_steps=0, fixed=fixed)
        else:
            out = bf16_train_phase(model, init_state, seed, card, expect, f32_train, steps=2,
                                   fixed=fixed)
        if out["launches_by_shape_per_step"] != {
                "window_attention": {f"{dtype} D16": expect["window_attention"]}, "gdn": {}}:
            raise AssertionError(f"{name} step: launches by shape "
                                 f"{out['launches_by_shape_per_step']}")
        if init_state is None:
            out["card_vs_cpu"] = train_vs_cpu_phase(name, model, seed)
    finally:
        if causal is not None:
            model.causal = causal
    return out


def reference_masked_state_dict(seed: int, name: str) -> dict:
    """A reference stf2, stf3 or stf4 state dict at full width: the
    reference's module names (stf2.py, stf3.py, stf4.py: stf's
    ``patch_embed``, ``layers``, ``syn_layers``, ``end_conv``, ``h_a``,
    ``h_mean_s``, ``h_scale_s`` and bottleneck; stf2's
    ``{mu,sigma}ContextModel.qkv``, ``cc_{mean,scale}_transforms`` and
    ``lrp_transforms`` (its per-token heads) and the first layers of its
    forward-dead conv ``g_a`` / ``g_s``; stf3's
    ``maskedContextModel_{mu,sigma}.context{i}``, ``.norm{i}``,
    ``.mlp{i}.fc1`` / ``fc2``; stf4's ``maskedContextModel_{mu,sigma}.0.qkv``
    and ``cc_{mean,scale}_transforms``; stf3 and stf4's global
    ``lrp_transforms``), DataParallel's ``module.`` prefix, values drawn
    from ``seed`` as ``reference_wacnn_state_dict`` draws them."""
    import torch

    ref = _RefDraw(np.random.default_rng(seed), np.float32)
    embed, depths, heads, ws = 48, (2, 2, 6, 2), (3, 6, 12, 24), 4
    enc, dec = (384, 336, 288, 240, 192), (240, 288, 336, 384, 384)
    M, Cp, D = 384, 48, 768

    def lin(n, o, i):
        ref.put(f"{n}.weight", (o, i), i ** -0.5)
        ref.put(f"{n}.bias", (o,), 0.01)

    def ln(n, c):
        ref.put(f"{n}.weight", (c,), 0.1, 1.0)
        ref.put(f"{n}.bias", (c,), 0.05)

    def blocks(prefix, dim, depth, h):
        for j in range(depth):
            b = f"{prefix}.blocks.{j}"
            ln(f"{b}.norm1", dim)
            lin(f"{b}.attn.qkv", 3 * dim, dim)
            lin(f"{b}.attn.proj", dim, dim)
            ref.put(f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h), 0.02)
            ln(f"{b}.norm2", dim)
            lin(f"{b}.mlp.fc1", 4 * dim, dim)
            lin(f"{b}.mlp.fc2", dim, 4 * dim)

    ref.conv("patch_embed.proj", embed, 3, 2)
    ln("patch_embed.norm", embed)
    for i in range(4):
        dim = embed * 2 ** i
        blocks(f"layers.{i}", dim, depths[i], heads[i])
        if i < 3:
            ref.put(f"layers.{i}.downsample.reduction.weight", (2 * dim, 4 * dim),
                    (4 * dim) ** -0.5)
            ln(f"layers.{i}.downsample.norm", 4 * dim)
        dim = embed * 2 ** (3 - i)
        blocks(f"syn_layers.{i}", dim, depths[3 - i], heads[3 - i])
        if i < 3:
            ref.put(f"syn_layers.{i}.downsample.reduction.weight", (2 * dim, dim), dim ** -0.5)
            ln(f"syn_layers.{i}.downsample.norm", dim)
    ref.conv("end_conv.0", embed * 4, embed, 5)
    ref.conv("end_conv.2", 3, embed, 3)
    for i, (o, c) in enumerate(zip(enc, (M,) + enc[:-1])):
        ref.conv(f"h_a.{2 * i}", o, c, 3)
    for tag in ("h_mean_s", "h_scale_s"):
        ref.hyper_dec(tag, enc[-1], dec)
    ref.bottleneck("entropy_bottleneck", enc[-1])
    if name == "stf2":
        Cp, s, D = 96, 6, 6144
        for tag in ("muContextModel", "sigmaContextModel"):
            lin(f"{tag}.qkv", 3 * D, D)
        for tag, extra in (("cc_mean_transforms", 0), ("cc_scale_transforms", 0),
                           ("lrp_transforms", Cp)):
            for j, (o, i) in enumerate(zip((s * Cp, 15 * Cp, 8 * Cp, Cp),
                                           (2 * s * Cp + extra, s * Cp, 15 * Cp, 8 * Cp))):
                ref.conv(f"{tag}.{2 * j}", o, i, 3)
        ref.conv("g_a.0", 192, 3, 5)  # the conv transforms, which no forward runs
        ref.conv("g_s.0", 192, M, 5)
        return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}
    if name == "stf3":
        for tag in ("maskedContextModel_mu", "maskedContextModel_sigma"):
            for i in range(1, 6):
                lin(f"{tag}.context{i}.qkv", 3 * D, D)
                ln(f"{tag}.norm{i}", D)
                lin(f"{tag}.mlp{i}.fc1", 2 * D, D)
                lin(f"{tag}.mlp{i}.fc2", D, 2 * D)
    else:
        w = 27
        for tag in ("maskedContextModel_mu", "maskedContextModel_sigma"):
            lin(f"{tag}.0.qkv", 3 * D, D)
        for tag in ("cc_mean_transforms", "cc_scale_transforms"):
            for j, (o, i) in enumerate(zip((w * Cp, 15 * Cp, 8 * Cp, Cp),
                                           (2 * w * Cp, w * Cp, 15 * Cp, 8 * Cp))):
                ref.conv(f"{tag}.{2 * j}", o, i, 3)
    for j, (o, i) in enumerate(zip((2 * M, M, M, M), (3 * M, 2 * M, M, M))):
        ref.conv(f"lrp_transforms.{2 * j}", o, i, 3)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def masked_reference_phase(model, name: str, card: str, zero_counts, read_counts,
                           seed: int, size: int) -> dict:
    """Phases 42, 45 and 48: a reference stf3 (stf4, stf2) checkpoint at
    full width, as phase 18: the seeded reference dict converted and loaded
    strictly into ``model`` (the codec's mask); the converted model's own
    CDF tables (the bottleneck's and the Gaussian's) written into it as the
    reference's buffers and imported back equal; 2 images of ``size`` px on
    the host wire (``masked_codec``: MASKED_LATENT_SCALE, stf2's
    STF2_NARROW) with the imported tables, held by ``codec_roundtrip``, its
    nonzero y symbols above 0, the blobs equal to the built tables'. ->
    results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import build_codec_tables

    t = time.time()
    sd = reference_masked_state_dict(seed, name)
    model.load_state_dict(zoo.convert_reference_state_dict(name, sd), strict=True)
    built = build_codec_tables(model)
    stored = {"gaussian_conditional": built.gaussian, **built.bottlenecks}
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            sd[f"module.{prefix}._{field}"] = torch.from_numpy(getattr(tab, field))
    sd["module.gaussian_conditional.scale_table"] = torch.from_numpy(built.scale_table)
    imported = zoo.import_reference_tables(sd)
    got = {"gaussian_conditional": imported.gaussian, **imported.bottlenecks}
    if set(got) != set(stored) or not np.array_equal(imported.scale_table, built.scale_table):
        raise AssertionError(f"imported tables {sorted(got)}, stored {sorted(stored)}")
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            if not np.array_equal(getattr(got[prefix], field), getattr(tab, field)):
                raise AssertionError(f"imported {prefix} {field} differs from the stored one")
    log(f"  {len(sd)} reference tensors converted, loaded strictly and tables imported in "
        f"{time.time() - t:.1f}s")
    x = torch.from_numpy(make_images(seed, 2, size)).cuda()
    codec = masked_codec(name, model, tables=imported)
    sym = codec.symbols(x)
    nonzero = [int(sym.count_nonzero()), sym.numel()]
    if nonzero[0] < 1:
        raise AssertionError(f"{name} reference: every y symbol is 0")
    enc, _, l, shapes, _ = codec_roundtrip(codec, x, zero_counts, read_counts,
                                         f"{name} reference, host wire", masked_expect(model))
    if masked_codec(name, model).compress(x)["strings"] != enc["strings"]:
        raise AssertionError("imported tables' blobs differ from the built tables' ones")
    sha = {k: hashlib.sha256(b"".join(enc["strings"][i])).hexdigest() for i, k in enumerate("yz")}
    log(f"  nonzero y symbols {nonzero} ({nonzero[0] / nonzero[1]:.3%}); blobs with imported "
        f"tables = built tables; sha256 {sha}")
    return {"tensors": len(sd), "nonzero_y_symbols": nonzero, **crc_bytes(enc, size, "yz"),
            "blob_sha256": sha, "launches_reference_compress": l["compress"],
            "launches_reference_decompress": l["decompress"]}


def masked_model_phases(name: str, card: str, zero_counts, read_counts, seed: int,
                        size: int = 0) -> tuple:
    """Every phase of one masked-family model, in order: its wires and eval
    forward (``masked_phase``, stf2's ``stf2_phase``), the same under the
    bfloat16 policy (``masked_bf16_phase``), its training, 2 bfloat16 steps
    from the same starting weights, its reference checkpoint. ->
    (results, float32 launch counts by path, bfloat16 launch counts by
    path)."""
    import torch

    size = size or MASKED_SIZE[name]
    wires = "graphed token scan and launch by launch" if name == "stf2" else "device wire"
    with Phase(f"full-width {name}: host wire and {wires} at {size} px, card vs CPU"):
        ph = (stf2_phase if name == "stf2" else masked_phase)(name, card, zero_counts,
                                                              read_counts, seed, size)
    result, counts, model = ph["result"], ph["counts"], ph["model"]
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with Phase(f"full-width {name} under the bf16 policy: device wire at {size} px, card vs "
               "CPU layer by layer"):
        result["bf16"], bf16_counts = masked_bf16_phase(name, model, card, seed, size, ph)
    with Phase(f"full-width {name} training, card vs CPU"):
        result["train"] = masked_train_phase(model, name, seed, card)
    counts["launches_train_step"] = result["train"]["launches_per_step"]
    with Phase(f"full-width {name} training under the bf16 policy"):
        result["bf16"]["train"] = masked_train_phase(model, name, seed, card, init_state,
                                                     result["train"])
    bf16_counts["launches_train_step"] = result["bf16"]["train"]["launches_per_step"]
    del init_state
    with Phase(f"reference checkpoint: full-width {name}, imported tables"):
        result["reference"] = masked_reference_phase(model, name, card, zero_counts,
                                                     read_counts, seed, size)
    for side in ("compress", "decompress"):
        counts[f"launches_reference_{side}"] = result["reference"][f"launches_reference_{side}"]
    del ph, model
    gc.collect()
    torch.cuda.empty_cache()
    return result, counts, bf16_counts


class Conditioned:
    """A ``CzigzagCodec`` with its up_x4 bound, compressing ``x`` and
    decompressing ``(strings, shape)`` as the other codecs do, for the
    helpers that drive those (``codec_roundtrip``, ``codec_timing``,
    ``graph_replays``); every other attribute is the codec's."""

    def __init__(self, codec, up):
        self.codec, self.up = codec, up

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def compress(self, x, return_debug: bool = False):
        return self.codec.compress(x, self.up, return_debug)

    def decompress(self, *args):
        return self.codec.decompress(*args, self.up)


def czigzag_expect(side: str, dtype: str = "float32", **rans) -> tuple:
    """(one side's launch counts by kernel, by shape as ``shape_counts``
    gives them) of czigzag in ``dtype``'s builds: CZIGZAG_SIDE_LAUNCHES,
    and ``rans``."""
    attn = {f"{dtype} D{d}": n for d, n in CZIGZAG_SIDE_LAUNCHES[side].items()}
    counts = {"window_attention": sum(attn.values()), "gdn_forward": 0, "gdn_backward": 0,
              "rans_encode": 0, "rans_decode": 0, **rans}
    return counts, {"window_attention": attn, "gdn": {}}


def czigzag_codec(model, up, **kw) -> Conditioned:
    from icm_tpu_torch.models.crc_codec import CzigzagCodec

    return Conditioned(CzigzagCodec(model, narrow=CZIGZAG_NARROW, **kw), up)


def czigzag_stream_bytes(dev, enc, denc, size: int) -> dict:
    """The y and z streams' bytes on the device wire (``denc``) against the
    host wire's (``enc``), their lanes (y: a zigzag block's, 16 x 16 at
    512 px; z: its grid times the bottleneck's channel groups), escapes
    and limit: the host wire's x 1.02 plus each lane's flushed state and
    length and the header."""
    B, kit, model = len(enc["strings"][0]), dev.kit, dev.model
    lanes = {"y": kit.n_lanes(size // 32, size // 32),
             "z": (size // 32) ** 2 * kit.z_groups(model.entropy_bottleneck.channels)}
    host_b, dev_b = crc_bytes(enc, size, "yz")["bytes"], crc_bytes(denc, size, "yz")["bytes"]
    return {k: dict(device=dev_b[k], host=host_b[k], lanes=lanes[k],
                    escapes=wire_escapes(denc["strings"]["yz".index(k)]),
                    limit=host_b[k] * 1.02 + B * (lanes[k] * 8 + 16)) for k in lanes}


def czigzag_phase(x, card: str, zero_counts, read_counts, seed: int) -> dict:
    """Phase 49: czigzag at its published width, weights from ``seed``, on
    phase 5's images and their up_x4 (``conditioning_image``, made on the
    card, the same tensor on both sides) at CZIGZAG_NARROW: its nonzero y
    symbols counted and held above 0; compress -> decompress on the host
    wire, the device wire and the scan wire (graphed, then launch by
    launch), each held by ``codec_roundtrip`` with CZIGZAG_SIDE_LAUNCHES
    (the device and scan wires: 2 encode and 17 decode launches, 16
    slices and z); the device wire's y_hat and x_hat equal to the host
    wire's, each stream's bytes within the host wire's x 1.02 plus each
    lane's flush and header; the scan wire's graphs held as phase 7a's
    (``graph_replays``: the 16 slice decodes inside the decode graph), its
    blobs and bits equal to launch by launch, its y_hat against the device
    wire's (equal, or within JAX's bar), the bf16 policy refused; img/s,
    device idle and ATen calls of each side; then the eval forward against
    the CPU's at 256 px. -> {model, result, counts, shapes, device_enc}."""
    import torch

    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.nn import set_activation_dtype

    B, size = x.shape[0], x.shape[1]
    t = time.time()
    model = create_model("czigzag", seed=seed)
    up = conditioning_image(x)
    n_params = sum(p.numel() for p in model.parameters())
    codec = czigzag_codec(model, up)
    torch.cuda.synchronize()
    log(f"  czigzag: {n_params / 1e6:.1f} M parameters and codec tables in {time.time() - t:.1f}s; "
        f"{model.ctx_slices} zigzag slices of {model.slice_ch} channels, support "
        f"{model.max_support}, windows {model.cond_blocks}; narrow {CZIGZAG_NARROW}")
    syms = codec.symbols(x, up)["y_hat"]
    nonzero = [sum(int(s.count_nonzero()) for s in syms), sum(s.numel() for s in syms)]
    log(f"  czigzag: nonzero y symbols {nonzero} ({nonzero[0] / nonzero[1]:.3%})")
    if nonzero[0] < 1:
        raise AssertionError("czigzag: every y symbol is 0")
    N = model.ctx_slices
    host_expect = {side: czigzag_expect(side) for side in SIDES}
    dev_expect = {"compress": czigzag_expect("compress", rans_encode=2),
                  "decompress": czigzag_expect("decompress", rans_decode=N + 1)}
    result = {"params": n_params, "ctx_slices": N, "slice_channels": model.slice_ch,
              "narrow": CZIGZAG_NARROW, "nonzero_y_symbols": nonzero}
    counts, shapes = {}, {}

    def record(key: str, l: dict, sh: dict) -> None:
        for side in SIDES:
            counts[f"launches{key}_{side}"] = l[side]
            shapes[f"launches{key}_{side}"] = sh[side]

    enc, _, l, sh, _ = codec_roundtrip(codec, x, zero_counts, read_counts, "czigzag host wire",
                                     host_expect)
    record("", l, sh)
    result["host_wire"] = {**crc_bytes(enc, size, "yz"), "launches": l, "launches_by_shape": sh,
                           **codec_timing(codec, x, enc, CRC_REPS)}

    dev = czigzag_codec(model, up, tables=codec.tables, wire="device")
    denc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts,
                                          "czigzag device wire", dev_expect)
    record("_device_wire", l, sh)
    for k in ("y_hat", "x_hat"):
        if not torch.equal(denc[k], enc[k]):
            raise AssertionError(f"czigzag: the device wire's {k} differs from the host's")
    stream_bytes = czigzag_stream_bytes(dev, enc, denc, size)
    log(f"  czigzag device wire bytes {stream_bytes}")
    for k, v in stream_bytes.items():
        if v["device"] > v["limit"]:
            raise AssertionError(f"czigzag device wire {k}: {v['device']} bytes over {v['limit']}")
    result["device_wire"] = {**crc_bytes(denc, size, "yz"), "stream_bytes": stream_bytes,
                             "launches": l, "launches_by_shape": sh,
                             "host_round_trips_in_decompress": syncs,
                             **codec_timing(dev, x, denc, CRC_REPS)}

    scan = czigzag_codec(model, up, tables=codec.tables, wire="device", scan_wire=True)
    t = time.time()
    first = scan.compress(x, return_debug=True)
    scan.decompress(*codec_dec_args(scan, first))
    torch.cuda.synchronize()
    first_s = time.time() - t
    stats = scan.graphs.stats()
    graphs = {" ".join(str(p) for p in key): st for key, st in stats.items()}
    capture_s = sum(st["capture_s"] for st in stats.values())
    pool_bytes = sum(st["pool_bytes"] for st in stats.values())
    log(f"  czigzag scan wire: first compress + decompress {first_s:.2f}s, captures "
        f"{capture_s:.2f}s of it, pools {pool_bytes / 2**20:.1f} MiB, {len(graphs)} graphs")
    senc, sdec, l, sh, syncs = codec_roundtrip(scan, x, zero_counts, read_counts,
                                             "czigzag scan wire", dev_expect)
    record("_scan_wire", l, sh)
    chains = {k for k in scan.graphs.graphs() if k[0] == "scan"}
    if len(chains) != 2:
        raise AssertionError(f"czigzag scan wire: chain graphs {sorted(map(str, chains))}")
    per_replay = graph_replays(scan, N)
    plain = czigzag_codec(model, up, tables=codec.tables, wire="device", scan_wire=True,
                          cuda_graphs=False)
    penc = plain.compress(x, return_debug=True)
    pdec = plain.decompress(*codec_dec_args(plain, senc))
    if penc["strings"] != senc["strings"]:
        raise AssertionError("czigzag scan wire: graphed blobs differ from launch by launch")
    for got, want, what in ((penc, senc, "compress"), (pdec, sdec, "decompress")):
        for k in ("y_hat", "x_hat"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"czigzag scan wire: graphed {what} {k} differs from "
                                     "launch by launch")
    d = (senc["y_hat"] - enc["y_hat"]).abs()
    vs_device = {"equal": bool(torch.equal(senc["y_hat"], enc["y_hat"])
                               and torch.equal(senc["x_hat"], enc["x_hat"])),
                 "share_above_1e-2": float((d > 1e-2).float().mean()),
                 "median": float(d.median()), "max": float(d.max())}
    log(f"  czigzag scan wire y_hat against the host and device wires': {vs_device} (bars "
        f"{SCAN_VS_DEVICE})")
    if not (vs_device["share_above_1e-2"] < SCAN_VS_DEVICE["share_above_1e-2"]
            and vs_device["median"] < SCAN_VS_DEVICE["median"]):
        raise AssertionError(f"czigzag scan wire y_hat strays from the device wire's: {vs_device}")
    set_activation_dtype(torch.bfloat16)
    try:
        czigzag_codec(model, up, wire="device", scan_wire=True)
    except ValueError as e:
        refused = str(e).split(";")[0]
    else:
        raise AssertionError("czigzag: the scan wire took the bf16 policy")
    finally:
        set_activation_dtype(None)
    result["scan_wire"] = {
        **crc_bytes(senc, size, "yz"), "launches": l, "launches_by_shape": sh,
        "host_round_trips_in_decompress": syncs, "tier": sorted({b[4] for b in senc["strings"][0]}),
        "first_call_s": first_s, "capture_s": capture_s, "pool_bytes": pool_bytes,
        "graphs": graphs, "launches_per_replay": per_replay, "y_hat_vs_device_wire": vs_device,
        "bf16_refused": refused, **codec_timing(scan, x, senc, CRC_REPS),
        "launch_by_launch": codec_timing(plain, x, penc, CRC_REPS)}
    sides = {w: {s: result[w][s] for s in SIDES} for w in ("host_wire", "device_wire", "scan_wire")}
    sides["scan_launch_by_launch"] = result["scan_wire"]["launch_by_launch"]
    log(f"  czigzag img/s, device idle, ATen calls (batch {B}, {card}): " + "; ".join(
        f"{w} " + " / ".join(timing_text(v) for v in per.values()) for w, per in sides.items()))
    del scan, plain, dev, codec
    gc.collect()
    torch.cuda.empty_cache()
    result["card_vs_cpu"] = masked_eval_vs_cpu("czigzag", model, seed)
    return dict(model=model, up=up, result=result, counts=counts, shapes=shapes, device_enc=denc)


def czigzag_bf16_phase(cz: dict, x, card: str, init_state: dict, f32_train: dict,
                       seed: int) -> dict:
    """Phase 51: czigzag under the bfloat16 policy from the weights its
    float32 phases served and trained from: the device wire held by
    ``codec_roundtrip`` with CZIGZAG_SIDE_LAUNCHES in the bfloat16 builds,
    y_hat bfloat16, bpp within 5% and mean |x_hat - x_hat_f32| under 0.01
    of the float32 device wire's; the eval forward card against CPU end to
    end and layer by layer (phase 8's ``eval_vs_cpu_phase`` on 64 x 64 and
    its up_x4); 2 bfloat16 training steps from ``init_state``
    (``bf16_train_phase``), each launching the step's attention in the
    bfloat16 builds. (The scan wire refuses the policy: phase 49.) ->
    results, with the launches by shape of each path under "shapes"."""
    import torch

    from icm_tpu_torch.nn import set_activation_dtype

    model = cz["model"]
    model.load_state_dict(init_state)
    zero_counts, read_counts = launch_counts("bfloat16")
    size = x.shape[1]
    N = model.ctx_slices
    expect = {"compress": czigzag_expect("compress", "bfloat16", rans_encode=2),
              "decompress": czigzag_expect("decompress", "bfloat16", rans_decode=N + 1)}
    set_activation_dtype(torch.bfloat16)
    try:
        dev = czigzag_codec(model, cz["up"], wire="device")
        enc, _, l, sh, syncs = codec_roundtrip(dev, x, zero_counts, read_counts,
                                             "czigzag bf16 device wire", expect)
        timing = codec_timing(dev, x, enc, reps=CRC_REPS)
    finally:
        set_activation_dtype(None)
    if enc["y_hat"].dtype != torch.bfloat16:
        raise AssertionError(f"czigzag bf16 device wire: y_hat {enc['y_hat'].dtype}")
    f32 = cz["device_enc"]
    bpp_rel = [b16 / b32 - 1 for b16, b32 in zip(crc_bytes(enc, size, "yz")["bpp"],
                                                  crc_bytes(f32, size, "yz")["bpp"])]
    x_hat_mean = (enc["x_hat"].float() - f32["x_hat"].float()).abs().mean().item()
    log(f"  czigzag bf16 device wire against f32: bpp {[f'{r:+.2e}' for r in bpp_rel]} (bar "
        f"{BF16_BPP_RTOL}), mean |x_hat - x_hat_f32| {x_hat_mean:.3e} (bar {BF16_XHAT_MEAN_TOL}); "
        "img/s " + " / ".join(timing_text(v) for v in timing.values()) + f" ({card})")
    if max(abs(r) for r in bpp_rel) > BF16_BPP_RTOL or not x_hat_mean < BF16_XHAT_MEAN_TOL:
        raise AssertionError(f"czigzag bf16 serving strays from f32: {bpp_rel}, {x_hat_mean}")
    out = {"device_wire": {**crc_bytes(enc, size, "yz"), "launches": l, "launches_by_shape": sh,
                           "host_round_trips_in_decompress": syncs, **timing,
                           "against_f32": dict(bpp_rel=bpp_rel, x_hat_mean_abs=x_hat_mean,
                                               bpp_rtol=BF16_BPP_RTOL,
                                               x_hat_mean_tol=BF16_XHAT_MEAN_TOL)}}
    out["card_vs_cpu"] = eval_vs_cpu_phase("czigzag", model, seed,
                                           cpu_model=cpu_twin("czigzag", model))
    gc.collect()
    step = czigzag_expect("compress", "bfloat16")
    out["train"] = bf16_train_phase(model, init_state, seed, card, step[0], f32_train, steps=2)
    if out["train"]["launches_by_shape_per_step"] != step[1]:
        raise AssertionError(f"czigzag bf16 step: launches by shape "
                             f"{out['train']['launches_by_shape_per_step']}, expected {step[1]}")
    out["shapes"] = {"launches_bf16_device_wire_compress": sh["compress"],
                     "launches_bf16_device_wire_decompress": sh["decompress"],
                     "launches_bf16_train_step": out["train"]["launches_by_shape_per_step"]}
    return out


def reference_czigzag_state_dict(seed: int) -> dict:
    """A reference conditionalZigzag state dict at full width: the
    reference's module names (czigzag.py: ``patch_embed``, the cross Swin
    stages ``layers`` / ``syn_layers`` with ``attn.q`` and ``attn.kv``, the
    pyramids ``encoder_context`` / ``hyper_context``, the hyper stacks
    ``hyper_encoder_layers`` / ``hyper_decoder_{mean,scale}`` and their
    convolutions, ``end_conv``, the 16 slices' ``*_transforms2`` stacks and
    the bottleneck; and the modules its forward never runs, which the
    converter drops: ``patch_embed_up``, ``decoder_context``, each
    pyramid's fourth conv), DataParallel's ``module.`` prefix, values drawn
    from ``seed`` as ``reference_wacnn_state_dict`` draws them."""
    import torch

    ref = _RefDraw(np.random.default_rng(seed), np.float32)
    embed, depths, heads, ws, M = 48, (2, 2, 6, 2), (3, 6, 12, 24), 4, 384
    sc, cond, cc = 96, 576, (224, 176, 128, 64)

    def lin(n, o, i, bias=True):
        ref.put(f"{n}.weight", (o, i), i ** -0.5)
        if bias:
            ref.put(f"{n}.bias", (o,), 0.01)

    def ln(n, c):
        ref.put(f"{n}.weight", (c,), 0.1, 1.0)
        ref.put(f"{n}.bias", (c,), 0.05)

    def blocks(prefix, dim, depth, h):
        for j in range(depth):
            b = f"{prefix}.blocks.{j}"
            ln(f"{b}.norm1", dim)
            lin(f"{b}.attn.q", dim, dim)
            lin(f"{b}.attn.kv", 2 * dim, dim)
            lin(f"{b}.attn.proj", dim, dim)
            ref.put(f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h), 0.02)
            ln(f"{b}.norm2", dim)
            lin(f"{b}.mlp.fc1", 4 * dim, dim)
            lin(f"{b}.mlp.fc2", dim, 4 * dim)

    for p in ("patch_embed", "patch_embed_up"):
        ref.conv(f"{p}.proj", embed, 3, 2)
        ln(f"{p}.norm", embed)
    for i in range(4):
        dim, rdim = embed * 2 ** i, embed * 2 ** (3 - i)
        blocks(f"layers.{i}", dim, depths[i], heads[i])
        blocks(f"syn_layers.{i}", rdim, depths[3 - i], heads[3 - i])
        if i < 3:
            lin(f"layers.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            ln(f"layers.{i}.downsample.norm", 4 * dim)
            lin(f"syn_layers.{i}.downsample.reduction", 2 * rdim, rdim, bias=False)
            ln(f"syn_layers.{i}.downsample.norm", rdim)
        for tag in ("encoder_context", "hyper_context", "decoder_context"):
            ref.conv(f"{tag}.{i}", 2 * dim, dim, 3)
    blocks("hyper_encoder_layers.0", M, 2, 4)
    blocks("hyper_encoder_layers.1", M // 2, 6, 4)
    ref.conv("hyper_encoder_Conv1", M // 2, M, 3)
    ref.conv("hyper_encoder_Conv1_2", M // 2, M, 3)
    ref.conv("hyper_encoder_Conv2", M // 2, M // 2, 3)
    for tag in ("mean", "scale"):
        blocks(f"hyper_decoder_{tag}.0", M // 2, 2, 4)
        blocks(f"hyper_decoder_{tag}.1", M, 6, 4)
        ref.conv(f"hyper_decoder_conv_{tag}1.0", 2 * M, M // 2, 3)
        ref.conv(f"hyper_decoder_conv_{tag}2", M, M // 2, 3)
    ref.conv("end_conv.0", 4 * embed, embed, 5)
    ref.conv("end_conv.2", 3, embed, 3)
    for i in range(16):
        for tag, extra in (("cc_mean_transforms2", 0), ("cc_scale_transforms2", 0),
                           ("lrp_transforms2", sc)):
            cin = (2 * cond + sc * min(i, 6) + extra,) + cc
            for j in range(4):
                ref.conv(f"{tag}.{i}.{2 * j}", cc[j], cin[j], 3)
            ref.conv(f"{tag}.{i}.8", sc, cc[-1], 3)
    ref.bottleneck("entropy_bottleneck", M // 2)
    return {"module." + k: torch.from_numpy(v) for k, v in ref.sd.items()}


def czigzag_reference_phase(cz: dict, x, card: str, zero_counts, read_counts, seed: int) -> dict:
    """Phase 52: a reference czigzag checkpoint at full width, as phase 18:
    the seeded reference dict converted and loaded strictly; the converted
    model's own CDF tables written into it as the reference's buffers and
    imported back equal; phase 5's images and up_x4 on the host wire with
    the imported tables, held by ``codec_roundtrip``, their nonzero y
    symbols above 0, the blobs equal to the built tables'. -> results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import build_codec_tables

    model = cz["model"]
    t = time.time()
    sd = reference_czigzag_state_dict(seed)
    model.load_state_dict(zoo.convert_reference_state_dict("czigzag", sd), strict=True)
    built = build_codec_tables(model)
    stored = {"gaussian_conditional": built.gaussian, **built.bottlenecks}
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            sd[f"module.{prefix}._{field}"] = torch.from_numpy(getattr(tab, field))
    sd["module.gaussian_conditional.scale_table"] = torch.from_numpy(built.scale_table)
    imported = zoo.import_reference_tables(sd)
    got = {"gaussian_conditional": imported.gaussian, **imported.bottlenecks}
    if set(got) != set(stored) or not np.array_equal(imported.scale_table, built.scale_table):
        raise AssertionError(f"imported tables {sorted(got)}, stored {sorted(stored)}")
    for prefix, tab in stored.items():
        for field in ("quantized_cdf", "offset", "cdf_length"):
            if not np.array_equal(getattr(got[prefix], field), getattr(tab, field)):
                raise AssertionError(f"imported {prefix} {field} differs from the stored one")
    log(f"  {len(sd)} reference tensors converted, loaded strictly and tables imported in "
        f"{time.time() - t:.1f}s")
    codec = czigzag_codec(model, cz["up"], tables=imported)
    syms = codec.symbols(x, cz["up"])["y_hat"]
    nonzero = [sum(int(s.count_nonzero()) for s in syms), sum(s.numel() for s in syms)]
    if nonzero[0] < 1:
        raise AssertionError("czigzag reference: every y symbol is 0")
    enc, _, l, shapes, _ = codec_roundtrip(codec, x, zero_counts, read_counts,
                                         "czigzag reference, host wire",
                                         {side: czigzag_expect(side) for side in SIDES})
    if czigzag_codec(model, cz["up"]).compress(x)["strings"] != enc["strings"]:
        raise AssertionError("imported tables' blobs differ from the built tables' ones")
    sha = {k: hashlib.sha256(b"".join(enc["strings"][i])).hexdigest() for i, k in enumerate("yz")}
    log(f"  nonzero y symbols {nonzero} ({nonzero[0] / nonzero[1]:.3%}); blobs with imported "
        f"tables = built tables; sha256 {sha}")
    return {"tensors": len(sd), "nonzero_y_symbols": nonzero, **crc_bytes(enc, x.shape[1], "yz"),
            "blob_sha256": sha, "launches_reference_compress": l["compress"],
            "launches_reference_decompress": l["decompress"],
            "shapes_reference_compress": shapes["compress"],
            "shapes_reference_decompress": shapes["decompress"]}


def czigzag_model_phases(x, card: str, zero_counts, read_counts, seed: int) -> tuple:
    """Every phase of czigzag, in order: its wires and eval forward
    (``czigzag_phase``), its training (3 steps of 8 x 256^2 at the
    registry's stochastic depth 0.2, each launching CZIGZAG_STEP_LAUNCHES,
    every parameter moved, the checkpoint written; one step on the card
    against the plain CPU path), its bfloat16 policy from the weights
    training started from (``czigzag_bf16_phase``) and its reference
    checkpoint. -> (results, float32 launch counts by path, launches by
    shape by path)."""
    import torch

    with Phase("full-width czigzag: host, device and scan wires, card vs CPU"):
        cz = czigzag_phase(x, card, zero_counts, read_counts, seed)
    result, counts, shapes, model = cz["result"], cz["counts"], cz["shapes"], cz["model"]
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with Phase("full-width czigzag training, card vs CPU"):
        step = czigzag_expect("compress")
        result["train"] = train_phase(model, seed, card, step[0], steps=3, resumed_steps=0)
        if result["train"]["launches_by_shape_per_step"] != step[1]:
            raise AssertionError(f"czigzag step: launches by shape "
                                 f"{result['train']['launches_by_shape_per_step']}")
        result["train"]["card_vs_cpu"] = train_vs_cpu_phase("czigzag", model, seed)
    counts["launches_train_step"] = result["train"]["launches_per_step"]
    shapes["launches_train_step"] = result["train"]["launches_by_shape_per_step"]
    with Phase("full-width czigzag under the bf16 policy: device wire, card vs CPU layer by "
               "layer, training"):
        result["bf16"] = czigzag_bf16_phase(cz, x, card, init_state, result["train"], seed)
    shapes.update(result["bf16"].pop("shapes"))
    del init_state
    with Phase("reference checkpoint: full-width czigzag, imported tables"):
        result["reference"] = czigzag_reference_phase(cz, x, card, zero_counts, read_counts, seed)
    for side in SIDES:
        key = f"launches_reference_{side}"
        counts[key] = result["reference"][key]
        shapes[key] = result["reference"][f"shapes_reference_{side}"]
    del cz, model
    gc.collect()
    torch.cuda.empty_cache()
    return result, counts, shapes


def cnn2_detect(codec, enc, zero_counts, read_counts, expect: dict, what: str) -> tuple:
    """cnn2's serving call (``models.decompress_detect``: the codec's
    decompress, the student on x_hat, the host-side NMS of each image) on
    ``enc``'s blobs, the counts zeroed right before and read right after:
    its launches exactly ``expect``, the wire's own decompress counts (the
    student adds none); y_hat and x_hat the encoder's; the maps finite and
    laid over the anchors; every detection above the score threshold and
    inside the image. -> (results, the call's output)."""
    import torch

    from icm_tpu_torch.models import decompress_detect

    torch.cuda.synchronize()
    zero_counts()
    t = time.time()
    out = decompress_detect(codec, enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    seconds = time.time() - t
    launches = read_counts()
    check_launches(f"{what}: decompress_detect", launches, expect)
    if not torch.equal(out["y_hat"], enc["y_hat"]) or not torch.equal(out["x_hat"], enc["x_hat"]):
        raise AssertionError(f"{what}: decompress_detect's y_hat or x_hat differs from the "
                             "encoder's")
    cls, reg, anchors = out["classification"], out["regression"], out["anchors"]
    B, A, K = cls.shape
    H, W = out["x_hat"].shape[1:3]
    if (reg.shape != (B, A, 4) or anchors.shape != (1, A, 4) or len(out["detections"]) != B
            or not all(bool(torch.isfinite(t).all()) for t in (cls, reg))):
        raise AssertionError(f"{what}: maps {tuple(cls.shape)} / {tuple(reg.shape)} / "
                             f"{tuple(anchors.shape)} or not finite")
    for scores, labels, boxes in out["detections"]:
        if len(scores) and (scores.min() <= 0.05 or labels.max() >= K or boxes.min() < 0
                            or boxes[:, 2].max() > W or boxes[:, 3].max() > H):
            raise AssertionError(f"{what}: a detection out of bounds")
    result = dict(seconds=seconds, launches=launches, anchors=A, classes=K,
                  detections=[len(d[0]) for d in out["detections"]],
                  scores_above_threshold=float((cls > 0.05).float().mean()))
    log(f"  {what}: decompress_detect {seconds:.3f}s, launches {launches}; detections "
        f"{result['detections']} ({result['scores_above_threshold']:.3%} of {B} x {A} x {K} "
        "scores above 0.05)")
    return result, out


def cnn_refs(x, zero_counts, read_counts, seed: int) -> dict:
    """What cnn2's phases are held to, for a run of them without cnn's
    phases (tools/torch_smoke_models.py): cnn from the same seed, phase 5's
    host-wire encoder output, and the blobs' sha256 and launch counts of its
    device wire (phase 7), scan wire (7a), device wire under the bfloat16
    policy (7b) and reference checkpoint on the host wire (18)."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.nn import set_activation_dtype

    def sides(codec, zero, read):
        zero()
        enc = codec.compress(x, return_debug=True)
        torch.cuda.synchronize()
        enc_l = read()
        zero()
        codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        return enc, enc_l, read()

    model = create_model("cnn", seed=seed)
    out = {"enc": CharmCodec(model, narrow=0.2).compress(x, return_debug=True)}
    dev = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2)
    enc, out["device_compress"], out["device_decompress"] = sides(dev, zero_counts, read_counts)
    out["device_sha256"] = blob_sha256(enc)
    scan = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2, scan_wire=True)
    out["scan_sha256"] = blob_sha256(scan.compress(x))
    zero16, read16 = launch_counts("bfloat16")
    set_activation_dtype(torch.bfloat16)
    try:
        _, out["bf16_device_compress"], out["bf16_device_decompress"] = sides(dev, zero16, read16)
    finally:
        set_activation_dtype(None)
    sd = reference_wacnn_state_dict(seed)
    model.load_state_dict(zoo.convert_reference_state_dict("cnn", sd), strict=True)
    ref = CharmCodec(model, tables=stored_wacnn_tables(sd, model), ref_layout=True, narrow=0.2)
    enc, out["reference_compress"], out["reference_decompress"] = sides(ref, zero_counts,
                                                                        read_counts)
    out["reference_sha256"] = blob_sha256(enc)
    del model, dev, scan, ref
    torch.cuda.empty_cache()
    return out


def reference_cnn2_state_dict(seed: int) -> dict:
    """A reference cnn2 state dict at full width: phase 18's reference WACNN
    dict (``module.`` prefix and all) with the RetinaNet student under
    ``studentNet.`` (torchvision ResNet-50 names ``conv1``, ``bn1``,
    ``layer{L}.{i}.conv{k}`` / ``bn{k}`` / ``downsample.0`` / ``.1``; the
    pyramid ``fpn.P3_1`` ... ``P7_2``; ``regressionModel`` and
    ``classificationModel`` with ``conv1``-``conv4`` and ``output``, the
    classification bias at the focal-loss prior), each BatchNorm with its
    running statistics and ``num_batches_tracked``, and the stem of the
    frozen ``teacherNet``, which the conversion drops; the student drawn from
    ``seed`` + 1 (``_RefDraw``)."""
    import torch

    sd = reference_wacnn_state_dict(seed)
    ref = _RefDraw(np.random.default_rng(seed + 1))

    def conv(name, o, i, k):  # the ResNet's convolutions have no bias
        ref.put(f"{name}.weight", (o, i, k, k), (i * k * k) ** -0.5)

    def bn(name, c):
        ref.put(f"{name}.weight", (c,), 0.1, 1.0)
        ref.put(f"{name}.bias", (c,), 0.1)
        ref.put(f"{name}.running_mean", (c,), 0.1)
        ref.sd[f"{name}.running_var"] = (1.0 + 0.1 * np.abs(ref.normal(c))).astype(np.float32)
        ref.sd[f"{name}.num_batches_tracked"] = np.array(1000, np.int64)

    for net in ("studentNet", "teacherNet"):
        conv(f"{net}.conv1", 64, 3, 7)
        bn(f"{net}.bn1", 64)
    c_in = 64
    for L, (w, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), start=1):
        for i in range(n):
            block = f"studentNet.layer{L}.{i}"
            for k, (o, c, size) in enumerate(((w, c_in, 1), (w, w, 3), (4 * w, w, 1)), start=1):
                conv(f"{block}.conv{k}", o, c, size)
                bn(f"{block}.bn{k}", o)
            if i == 0:
                conv(f"{block}.downsample.0", 4 * w, c_in, 1)
                bn(f"{block}.downsample.1", 4 * w)
            c_in = 4 * w
    for name, c, k in (("P5_1", 2048, 1), ("P5_2", 256, 3), ("P4_1", 1024, 1), ("P4_2", 256, 3),
                       ("P3_1", 512, 1), ("P3_2", 256, 3), ("P6", 2048, 3), ("P7_2", 256, 3)):
        ref.conv(f"studentNet.fpn.{name}", 256, c, k)
    for head, outputs in (("regressionModel", 9 * 4), ("classificationModel", 9 * 80)):
        for j in range(1, 5):
            ref.conv(f"studentNet.{head}.conv{j}", 256, 256, 3)
        ref.conv(f"studentNet.{head}.output", outputs, 256, 3)
    ref.sd["studentNet.classificationModel.output.bias"] = np.full(9 * 80, -np.log(99.0),
                                                                  np.float32)
    sd.update({"module." + k: torch.from_numpy(np.asarray(v)) for k, v in ref.sd.items()})
    return sd


def cnn2_reference_phase(model, x, zero_counts, read_counts, seed: int, cnn: dict) -> dict:
    """Phase 18c: the seeded reference cnn2 dict (``reference_cnn2_state_dict``)
    converted (``zoo.convert_reference_state_dict``) and loaded strictly
    into ``model``, its codec's tensors bit for bit those of phase 18's cnn
    conversion of the same codec keys, the teacher and
    ``num_batches_tracked`` dropped; the tables stored and imported as
    phase 18's; then on the host wire in the reference symbol order: the
    blobs and launch counts phase 18's, and the serving call
    (``cnn2_detect``) on them. -> results."""
    import torch

    from icm_tpu_torch import zoo
    from icm_tpu_torch.models import CharmCodec

    t = time.time()
    sd = reference_cnn2_state_dict(seed)
    converted = zoo.convert_reference_state_dict("cnn2", sd)
    model.load_state_dict(converted, strict=True)
    as_cnn = zoo.convert_reference_state_dict("cnn", {
        k: v for k, v in sd.items()
        if not k.startswith(("module.studentNet.", "module.teacherNet."))})
    student = {k for k in converted if k.startswith("studentNet.")}
    if set(converted) != set(as_cnn) | student or not all(
            torch.equal(converted[k], v) for k, v in as_cnn.items()):
        raise AssertionError("reference cnn2: its codec's conversion differs from cnn's")
    stats = sum(k.endswith((".mean", ".var")) for k in student)
    imported = stored_wacnn_tables(sd, model)
    log(f"  {len(sd)} reference tensors ({sum(k.startswith('module.teacherNet.') for k in sd)} "
        f"of the teacher) converted to {len(converted)}, {stats} of them BatchNorm statistics, "
        f"loaded strictly and tables imported in {time.time() - t:.1f}s")
    codec = CharmCodec(model, tables=imported, ref_layout=True, narrow=0.2)
    zero_counts()
    enc = codec.compress(x, return_debug=True)
    torch.cuda.synchronize()
    enc_l = read_counts()
    check_launches("reference cnn2, compress", enc_l, cnn["reference_compress"])
    sha = blob_sha256(enc)
    if sha != cnn["reference_sha256"]:
        raise AssertionError("reference cnn2: its blobs differ from the reference cnn's")
    result, _ = cnn2_detect(codec, enc, zero_counts, read_counts, cnn["reference_decompress"],
                            "reference cnn2, host wire")
    result.update(tensors=len(sd), converted=len(converted), batchnorm_statistics=stats,
                  blob_sha256=sha, launches_compress=enc_l)
    return result


def step_with_without_student(model, seed: int) -> list:
    """The unread student's cost in a float32 training step of cnn2 (8 x
    256^2): after a step of each, CNN2_AB_TURNS steps with it and as many
    without it (``with_task_net`` off for the step), in turns (with,
    without, without, with), host clock to a synchronize. -> [median ms
    with, without]."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.train import (RateDistortionLoss, TrainState, make_optimizer,
                                     make_train_step)

    xb = torch.from_numpy(make_images(seed + 100, 8, 256)).cuda()
    state = TrainState(model, make_optimizer(model))
    step = make_train_step(model, RateDistortionLoss(0.01))
    times = {True: [], False: []}
    for i in range(-2, 2 * CNN2_AB_TURNS):  # two warm-up steps
        student = i % 4 in (0, 3)
        model.with_task_net = student
        try:
            torch.cuda.synchronize()
            t = time.time()
            step(state, xb, torch.Generator().manual_seed(seed))
            torch.cuda.synchronize()
        finally:
            model.with_task_net = True
        if i >= 0:
            times[student].append(1e3 * (time.time() - t))
    model.zero_grad(set_to_none=True)
    return [float(np.median(times[True])), float(np.median(times[False]))]


def cnn2_model_phases(x, card: str, zero_counts, read_counts, seed: int, cnn: dict) -> tuple:
    """Phases 18a-18c, cnn2 at full width on phase 5's images, held to cnn's
    results ``cnn`` (``cnn_refs`` gives them): 18a its device and scan
    wires, detection on the decoded images, the student card against CPU
    and the bfloat16 policy's serving; 18b training; 18c a reference
    checkpoint. -> (results, float32 launch counts by path, bfloat16
    launch counts by path)."""
    import torch

    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import DeviceWireCodec, create_model
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.tasks import RetinaNet, decode_batch

    size = x.shape[1]
    dev_expect = {"compress": cnn["device_compress"], "decompress": cnn["device_decompress"]}
    with Phase("full-width cnn2: device and scan wires, detection on the decoded images, "
               "student card vs CPU, bf16 policy"):
        t = time.time()
        model = create_model("cnn2", seed=seed)
        with torch.no_grad():
            for name, gain in CNN2_GAIN.items():
                model.get_parameter(name).mul_(gain)
        student = model.studentNet
        n_params = sum(p.numel() for p in model.parameters())
        n_student = sum(p.numel() for p in student.parameters())
        dev = DeviceWireCodec(model, lanes_per_image=1024, narrow=0.2)
        torch.cuda.synchronize()
        log(f"  cnn2: {n_params / 1e6:.1f} M parameters (student {n_student / 1e6:.1f} M, "
            f"scaled {CNN2_GAIN}) and the device wire in {time.time() - t:.1f}s")
        # (18a) the device wire: cnn's blobs, y_hat (phase 5's host wire)
        # and launches; then the serving call on it
        result, dev_enc_l, dev_dec_l = device_wire_phase(dev, cnn["enc"], x, card, zero_counts,
                                                         read_counts, dev_expect)
        if result["blob_sha256"] != cnn["device_sha256"]:
            raise AssertionError("cnn2's device-wire blobs differ from cnn's")
        enc = dev.compress(x, return_debug=True)
        result["detect"], det = cnn2_detect(dev, enc, zero_counts, read_counts, dev_dec_l,
                                            "device wire")
        if not all(result["detect"]["detections"]):
            raise AssertionError("cnn2: an image without detections; CNN2_GAIN is to make "
                                 "the seeded student detect")
        # the graphed scan wire, and the serving call on its graphs
        result["scan_wire"], scan_enc_l, scan_dec_l = scan_wire_phase(
            model, dev, x, card, zero_counts, read_counts, dev_expect,
            {"compress": dev_enc_l, "decompress": dev_dec_l},
            serve=lambda codec, e: cnn2_detect(codec, e, zero_counts, read_counts, dev_dec_l,
                                               "scan wire")[0])
        if result["scan_wire"]["blob_sha256"] != cnn["scan_sha256"]:
            raise AssertionError("cnn2's scan-wire blobs differ from cnn's")

        # the student alone on the decoded images: its device time against
        # the decompress's, and the host's NMS decode
        x_hat = det["x_hat"]
        with torch.no_grad():
            student_ms = cuda_ms(lambda: student(x_hat), iters=5)
            _, student_busy = profiled_call(lambda: student(x_hat))
        dec_busy = result["device"]["decompress"]["device_busy_ms"]
        t = time.time()
        decode_batch(det["classification"], det["regression"], det["anchors"], (size, size))
        host_s = time.time() - t
        result["student"] = dict(
            ms=student_ms, device_busy_ms=student_busy, decompress_busy_ms=dec_busy,
            share_of_detecting_decompress=student_busy / (student_busy + dec_busy),
            host_decode_s=host_s, map_bytes=4 * (det["classification"].numel()
                                                 + det["regression"].numel()))
        log(f"  student on 2 x {size}^2: {student_ms:.2f} ms (CUDA events, median of 5), busy "
            f"{student_busy:.2f} ms against the device-wire decompress's {dec_busy:.2f} ms "
            f"({result['student']['share_of_detecting_decompress']:.1%} of a detecting "
            f"decompress); host decode (maps to the host, NMS) {host_s:.3f}s for "
            f"{result['student']['map_bytes'] / 1e6:.1f} MB of maps ({card})")

        # the student on the card against its CPU twin on the same x_hat
        with torch.device("meta"):
            cpu_student = RetinaNet(num_classes=student.num_classes)
        cpu_student = cpu_student.to_empty(device="cpu").eval()
        cpu_student.load_state_dict(student.state_dict())
        t = time.time()
        with torch.no_grad():
            _, _, cls_cpu, reg_cpu, anchors_cpu = cpu_student(x_hat.cpu())
        errs = {name: ((det[name].cpu() - ref).abs().max() / ref.abs().max()).item()
                for name, ref in (("classification", cls_cpu), ("regression", reg_cpu))}
        log(f"  student card vs CPU on the card's x_hat: max |card - cpu| / max |cpu| {errs} "
            f"(bar {CNN2_STUDENT_TOL}; CPU {time.time() - t:.1f}s)")
        if not torch.equal(det["anchors"].cpu(), anchors_cpu) or max(errs.values()) > \
                CNN2_STUDENT_TOL:
            raise AssertionError(f"cnn2's student: card and CPU disagree: {errs}")
        result["student"]["card_vs_cpu"] = dict(relative=errs, tolerance=CNN2_STUDENT_TOL)
        del cpu_student, det

        # the bfloat16 policy: the codec in bfloat16 with cnn's bfloat16
        # launches, the student in float32 on the bfloat16 x_hat (the JAX
        # package's tasks take no activation dtype)
        zero16, read16 = launch_counts("bfloat16")
        set_activation_dtype(torch.bfloat16)
        try:
            zero16()
            enc16 = dev.compress(x, return_debug=True)
            torch.cuda.synchronize()
            bf16_enc_l = read16()
            check_launches("bf16 device wire, compress", bf16_enc_l, cnn["bf16_device_compress"])
            result["bf16"], det16 = cnn2_detect(dev, enc16, zero16, read16,
                                                cnn["bf16_device_decompress"],
                                                "device wire under the bf16 policy")
            with torch.no_grad():
                result["bf16"]["student_ms"] = cuda_ms(lambda: student(det16["x_hat"]), iters=5)
        finally:
            set_activation_dtype(None)
        dtypes = {k: det16[k].dtype for k in ("x_hat", "classification", "regression")}
        log(f"  bf16 policy: dtypes {dtypes}; student {result['bf16']['student_ms']:.2f} ms")
        if dtypes != {"x_hat": torch.bfloat16, "classification": torch.float32,
                      "regression": torch.float32}:
            raise AssertionError(f"cnn2 under the bf16 policy: dtypes {dtypes}")
        result["bf16"]["launches_compress"] = bf16_enc_l
        del det16, enc16, enc

    # (18b) training: the student runs in each step's forward, no loss
    # reads it, so its parameters and BatchNorm statistics stay
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    stats = {k: v for k, v in init_state.items()
             if k.startswith("studentNet.") and k.endswith((".mean", ".var"))}
    with Phase("full-width cnn2 training, f32 and under the bf16 policy"):
        xb = torch.from_numpy(make_images(seed + 100, 8, 256)).cuda()
        with torch.enable_grad():  # as in a training step's forward
            step_student_ms = cuda_ms(lambda: student(xb), iters=5)
        del xb
        train = train_phase(model, seed, card, TRAIN_STEP_LAUNCHES, steps=TRAIN_STEPS,
                            resumed_steps=0, fixed=("studentNet.",))
        train["student_forward_ms"] = step_student_ms
        train["bf16"] = bf16_train_phase(model, init_state, seed, card, TRAIN_STEP_LAUNCHES,
                                         train, steps=TRAIN_STEPS, fixed=("studentNet.",))
        train["step_ms_with_without_student"] = step_with_without_student(model, seed)
        moved = [k for k, v in stats.items() if not torch.equal(model.get_buffer(k), v)]
        log(f"  student forward in a step (8 x 256^2, autograd on): {step_student_ms:.2f} ms; "
            f"step ms with / without the student (median of {CNN2_AB_TURNS} each, in turns): "
            f"{train['step_ms_with_without_student']}; {len(stats)} BatchNorm statistics, "
            f"{len(moved)} moved ({card})")
        if moved:
            raise AssertionError(f"cnn2 training moved BatchNorm statistics: {moved[:4]}")
        result["train"] = train
    del init_state, stats

    with Phase("reference checkpoint: full-width cnn2, imported tables, reference order"):
        result["reference"] = cnn2_reference_phase(model, x, zero_counts, read_counts, seed, cnn)
    counts = {"launches_device_wire_compress": dev_enc_l,
              "launches_device_wire_decompress": dev_dec_l,
              "launches_detect_device_wire": result["detect"]["launches"],
              "launches_scan_wire_compress": scan_enc_l,
              "launches_scan_wire_decompress": scan_dec_l,
              "launches_detect_scan_wire": result["scan_wire"]["serve"]["launches"],
              "launches_train_step": train["launches_per_step"],
              "launches_reference_compress": result["reference"]["launches_compress"],
              "launches_detect_reference": result["reference"]["launches"]}
    bf16_counts = {"launches_device_wire_compress": bf16_enc_l,
                   "launches_detect_device_wire": result["bf16"]["launches"],
                   "launches_train_step": train["bf16"]["launches_per_step"]}
    result.update(parameters=n_params, student_parameters=n_student, gain=CNN2_GAIN)
    del model, dev, student
    gc.collect()
    torch.cuda.empty_cache()
    return result, counts, bf16_counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from icm_tpu_torch.data import make_images
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.nn import gdn_fused as tgdn
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.nn import window_attention as twa
    from icm_tpu_torch.nn.swin import SwinBlock

    with Phase("environment"):
        card = environment()

    with Phase("build"):
        # window attention's 56 template instances take the longest; the GDN
        # phase, which needs no attention, runs while they compile
        finish_attention = build_kernels(later=("kernels",))

    # the codec's numerics (full f32, deterministic cuDNN) for every phase
    from icm_tpu_torch.models import cuda_numerics
    cuda_numerics()

    with Phase("GDN kernels vs plain"):
        gdn_rows = check_gdn(tgdn)

    with Phase("build: window attention"):
        finish_attention()

    with Phase("window attention vs plain"):
        rows = check_kernel(twa)

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

    # cnn2: cnn's codec with a detector on x_hat, held to cnn's phases
    cnn = {"enc": enc, "device_compress": dev_enc_launches, "device_decompress": dev_dec_launches,
           "device_sha256": slice_result["device_wire"]["blob_sha256"],
           "scan_sha256": slice_result["scan_wire"]["blob_sha256"],
           "bf16_device_compress": bf16_counts["device_compress"],
           "bf16_device_decompress": bf16_counts["device_decompress"],
           "reference_compress": ref_counts["launches_reference_compress"],
           "reference_decompress": ref_counts["launches_reference_decompress"],
           "reference_sha256": slice_result["reference"]["blob_sha256"]}
    slice_result["cnn2"], paths["float32"]["cnn2"], paths["bfloat16"]["cnn2"] = (
        cnn2_model_phases(x, card, zero_counts, read_counts, args.seed, cnn))
    del cnn, enc

    family_transforms = {}  # each family model's g_a and g_s launches by side
    # the family's launch-by-launch wires at FAMILY_WIRE_SIZE, its scan wire at 512
    x_fam = torch.from_numpy(make_images(args.seed, B, FAMILY_WIRE_SIZE)).cuda()
    for name in FAMILY:
        with Phase(f"full-width {name}: host wire, device wire at {FAMILY_WIRE_SIZE} px, "
                   "card vs CPU"):
            fam = family_phase(name, x_fam, card, zero_counts, read_counts, args.seed, rans_rows)
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
                 "decompress": counts["launches_device_wire_decompress"]}, FAMILY_REPS,
                idle_wires=FAMILY_SCAN_IDLE)
            counts.update(launches_scan_wire_compress=scan_enc_l,
                          launches_scan_wire_decompress=scan_dec_l)
        with Phase(f"full-width {name} under the bf16 policy, both wires at "
                   f"{FAMILY_WIRE_SIZE} px"):
            result["bf16"], bf16_l = bf16_serving_phase(
                fam["codec"], fam["dev"], x_fam, card,
                {"result": result, "enc": fam["enc"],
                 "counts": {"compress": counts["launches_compress"],
                            "decompress": counts["launches_decompress"],
                            "device_compress": counts["launches_device_wire_compress"],
                            "device_decompress": counts["launches_device_wire_decompress"]}},
                FAMILY_REPS, idle=False)
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
        slice_result[name], paths["float32"][name], crc_shapes[name] = crc_model_phases(
            name, x, card, zero_counts, read_counts, args.seed)

    for name in MASKED:
        slice_result[name], paths["float32"][name], paths["bfloat16"][name] = (
            masked_model_phases(name, card, zero_counts, read_counts, args.seed))

    # czigzag: its window-attention launches by head width (16, 48, 96) on
    # each path are kept beside the CRC family's (crc_shapes), in both builds
    slice_result["czigzag"], paths["float32"]["czigzag"], crc_shapes["czigzag"] = (
        czigzag_model_phases(x, card, zero_counts, read_counts, args.seed))

    def crc_launches(group: str, key: str) -> dict:
        """A kernel build's launches on every CRC path, by shape key."""
        per = {f"{path}_{m}": shapes[group].get(key, 0)
               for m, by_path in crc_shapes.items() for path, shapes in by_path.items()}
        return {"launches": sum(per.values()), **per}

    def with_crc(launches: dict, group: str, key: str) -> dict:
        """``launches`` (its own paths' sum kept as ``launches``) with the
        CRC paths' launches of the same build (``crc_launches``) beside it:
        each path's under its key with ``_crc`` added, their sum as
        ``launches_crc``."""
        crc = crc_launches(group, key)
        return {**launches, **{f"{k}_crc": v for k, v in crc.items()}}

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
        # the masked family's transforms, and czigzag's (its paths' D 16
        # launches: its analysis and synthesis blocks)
        masked = launch_keys("window_attention", MASKED, dtype)
        cz = {k: n for k, n in crc_launches("window_attention", f"{dtype} D16").items()
              if k.endswith("_czigzag")}
        d16_launches = {**d16_launches, **fam, **masked, **cz,
                        "launches": d16_launches["launches"] + fam["launches"]
                        + masked["launches"] + sum(cz.values())}
        return [{
            "name": "window_attention" + suffix,
            "route": "cuda",
            "source": "icm_tpu_torch/csrc/window_attention.cu",
            "replaces": "icm_tpu/nn/pallas_kernels.py:33",
            "dtype": dtype,
            # WACNN's paths (cnn's and cnn2's), and the CRC family's g_a
            # (head width 24)
            **with_crc(launch_keys("window_attention", ("cnn", "cnn2"), dtype),
                       "window_attention", f"{dtype} D24"),
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
            "per": "one g_a or g_s pass of 2 x 512^2 (stf4's at 256^2 a quarter of the "
                   "windows): " + ", ".join(
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

    # the CRC family's head widths 32, 48 and 96 in both builds (the
    # bfloat16 ones on stf12's bfloat16 paths) and czigzag's hyper stacks'
    # 48 and 96 (crc_shapes["czigzag"]); one launch at the path's shape
    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
        for D, (W, N) in CRC_ATTENTION_SHAPES.items():
            crc_rows = [r for r in rows if r["model"] in ("crc", "czigzag") and r["D"] == D
                        and r["dtype"] == dtype]
            main = [r for r in crc_rows if r["model"] == "crc" and r["W"] == W
                    and r["n_cls"] == 4]
            cz = [r for r in crc_rows if r["model"] == "czigzag" and r["n_cls"] == 4]
            kernels.append({
                "name": f"window_attention_d{D}{suffix}",
                "route": "cuda",
                "source": "icm_tpu_torch/csrc/window_attention.cu",
                "replaces": "icm_tpu/nn/pallas_kernels.py:33",
                "dtype": dtype,
                **crc_launches("window_attention", f"{dtype} D{D}"),
                "per": f"one launch at W={W}, H=8, N={N}, D={D}, 4 window classes (2 x 512^2 "
                       "serving, 8 x 256^2 training)",
                "max_abs_err": max(r["max_abs_err"] for r in crc_rows),
                **{key: main[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "f32_fma_bound_ms", "library_ms")},
                # czigzag's hyper stacks (D 48, 96): one launch at W=128, H=4
                **({"czigzag_shape": {key: cz[0][key] for key in (
                    "W", "heads", "N", "ms", "plain_ms", "bound_ms", "bound_by",
                    "f32_fma_bound_ms", "library_ms")}} if cz else {}),
                "bound_unit": ("3xTF32 on the tensor cores (495 TFLOP/s dense), softmax at 67"
                               if dtype == "float32" else
                               "bf16 on the tensor cores (989 TFLOP/s dense), softmax at 67"),
                "tolerance": TOLERANCE[dtype],
                "cases": crc_rows,
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
                # cnn's and cnn2's paths, and the CRC family's 192-channel layers
                **with_crc(launch_keys(name, ("cnn", "stf", "cnn2"), dtype), "gdn",
                           f"{part} {dtype} C192"),
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
    # the GDN kernels at 256 channels on the CRC path (in float32 gamma
    # resident over a two-block cluster: gdn_fwd_kernel_cluster,
    # gdn_bwd_kernel_dx_cluster; in bfloat16 in one block:
    # gdn_fwd_kernel_bf16, gdn_bwd_kernel_dx_bf16; beside the backward's
    # dgamma and reduce kernels): the forward at the serving shape, the
    # backward at the training step's, split into its kernels; the bfloat16
    # builds (stf12's and stf13's bfloat16 paths) at the same shapes
    for dtype, suffix, design in (("float32", "", "cluster"), ("bfloat16", "_bf16", "bf16")):
        rows_256 = [r for r in gdn_rows if r["C"] == 256 and r["dtype"] == dtype]
        for name, part, err_key, line, path, kernel in (
                ("gdn_forward", "forward", "y", 50, "crc_serve", f"gdn_fwd_kernel_{design}"),
                ("gdn_backward", "backward", "dx", 64, "crc_train",
                 f"gdn_bwd_kernel_dx_{design}")):
            main = [r for r in rows_256 if r["path"] == path and r["inverse"]][0]
            kernels.append({
                "name": f"{name}_c256{suffix}",
                "route": "cuda",
                "source": "icm_tpu_torch/csrc/gdn.cu",
                "replaces": f"icm_tpu/nn/gdn_pallas.py:{line}",
                "kernel": kernel,
                "dtype": dtype,
                **crc_launches("gdn", f"{part} {dtype} C256"),
                "per": f"one IGDN launch at {main['B']} x 256 x {main['H']}^2",
                "max_abs_err": max(r["max_abs_err"][err_key] for r in rows_256),
                **{key: main[part][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "f32_fma_bound_ms")},
                **({"split_ms": main[part]["split_ms"]} if part == "backward" else {}),
                "bound_unit": (
                    "3xTF32 on the tensor cores (495 TFLOP/s dense), elementwise at 67; "
                    "4-byte activations" if dtype == "float32" else
                    f"{GDN_BF16_PASSES[part]} bfloat16 passes of its products on the tensor "
                    "cores (989 TFLOP/s dense), elementwise at 67; 2-byte activations"),
                "library_ms": None,
                "library_note": no_library,
                "tolerance": GDN_TOLERANCE if dtype == "float32" else GDN_BF16_TOLERANCE,
                "cases": [{k: v for k, v in r.items() if k not in ("forward", "backward")}
                          | r[part] for r in rows_256],
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
            **launch_keys(name, ("cnn", "stf", "cnn2") + FAMILY + CRC + MASKED + ("czigzag",)),
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
