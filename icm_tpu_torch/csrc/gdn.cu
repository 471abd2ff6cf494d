// Fused GDN / IGDN, forward and backward, for Hopper (sm_90a), with float32
// or bfloat16 activations.
//
// Replaces two TPU Pallas kernels of icm_tpu/nn/gdn_pallas.py:
//   _fwd_kernel  (forward)   y = x * (beta + Gamma x^2)^(-1/2)   (IGDN: ^(+1/2))
//   _bwd_kernel  (backward)  recompute n = beta + Gamma x^2, then
//       r  = n^(-1/2)
//       dn = -1/2 g x r^3           (IGDN: +1/2 g x r)
//       dx = g r + 2 x (Gamma^T dn)  (IGDN: g n r + ...)
//       dGamma = sum over pixels of dn (x^2)^T,  dbeta = sum over pixels of dn
//
// Layout: activations are NCHW, read as (B, C, P) with P = H * W pixels, so
// per image the normalizer is a (C x C) . (C x P) product with the pixels
// contiguous; no transposed copy is made. gamma is (C_out, C_in), row-major
// (the port's orientation), and dGamma comes out in the same orientation.
//
// Element types, as the Pallas kernels take them (gdn_pallas.py:50-99): x,
// g, y and dx are float32 or bfloat16 (chosen by the C entries' dtype
// code); beta, dn, dGamma and dbeta are float32; gamma comes in x's dtype
// and the wrapper rounds dGamma to it. Two sets of kernels:
// - float32, and bfloat16 above 256 channels (the template parameter T of
//   gdn_fwd_kernel_fma, gdn_bwd_kernel_dx_streamed and
//   gdn_bwd_kernel_dgamma; gamma handed over in float32): 3xTF32 products
//   on f32 tiles; in bfloat16 x and g are converted to f32 on their way
//   into shared memory, and gamma's bfloat16 values are TF32 values, so
//   its low pass is left out (two TF32 passes, the same sums).
// - The bfloat16 design, 1 <= C <= 256 (gdn_fwd_kernel_bf16,
//   gdn_bwd_kernel_dx_bf16, gdn_bwd_kernel_dgamma_bf16): the products run
//   in bfloat16 on the tensor cores (mma.sync m16n8k16, f32 accumulators),
//   each operand cut into the fewest bfloat16 pieces that hold it exactly,
//   so that every product sums the float32 version's terms and only the
//   order of the f32 sums differs. gamma is bfloat16: one piece. x^2 of a
//   bfloat16 x has at most 16 significant bits: two (hi, its top 8, and
//   lo, the rest). dn is float32: three. Passes: n = Gamma x^2 2, Gamma^T
//   dn 3, dGamma = dn (x^2)^T 5 (3 x 2 less lo*lo, under 2^-24 of the
//   product, as 3xTF32 drops it). Pieces are truncations of the bit
//   pattern (byte permutes, not conversions); a piece under 2^-133,
//   bfloat16's least subnormal, is lost, under 2^-126 Gamma against n >=
//   beta. gamma (128 KB at C = 256) and the tiles stay bfloat16 in shared
//   memory, so one block holds gamma up to 256 channels, with no cluster;
//   x and g are staged by 16-byte cp.async in rings (the next tile lands
//   while the current one computes); A and B fragments come by ldmatrix
//   (.trans where the tile is channel-major and the mma wants a pixel's two
//   neighbouring channels in a register), x^2 is squared and split in
//   registers as its fragments are built, dn split once into three
//   bfloat16 tiles. y and dx are rounded to bfloat16 once, at the store.
//
// What bounds it on an H100: on the f32 FMA units, operations. Per pixel
// the forward does one C x C product (2 C^2 operations) on 2 C values moved
// (x in, y out), 96 operations per byte at C = 192; the backward does three
// (6 C^2) on 3 C values (x, g in, dx out), 192 per byte. On the f32 FMA
// units (67 TFLOP/s) both are far above the 20 operations per byte at which
// that rate meets the memory's (3.35 TB/s). So both run their products on
// the tensor cores in 3xTF32: three TF32 products (495 TFLOP/s dense) for
// each f32 product, 165 TFLOP/s of f32 products, which meets the memory's
// rate at ~50 operations per byte. The forward's 96 is near that line: its
// bytes and its tensor-core operations bound it about equally (0.060 ms
// each at 8 x 192 x 128^2). In practice mma.sync reaches about two thirds
// of the dense TF32 rate, and a tile's product and its memory traffic
// each take a large share of the time, so what the forward's design does
// is keep both going at once. In bfloat16 the activations' bytes halve and
// the products take 2 (forward) and 2 + 3 + 5 (backward) bfloat16 passes
// at 989 TFLOP/s: at C = 192 the forward is bound by its bytes, the
// backward by its operations.
//
// The float32 kernels, three designs by channels, the same for the forward
// and dx, set by how much of gamma (C^2 floats) a block's 227 KB of shared
// memory holds:
// - C <= 192, every GDN of every model but the one below: one block per SM
//   holds gamma (150 KB at C = 192) resident.
// - 192 < C <= 256, MainCNNDecoder's IGDN at 256 channels
//   (icm_tpu/nn/factories.py:52,64-65, on the path of stf9, stf11-stf14,
//   oj_ICM and seg_oj_ICM): gamma (256 KB) is split over a cluster of two
//   blocks on neighbouring SMs, each holding the rows of half the output
//   channels (132 KB); dx's second product, a sum over output channels,
//   swaps the halves' partial sums through distributed shared memory.
// - 256 < C <= 512, which no model uses: gamma staged or streamed through
//   shared memory per tile, on the FMA units in the forward.
//
// The float32 forward (and the bfloat16 one above 256 channels):
// - gdn_fwd_kernel_resident (C <= 192): one persistent block per SM loads
//   gamma and beta into shared memory once, so per tile no gamma moves
//   (read per tile, gamma would be three times the launch's own bytes at
//   8 x 192 x 128^2). Its two warpgroups each walk their own tiles of 32
//   pixels with their own x buffer; a warp holds 48 channels by 32 pixels
//   of the product, so each split operand feeds 3 or 4 mma tiles, and the
//   product runs without a barrier. A warpgroup loads its next tile and
//   stores y while the other runs its product; the second starts one
//   product late, so the two (and the SMs) do not fall into step.
// - gdn_fwd_kernel_cluster (192 < C <= 256): the same code on each block's
//   half of the output channels, one persistent cluster per two SMs; both
//   blocks read the whole x tile, and need nothing of each other.
// - gdn_fwd_kernel_fma (C > 256): a block owns a tile of TP = 32 pixels of
//   one image and all C channels, on the f32 FMA units. x of the tile is
//   read once into shared memory, gamma is staged through shared memory in
//   chunks of BK input channels by TO = 192 output channels, and each
//   thread keeps a 6 x 4 register tile.
//
// The float32 backward (and the bfloat16 one above 256 channels):
// - All three products run on the tensor cores with mma.sync m16n8k8 in
//   3xTF32, as the forward's: each operand x is split into hi = tf32(x)
//   and lo = tf32(x - hi) (integer rounding of the bit pattern) and the
//   product accumulates
//   lo*hi + hi*lo + hi*hi, dropping lo*lo (about 2^-22 of the product). The
//   tensor cores' own additions do not round to nearest, so sums over 32
//   channels or pixels start from zero and are added up in f32: dx stays
//   within about 4e-6 of the plain version (tolerance 1e-5).
// - gdn_bwd_kernel_dx_resident (C <= 192): one block per SM holds gamma in
//   shared memory (loaded once) and walks tiles of 32 pixels. Per tile no
//   gamma moves and the products run with no barrier inside; dn stays in
//   shared memory, the direct term of dx and x in registers, and the next
//   tile's x loads during the second product.
// - gdn_bwd_kernel_dx_cluster (192 < C <= 256): the same on each block's
//   half of gamma's rows: n and dn for its output channels, then Gamma^T dn
//   over them for all input channels; the half for the peer's channels goes
//   to the peer's shared memory (16 KB a tile) across one cluster barrier,
//   and each block adds the two partial sums for its own.
// - gdn_bwd_kernel_dx_streamed (C > 256): gamma streams through a
//   double-buffered ring of 32-channel chunks (cp.async, the next chunk in
//   flight while one computes) beside tiles of 16 pixels; the direct term
//   of dx waits in dx.
// - dn goes to a workspace in device memory (one write, one read: 8 C
//   bytes a pixel against the products' 12 C^2 operations), and
//   gdn_bwd_kernel_dgamma computes dGamma = dn (x^2)^T as a split-K
//   product: a block holds one 96 x 96 tile of dGamma in registers over its
//   whole range of pixels, with dn and x staged by cp.async in a
//   three-chunk ring, and writes its partial slot once. The blocks of the
//   first tile column also sum dn for dbeta (the slot's column C).
//
// The bfloat16 design's kernels are described where they are defined
// (gdn_fwd_kernel_bf16, gdn_bwd_kernel_dx_bf16, gdn_bwd_kernel_dgamma_bf16).
//
// The sum of dGamma and dbeta over all pixels (the Pallas kernel revisits one
// VMEM block across sequential grid steps) is a deterministic two-stage
// reduce: a fixed number of partial slots (at most MAX_PARTIALS, a function
// of the shapes, not of the card), each a fixed contiguous range of pixel
// chunks summed in order, and a last kernel that sums the slots in a fixed
// order. No atomics anywhere: every output has one writer and a fixed order
// of sums, so the results are the same bits run to run. Pixels past the end
// of an image (a ragged last tile, any P) load as zero, so they add nothing
// to dn and hence nothing to the sums; channels past C load as zero too.
//
// Plain C interface for ctypes (no PyTorch headers); the wrapper is
// icm_tpu_torch/nn/gdn_fused.py.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int TP = 32;          // pixels per tile
constexpr int LD = TP + 1;      // padded row stride of a (C x TP) tile
constexpr int TO = 192;         // output channels per product chunk
constexpr int BK = 16;          // input channels per staged gamma chunk
constexpr int ALD = TO + 1;     // padded row stride of the staged chunk
constexpr int THREADS = 256;    // 32 x 8; thread (ty, tx) owns channels
                                // ty*6 .. ty*6+5 and pixels tx*4 .. tx*4+3
constexpr int RM = 6;           // channels per thread in a chunk product
constexpr int RN = 4;           // pixels per thread in a chunk product
constexpr int STAGE = BK * TO / THREADS;  // gamma values each thread stages
constexpr int LOADS = 8;        // tile values each thread has in flight
constexpr size_t MAX_SMEM = 227 * 1024;

static_assert(THREADS == (TO / RM) * (TP / RN), "thread tile covers the chunk");
static_assert(BK * TO % THREADS == 0, "staging is even over the threads");

using bf16 = __nv_bfloat16;

// one activation value to float32 and back (bfloat16: round to nearest even)
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// two neighbouring values, p aligned to two elements
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[j][q] += sum_k gamma[c0 + ty*RM + j][k] * Bs[k][tx*RN + q]^2, k < C:
// n = Gamma x^2 with gamma staged through As chunk by chunk. Bs is the
// (C x LD) x tile in shared memory. Ends with a barrier, so As can be
// restaged by the next call.
__device__ __forceinline__ void chunk_product(const float* __restrict__ gamma,
                                              int C, int c0,
                                              const float* Bs, float* As,
                                              float acc[RM][RN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (TP / RN);
  const int ty = tid / (TP / RN);
  for (int k0 = 0; k0 < C; k0 += BK) {
    float v[STAGE];
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      // the index running fastest over threads follows gamma's contiguous axis
      const int t = tid + r * THREADS;
      const int c = c0 + t / BK;
      const int k = k0 + t % BK;
      v[r] = c < C && k < C ? gamma[(size_t)c * C + k] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      const int t = tid + r * THREADS;
      As[(t % BK) * ALD + t / BK] = v[r];
    }
    __syncthreads();
    const int kmax = min(BK, C - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float* arow = As + kk * ALD + ty * RM;
      const float* brow = Bs + (size_t)(k0 + kk) * LD + tx * RN;
      float b[RN];
#pragma unroll
      for (int q = 0; q < RN; ++q) b[q] = brow[q] * brow[q];
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float a = arow[j];
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[j][q] = fmaf(a, b[q], acc[j][q]);
      }
    }
    __syncthreads();
  }
}

// dst[c][p] = src[c][p0 + p] as float32, zero past the end of the image;
// LOADS loads in flight per thread.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int C,
                                          int P, int p0, float* dst) {
  for (int t0 = threadIdx.x; t0 < C * TP; t0 += LOADS * THREADS) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * THREADS;
      const int c = t / TP;
      const int p = t % TP;
      v[u] = (t < C * TP && p0 + p < P) ? load1(src + (size_t)c * P + p0 + p) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * THREADS;
      if (t < C * TP) dst[(t / TP) * LD + t % TP] = v[u];
    }
  }
}

// The forward for C > 256 (no model's width; see the head note): one block
// per tile of TP pixels, f32 FMA units, gamma staged through shared memory
// in chunks of BK input channels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gdn_fwd_kernel_fma(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y, int C,
               int P, int tiles_per_image, int inverse) {
  extern __shared__ float smem[];
  float* xs = smem;             // (C, LD): x of the tile
  float* As = xs + C * LD;      // (BK, ALD): staged gamma chunk
  const int b = blockIdx.x / tiles_per_image;
  const int p0 = (blockIdx.x % tiles_per_image) * TP;
  const size_t base = (size_t)b * C * P;
  const int tx = threadIdx.x % (TP / RN);
  const int ty = threadIdx.x / (TP / RN);

  load_tile(x + base, C, P, p0, xs);
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += TO) {
    float acc[RM][RN] = {};
    chunk_product(gamma, C, c0, xs, As, acc);
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int o = c0 + ty * RM + j;
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int pl = tx * RN + q;
        if (o < C && p0 + pl < P) {
          const float n = acc[j][q] + beta[o];
          const float r = inverse ? sqrtf(n) : rsqrtf(n);
          store1(y + base + (size_t)o * P + p0 + pl, xs[o * LD + pl] * r);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. Three kernels on the stream, all without atomics:
//   gdn_bwd_kernel_dx_resident or _streamed  dx and dn;
//   gdn_bwd_kernel_dgamma  dGamma = dn (x^2)^T and dbeta = sum dn, a fixed
//                          number of pixel ranges (partial slots) per
//                          output tile, each slot written once;
//   gdn_reduce_kernel      the slots summed in a fixed order.
// The products run on the tensor cores in 3xTF32 (mma.sync m16n8k8).

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[0..4) = src[0..4), the values at or past `valid` as 0; one 16-byte
// copy where the source is aligned and whole, else 4-byte copies.
__device__ __forceinline__ void copy4(float* dst, const float* src, int valid,
                                      bool aligned) {
  if (aligned && valid >= 4) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < valid) {
        cp_async4(dst + e, src + e);
      } else {
        dst[e] = 0.f;
      }
    }
  }
}

// The same from bfloat16: dst[0..4) = float32 of src[0..4), one 8-byte load
// where the source is aligned and whole (dst is then 16-byte aligned, as
// the float32 copy needs it), else one value at a time.
__device__ __forceinline__ void copy4(float* dst, const bf16* src, int valid, bool aligned) {
  if (aligned && valid >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = e < valid ? __bfloat162float(src[e]) : 0.f;
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite x, as integer operations on the bit
// pattern (cvt.rna compiles to four instructions with its checks for inf
// and NaN, this to two)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i][j] += a[i] b[j] in 3xTF32 over a grid of I x J tiles, as three
// passes (lo*hi, hi*lo, hi*hi) so that every mma has independent
// neighbours to overlap with. A_EXACT: every a is a TF32 value (gamma's
// bfloat16 values in the bfloat16 builds), so a's low part is zero and its
// pass, which would add zeros, is left out: the same sums in two passes.
template <bool A_EXACT, int I, int J>
__device__ __forceinline__ void mma_3xtf32_grid(float (&c)[I][J][4], const uint32_t (&ah)[I][4],
                                                const uint32_t (&al)[I][4],
                                                const uint32_t (&bh)[J][2],
                                                const uint32_t (&bl)[J][2]) {
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) mma_tf32(c[i][j], al[i], bh[j]);
  }
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(c[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(c[i][j], ah[i], bh[j]);
}

// ---------------------------------------------------------------------------
// The forward with gamma resident in shared memory, for C <= clu::MAX_C: a
// block holds the rows of ROWS = 64 MI output channels (all input channels)
// and loads them once with beta's. Alone (gdn_fwd_kernel_resident, MI = 3,
// C <= fwd::MAX_C: every GDN and IGDN of every model but the one below) a
// persistent block per SM holds all of gamma; in a cluster of two
// (gdn_fwd_kernel_cluster, MI = 2, 192 < C <= 256) block rank r holds rows
// r ROWS .. r ROWS + ROWS - 1, and the two need nothing of each other.
// A block's two warpgroups walk tiles of RP pixels, each with its own x
// buffer (all input channels), so one warpgroup's load and epilogue run
// beside the other's product. Each warp holds MI m-tiles (16 MI channels)
// by 4 n-tiles (all 32 pixels) of its tile's product in 3xTF32 on
// mma.sync, so each split gamma fragment feeds 4 mma tiles and each split
// x^2 fragment MI.
namespace fwd {
constexpr int MAX_C = 192;
constexpr int RP = 32;           // pixels per tile
constexpr int NT = RP / 8;       // n-tiles of a warp: all the tile's pixels
constexpr int GROUP = 128;       // a warpgroup: warp w holds m-tiles w, w + 4, ...
constexpr int THREADS = 2 * GROUP;
constexpr int KC = 32;           // channels per sum added in f32
constexpr int LDT = RP + 4;      // x tile rows: the B fragments' reads hit 32 banks
constexpr int PAD_G = 8;         // gamma rows: CK + 8, the A fragments' 8-byte reads hit 32 banks
}  // namespace fwd

// Forward and dx for 192 < C <= clu::MAX_C: MainCNNDecoder's IGDN
// at 256 channels. gamma is 256 KB in float32, more than a block's 227 KB of
// shared memory, so a cluster of two blocks holds it: block rank r keeps the
// rows of output channels r HALF .. r HALF + HALF - 1 (all input channels)
// resident and loads them once. The cluster walks tiles of RP pixels; both
// blocks take the same tiles, each the whole x tile (the second read of it
// is mostly an L2 hit: the two blocks run side by side). Products run in
// 3xTF32 on mma.sync as the resident kernels' do. Each tile and each half
// is computed alone, in a fixed order, and every output has one writer, so
// neither the grid nor the card changes a bit.
namespace clu {
constexpr int MAX_C = 256;       // channels the cluster kernels take
constexpr int HALF = MAX_C / 2;  // output channels a block holds: 8 m-tiles
constexpr int THREADS = 256;
constexpr int RP = 32;           // pixels per tile
constexpr int KC = 32;           // channels per sum added in f32
constexpr int LDG = MAX_C + 8;   // gamma rows: the A reads hit 32 banks both as
                                 // rows (8-byte pairs) and transposed
constexpr int LDX = RP + 4;      // x tile rows: the B reads (rows 2 tq apart)
constexpr int LDD = RP + 8;      // g / dn tile rows: the B reads (rows tq apart)
}  // namespace clu

// Rows c0 .. c0 + ROWS of gamma (input channels 0 .. cols, zero past C;
// rows ldg floats apart) and the same of beta into shared memory
template <int ROWS>
__device__ __forceinline__ void load_gamma_rows(const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int C, int c0,
                                                int cols, int ldg, int gamma_aligned, float* gs,
                                                float* betas) {
  for (int e = threadIdx.x; e < ROWS * (cols / 4); e += blockDim.x) {
    const int r = e / (cols / 4);
    const int i = (e % (cols / 4)) * 4;
    const int o = c0 + r;
    copy4(gs + r * ldg + i, gamma + (size_t)o * C + i, o < C ? C - i : 0, gamma_aligned);
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) betas[r] = c0 + r < C ? beta[c0 + r] : 0.f;
}

// Each tile: acc = Gamma x^2 over all CK input channels with no barrier, in
// sums of 32 channels that start from zero and are added in f32 (the tensor
// cores' own additions do not round to nearest); then y = x n^(-1/2)
// (IGDN: x n^(+1/2)), n = beta + acc, stored from registers, 8 bytes a
// thread where the row allows.
//
// The k index of every 8-channel step is permuted alike in A and B: the
// mma's k = tq reads channel 2 tq and k = tq + 4 channel 2 tq + 1, so a
// thread's two gamma values of a row are neighbours (one 8-byte read).
//
// Warpgroup g of block (or cluster) q of n takes tiles q + (2 i + g) n, i =
// 0, 1, ...; every tile is computed alone, in one fixed order, and each y
// has one writer: neither the grid nor the card changes a bit of y.
template <int MI, int CLUSTER>
__device__ __forceinline__ void gdn_fwd_tiles(const float* __restrict__ x,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float* __restrict__ y,
                                              int C, int P, int tiles_per_image, int n_tiles,
                                              int inverse, int x_aligned, int gamma_aligned,
                                              int y_aligned) {
  constexpr int RP = fwd::RP, NT = fwd::NT, LDT = fwd::LDT, GROUP = fwd::GROUP;
  constexpr int THREADS = fwd::THREADS, KC = fwd::KC, ROWS = 64 * MI;
  extern __shared__ float4 smem4[];
  // input channels padded to the f32 sum; the x buffers and gamma's rows
  // are sized for KCAP of them (a cluster's for all clu::MAX_C, so its
  // shared memory, and with it the clusters that fit, is one per kernel).
  // Output channels are padded to ROWS: the product runs the same
  // instructions at every C.
  const int CK = (C + KC - 1) / KC * KC;
  const int KCAP = CLUSTER > 1 ? clu::MAX_C : CK;
  const int LDG = KCAP + fwd::PAD_G;
  float* gs = reinterpret_cast<float*>(smem4);  // gamma rows c0 .. c0 + ROWS (ROWS x LDG)
  float* betas = gs + ROWS * LDG;
  int c0 = 0;  // the block's first output channel
  if constexpr (CLUSTER > 1) c0 = (int)cg::this_cluster().block_rank() * ROWS;
  const int n_blocks = gridDim.x / CLUSTER;  // blocks, or clusters, that walk the tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int group = warp / 4;
  const int wq = warp % 4;      // m-tiles wq, wq + 4, ...
  const int gt = tid % GROUP;   // thread within the warpgroup
  float* xs = betas + ROWS + group * KCAP * LDT;  // the warpgroup's x tile (CK x LDT)
  // the warpgroup's barrier: named barrier 1 + group, its 128 threads
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(GROUP) : "memory");
  };

  load_gamma_rows<ROWS>(gamma, beta, C, c0, KCAP, LDG, gamma_aligned, gs, betas);
  // tile t's x into the warpgroup's buffer, zero past C channels and past
  // the image
  auto load_tile = [&](int tile) {
    const int p0 = (tile % tiles_per_image) * RP;
    const float* s0 = x + (size_t)(tile / tiles_per_image) * C * P + p0;
    for (int e = gt; e < CK * (RP / 4); e += GROUP) {
      const int c = e / (RP / 4);
      const int p = (e % (RP / 4)) * 4;
      copy4(xs + c * LDT + p, s0 + (size_t)c * P + p, c < C ? P - p0 - p : 0, x_aligned);
    }
  };
  const int step = 2 * n_blocks;
  const int first = blockIdx.x / CLUSTER + group * n_blocks;
  if (first < n_tiles) load_tile(first);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // gamma, beta and the first tiles are in
  // warpgroup 1 starts when warpgroup 0 has run its first product (named
  // barrier 3): started together, the two would keep the same phase, and
  // their loads and stores would meet in bursts (with those of every other
  // SM) instead of running beside the other's product
  if (group == 1) {
    asm volatile("bar.sync 3, %0;\n" ::"n"(THREADS) : "memory");
  } else if (first >= n_tiles) {
    asm volatile("bar.arrive 3, %0;\n" ::"n"(THREADS) : "memory");
  }

  for (int tile = first; tile < n_tiles; tile += step) {
    float acc[MI][NT][4] = {};
    for (int k0 = 0; k0 < CK; k0 += KC) {
      float part[MI][NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int k = k0 + ks * 8;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {  // B[k][n] = x[channel][pixel]^2
          const float* br = xs + (k + 2 * tq) * LDT + j * 8 + gq;
          const float v0 = br[0], v1 = br[LDT];
          split_tf32(v0 * v0, bh[j][0], bl[j][0]);
          split_tf32(v1 * v1, bh[j][1], bl[j][1]);
        }
        uint32_t ah[MI][4], al[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {  // A[m][k] = gamma[out][in]
          const int m0 = (wq + 4 * mi) * 16;
          const float2 r0 = *reinterpret_cast<const float2*>(gs + (m0 + gq) * LDG + k + 2 * tq);
          const float2 r8 = *reinterpret_cast<const float2*>(gs + (m0 + gq + 8) * LDG + k + 2 * tq);
          split_tf32(r0.x, ah[mi][0], al[mi][0]);
          split_tf32(r8.x, ah[mi][1], al[mi][1]);
          split_tf32(r0.y, ah[mi][2], al[mi][2]);
          split_tf32(r8.y, ah[mi][3], al[mi][3]);
        }
        mma_3xtf32_grid<false>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
    }
    if (group == 0 && tile == first) asm volatile("bar.arrive 3, %0;\n" ::"n"(THREADS) : "memory");

    // accumulator e of tile (mi, j): channel c0 + m0 + gq (+8 for e >= 2),
    // pixels j * 8 + 2 tq and + 1 (e even and odd); x there into registers,
    // and the buffer takes the next tile while the epilogue runs
    float2 xr[MI][2][NT];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + (wq + 4 * mi) * 16 + gq + 8 * h;
          xr[mi][h][j] = c < C ? *reinterpret_cast<const float2*>(xs + c * LDT + j * 8 + 2 * tq)
                               : make_float2(0.f, 0.f);
        }
    group_sync();
    if (tile + step < n_tiles) load_tile(tile + step);
    cp_async_commit();

    const int p0 = (tile % tiles_per_image) * RP;
    float* yt = y + (size_t)(tile / tiles_per_image) * C * P + p0;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wq + 4 * mi) * 16 + gq + 8 * h;
        const int c = c0 + r;
        if (c >= C) continue;
        const float bc = betas[r];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int pl = j * 8 + 2 * tq;
          const float n0 = acc[mi][j][2 * h] + bc, n1 = acc[mi][j][2 * h + 1] + bc;
          const float2 v = make_float2(xr[mi][h][j].x * (inverse ? sqrtf(n0) : rsqrtf(n0)),
                                       xr[mi][h][j].y * (inverse ? sqrtf(n1) : rsqrtf(n1)));
          float* dst = yt + (size_t)c * P + pl;
          if (y_aligned && p0 + pl + 1 < P) {
            store2(dst, v.x, v.y);
          } else {
            if (p0 + pl < P) store1(dst, v.x);
            if (p0 + pl + 1 < P) store1(dst + 1, v.y);
          }
        }
      }
    cp_async_wait<0>();  // the next tile has landed
    group_sync();        // for every thread of the warpgroup
  }
}

// C <= fwd::MAX_C: one block per SM holds all of gamma
__global__ void __launch_bounds__(fwd::THREADS, 1)
gdn_fwd_kernel_resident(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* __restrict__ y, int C, int P,
                        int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                        int gamma_aligned, int y_aligned) {
  static_assert(3 * 64 == fwd::MAX_C, "the block's rows are all of gamma's");
  gdn_fwd_tiles<3, 1>(x, gamma, beta, y, C, P, tiles_per_image, n_tiles, inverse, x_aligned,
                         gamma_aligned, y_aligned);
}

// 192 < C <= clu::MAX_C: a cluster of two blocks, each with half of gamma's rows
__global__ void __launch_bounds__(fwd::THREADS, 1)
gdn_fwd_kernel_cluster(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ y, int C, int P,
                       int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                       int gamma_aligned, int y_aligned) {
  static_assert(2 * 64 == clu::HALF && clu::LDG == clu::MAX_C + fwd::PAD_G &&
                    clu::LDX == fwd::LDT && clu::RP == fwd::RP,
                "the cluster's halves and tiles are the dx kernel's");
  gdn_fwd_tiles<2, 2>(x, gamma, beta, y, C, P, tiles_per_image, n_tiles, inverse, x_aligned,
                         gamma_aligned, y_aligned);
}

// n = beta + Gamma x^2 -> the direct term of dx and dn, for GDN (IGDN with
// inverse): r = n^(-1/2); GDN: g r and -1/2 g x r^3; IGDN: g n r and 1/2 g x r
__device__ __forceinline__ void gdn_terms(float n, float xv, float gv, int inverse,
                                          float& direct, float& dn) {
  const float r = rsqrtf(n);
  if (inverse) {
    direct = gv * (n * r);
    dn = 0.5f * gv * xv * r;
  } else {
    direct = gv * r;
    dn = -0.5f * gv * xv * (r * r * r);
  }
}

namespace bwd {
constexpr int THREADS = 256;  // 8 warps
constexpr int MO = 192;       // channels per pass (12 m-tiles of 16)
constexpr int SP = 16;        // pixels per tile with gamma streamed (C > 256)
constexpr int BK = 32;        // channels per streamed gamma chunk
constexpr int NS = 2;         // stages of the gamma ring
constexpr int LDA1 = BK + 4;  // chunk gamma[o][k0 + kk] as [o][kk]: n = Gamma x^2
constexpr int LDA3 = MO + 8;  // chunk gamma[k0 + kk][i] as [kk][i]: Gamma^T dn
constexpr int SLOT = MO * LDA1 > BK * LDA3 ? MO * LDA1 : BK * LDA3;
constexpr int RP = 32;        // pixels per tile with gamma resident
// dGamma: an output tile of GT x GT, pixels staged KB at a time
constexpr int GT = 96;
constexpr int KB = 32;
constexpr int LDK = KB + 4;
constexpr int GNS = 3;
constexpr int MAX_PARTIALS = 64;
}  // namespace bwd

// dx and dn for C > 256, a tile of SP pixels of one image and all C
// channels per block. Shared memory: x and dn as (CK x SP) tiles (row
// stride SP + 8: the B fragments' reads hit 32 banks; g is staged in dn's
// place) and a ring of NS gamma chunks. Channels go in passes of MO; each
// pass runs the k-chunks of gamma through the ring, 8 warps each holding
// 3 m-tiles by SP / 16 n-tiles of accumulators. Chunk q + NS - 1 is in
// flight while chunk q computes; the ring runs on from the first product
// into the second. The direct term of dx waits in `direct` between the two:
// dx itself in float32, a float32 workspace in bfloat16 (dx is rounded
// once).
template <typename T>
__global__ void __launch_bounds__(bwd::THREADS)
gdn_bwd_kernel_dx_streamed(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           T* dx, float* direct_out, float* __restrict__ dn_out, int C, int P,
                           int tiles_per_image, int inverse, int x_aligned,
                           int gamma_aligned) {
  // this kernel's shapes (named here: the forward's BK and THREADS differ)
  constexpr int MO = bwd::MO, BK = bwd::BK, NS = bwd::NS;
  constexpr int LDA1 = bwd::LDA1, LDA3 = bwd::LDA3, SLOT = bwd::SLOT;
  constexpr int THREADS = bwd::THREADS, TP = bwd::SP;
  constexpr int LDT = TP + 8;
  constexpr int NW = TP / 8 / 2;  // n-tiles of 8 pixels per warp
  extern __shared__ float4 smem4[];
  const int CK = (C + BK - 1) / BK * BK;  // channels padded to the chunk
  float* xs = reinterpret_cast<float*>(smem4);
  float* dns = xs + CK * LDT;
  float* ring = dns + CK * LDT;
  float* betas = ring + NS * SLOT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int b = blockIdx.x / tiles_per_image;
  const int p0 = (blockIdx.x % tiles_per_image) * TP;
  const size_t base = (size_t)b * C * P;
  const int n_pass = (C + MO - 1) / MO;
  const int KC = CK / BK;
  const int per_prod = n_pass * KC;
  const int Q = 2 * per_prod;

  // the x tile and the g tile (in dn's place: dn replaces g where it is
  // read), zero past C channels and past the image's P pixels, and beta
  for (int e = tid; e < 2 * CK * (TP / 4); e += THREADS) {
    const int which = e / (CK * (TP / 4));
    const int rem = e - which * CK * (TP / 4);
    const int c = rem / (TP / 4);
    const int p = (rem % (TP / 4)) * 4;
    copy4((which ? dns : xs) + c * LDT + p, (which ? g : x) + base + (size_t)c * P + p0 + p,
          c < C ? P - p0 - p : 0, x_aligned);
  }
  for (int c = tid; c < CK; c += THREADS) betas[c] = c < C ? beta[c] : 0.f;

  auto stage = [&](int q, float* slot) {
    const int prod = q / per_prod;
    const int rem = q - prod * per_prod;
    const int pass = rem / KC;
    const int k0 = (rem - pass * KC) * BK;
    for (int e = tid; e < MO * (BK / 4); e += THREADS) {
      if (prod == 0) {  // gamma[pass * MO + r][k0 .. k0 + BK)
        const int r = e / (BK / 4);
        const int kk = (e % (BK / 4)) * 4;
        const int o = pass * MO + r;
        copy4(slot + r * LDA1 + kk, gamma + (size_t)o * C + k0 + kk,
              o < C ? C - k0 - kk : 0, gamma_aligned);
      } else {  // gamma[k0 + kk][pass * MO .. pass * MO + MO)
        const int kk = e / (MO / 4);
        const int r = (e % (MO / 4)) * 4;
        const int o = k0 + kk;
        const int i = pass * MO + r;
        copy4(slot + kk * LDA3 + r, gamma + (size_t)o * C + i,
              o < C ? C - i : 0, gamma_aligned);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < Q) stage(s, ring + s * SLOT);
    cp_async_commit();  // group 0 also holds the x tile
  }

  float acc[3][NW][4];
  for (int q = 0; q < Q; ++q) {
    cp_async_wait<NS - 2>();  // chunk q has landed
    __syncthreads();          // for every thread; and chunk q - 1 is done with
    if (q + NS - 1 < Q) stage(q + NS - 1, ring + ((q + NS - 1) % NS) * SLOT);
    cp_async_commit();

    const int prod = q / per_prod;
    const int rem = q - prod * per_prod;
    const int pass = rem / KC;
    const int kc = rem - pass * KC;
    const float* slot = ring + (q % NS) * SLOT;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }

    // this chunk's sums start from zero and are added to acc in f32: the
    // tensor cores' own additions do not round to nearest, so a long chain
    // of them drifts
    float part[3][NW][4] = {};
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int k = kc * BK + ks * 8;
      uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int n0 = (wn * NW + j) * 8;
        float v0, v1;
        if (prod == 0) {  // B = x^2 (k = input channel, n = pixel)
          v0 = xs[(k + tq) * LDT + n0 + gq];
          v1 = xs[(k + tq + 4) * LDT + n0 + gq];
          v0 *= v0;
          v1 *= v1;
        } else {  // B = dn (k = output channel, n = pixel)
          v0 = dns[(k + tq) * LDT + n0 + gq];
          v1 = dns[(k + tq + 4) * LDT + n0 + gq];
        }
        split_tf32(v0, bh[j][0], bl[j][0]);
        split_tf32(v1, bh[j][1], bl[j][1]);
      }
      uint32_t ah[3][4], al[3][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
        const int m0 = (wm + 4 * mi) * 16;
        float a[4];
        if (prod == 0) {  // A = gamma (m = output channel, k = input channel)
          const float* ar = slot + (m0 + gq) * LDA1 + ks * 8 + tq;
          a[0] = ar[0];
          a[1] = ar[8 * LDA1];
          a[2] = ar[4];
          a[3] = ar[8 * LDA1 + 4];
        } else {  // A = gamma^T (m = input channel, k = output channel)
          const float* ar = slot + (ks * 8 + tq) * LDA3 + m0 + gq;
          a[0] = ar[0];
          a[1] = ar[8];
          a[2] = ar[4 * LDA3];
          a[3] = ar[4 * LDA3 + 8];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[mi][e], al[mi][e]);
      }
      // m-tiles past the pass's channels multiply zeros (the chunk's rows
      // past C load as 0) and are not stored
      mma_3xtf32_grid<sizeof(T) == 2>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];

    if (kc == KC - 1) {
      // epilogue of the pass; accumulator e sits at row gq (+8 for e >= 2)
      // and column 2 tq (+1 for odd e) of its 16 x 8 tile
      auto at_of = [&](int mi, int j, int e, int& c, int& pl) {
        c = pass * MO + (wm + 4 * mi) * 16 + gq + (e >= 2 ? 8 : 0);
        pl = (wn * NW + j) * 8 + 2 * tq + (e & 1);
        return c < C;
      };
      if (prod == 0) {
        // n = beta + Gamma x^2; dn, and the direct term of dx, which waits
        // in dx. Past the image x = g = 0, so dn = 0 (dn rows past C are 0
        // from the g tile's zero fill).
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int c, pl;
              if (!at_of(mi, j, e, c, pl)) continue;
              const int at = c * LDT + pl;
              float direct, dnv;
              gdn_terms(acc[mi][j][e] + betas[c], xs[at], dns[at], inverse, direct, dnv);
              dns[at] = dnv;
              if (p0 + pl < P) {
                const size_t gi = base + (size_t)c * P + p0 + pl;
                dn_out[gi] = dnv;
                direct_out[gi] = direct;
              }
            }
      } else {
        // dx = direct term + 2 x (Gamma^T dn): this thread's own direct
        // terms, all read before any is overwritten
        float direct[3][NW][4];
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int c, pl;
              direct[mi][j][e] = at_of(mi, j, e, c, pl) && p0 + pl < P
                                     ? direct_out[base + (size_t)c * P + p0 + pl] : 0.f;
            }
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int c, pl;
              if (!at_of(mi, j, e, c, pl) || p0 + pl >= P) continue;
              store1(dx + base + (size_t)c * P + p0 + pl,
                     direct[mi][j][e] + 2.f * xs[c * LDT + pl] * acc[mi][j][e]);
            }
      }
    }
  }
}

// dx and dn with gamma resident in shared memory, for C <= MO: a block
// loads gamma (and beta) once and walks tiles of RP pixels of one image,
// blockIdx.x, blockIdx.x + gridDim.x, ... Per tile: x and g are staged
// (g in dn's place), n = beta + Gamma x^2 runs over all channels with no
// barrier, the epilogue leaves dn in shared memory and the direct term of
// dx and x in registers (the second product's accumulators sit at the same
// channels and pixels), and while Gamma^T dn runs the next tile's x is
// already loading into the x tile.
__global__ void __launch_bounds__(bwd::THREADS)
gdn_bwd_kernel_dx_resident(const float* __restrict__ g, const float* __restrict__ x,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           float* __restrict__ dx, float* __restrict__ dn_out, int C, int P,
                           int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                           int gamma_aligned) {
  constexpr int THREADS = bwd::THREADS, RP = bwd::RP;
  constexpr int LDT = RP + 8;      // tile rows: the B fragments' reads hit 32 banks
  constexpr int NW = RP / 8 / 2;   // n-tiles of 8 pixels per warp
  extern __shared__ float4 smem4[];
  const int CP = (C + 15) / 16 * 16;  // channels padded to the m-tile
  const int LDG = CP + 4;              // gamma rows: the first product's A reads hit 32 banks
  float* gs = reinterpret_cast<float*>(smem4);  // gamma (CP x LDG), zero past C
  float* xs = gs + CP * LDG;                     // x tile (CP x LDT)
  float* dns = xs + CP * LDT;                    // g tile, then dn
  float* betas = dns + CP * LDT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 4;  // m-tiles wm, wm + 4, wm + 8
  const int wn = warp / 4;  // n-tiles wn * NW ..

  for (int e = tid; e < CP * (CP / 4); e += THREADS) {
    const int o = e / (CP / 4);
    const int i = (e % (CP / 4)) * 4;
    copy4(gs + o * LDG + i, gamma + (size_t)o * C + i, o < C ? C - i : 0, gamma_aligned);
  }
  for (int c = tid; c < CP; c += THREADS) betas[c] = c < C ? beta[c] : 0.f;
  // tile t's x or g into dst, zero past C channels and past the image
  auto load_tile = [&](const float* src, int tile, float* dst) {
    const int b = tile / tiles_per_image;
    const int p0 = (tile % tiles_per_image) * RP;
    const float* s0 = src + (size_t)b * C * P + p0;
    for (int e = tid; e < CP * (RP / 4); e += THREADS) {
      const int c = e / (RP / 4);
      const int p = (e % (RP / 4)) * 4;
      copy4(dst + c * LDT + p, s0 + (size_t)c * P + p, c < C ? P - p0 - p : 0, x_aligned);
    }
  };
  if (blockIdx.x < n_tiles) load_tile(x, blockIdx.x, xs);

  // the grid: accumulator e of tile (mi, j) is channel c(mi, e), pixel pl(j, e)
  auto chan = [&](int mi, int e) { return (wm + 4 * mi) * 16 + gq + (e >= 2 ? 8 : 0); };
  auto pix = [&](int j, int e) { return (wn * NW + j) * 8 + 2 * tq + (e & 1); };

  // acc = A B over all CP channels, A read from gamma as it stands (first
  // product) or transposed (second), B from a tile (x squared, or dn);
  // sums of 32 channels start from zero and are added to acc in f32 (the
  // tensor cores' own additions do not round to nearest)
  auto product = [&](bool second, const float* bt, float (&acc)[3][NW][4]) {
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    for (int k0 = 0; k0 < CP; k0 += 32) {
      float part[3][NW][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k = k0 + ks * 8;
        if (k >= CP) break;
        uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const float* br = bt + (k + tq) * LDT + (wn * NW + j) * 8 + gq;
          float v0 = br[0], v1 = br[4 * LDT];
          if (!second) {
            v0 *= v0;
            v1 *= v1;
          }
          split_tf32(v0, bh[j][0], bl[j][0]);
          split_tf32(v1, bh[j][1], bl[j][1]);
        }
        uint32_t ah[3][4] = {}, al[3][4] = {};
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          const int m0 = (wm + 4 * mi) * 16;
          if (m0 >= CP) continue;  // past the channels: zeros, not stored
          const float* ar = second ? gs + (k + tq) * LDG + m0 + gq : gs + (m0 + gq) * LDG + k + tq;
          const int d1 = second ? 8 : 8 * LDG;  // row + 8 of the A tile
          const int d2 = second ? 4 * LDG : 4;  // column + 4
          split_tf32(ar[0], ah[mi][0], al[mi][0]);
          split_tf32(ar[d1], ah[mi][1], al[mi][1]);
          split_tf32(ar[d2], ah[mi][2], al[mi][2]);
          split_tf32(ar[d1 + d2], ah[mi][3], al[mi][3]);
        }
        mma_3xtf32_grid<false>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
    }
  };

  float acc[3][NW][4], direct[3][NW][4], xr[3][NW][4];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    load_tile(g, tile, dns);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int b = tile / tiles_per_image;
    const int p0 = (tile % tiles_per_image) * RP;
    const size_t base = (size_t)b * C * P + p0;

    product(false, xs, acc);
    // n = beta + Gamma x^2 -> dn (shared memory and dn_out), the direct
    // term and x (registers). Past the image x = g = 0, so dn = 0.
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = chan(mi, e), pl = pix(j, e);
          if (c >= C) continue;
          const int at = c * LDT + pl;
          float dnv;
          xr[mi][j][e] = xs[at];
          gdn_terms(acc[mi][j][e] + betas[c], xs[at], dns[at], inverse, direct[mi][j][e], dnv);
          dns[at] = dnv;
          if (p0 + pl < P) dn_out[base + (size_t)c * P + pl] = dnv;
        }
    __syncthreads();  // dn is whole; the x tile is free
    if (tile + gridDim.x < n_tiles) load_tile(x, tile + gridDim.x, xs);
    cp_async_commit();

    product(true, dns, acc);
    // dx = direct term + 2 x (Gamma^T dn)
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = chan(mi, e), pl = pix(j, e);
          if (c < C && p0 + pl < P) {
            store1(dx + base + (size_t)c * P + pl,
                   direct[mi][j][e] + 2.f * xr[mi][j][e] * acc[mi][j][e]);
          }
        }
    __syncthreads();  // the next tile's g overwrites dn
  }
}

// dx and dn: the cluster walks tiles q, q + n_clusters, ... (cluster q);
// per tile, block r
// 1. runs n = beta + Gamma x^2 for its HALF output channels o over the
//    whole x tile, then leaves dn[o] in shared memory (and dn_out) and the
//    direct term of dx[o] and x[o] in registers;
// 2. runs partial_r = Gamma^T dn over its own o, for all MAX_C input
//    channels i (A read transposed from its resident rows), while the next
//    tile's x loads;
// 3. writes partial_r at the peer's input channels into the peer's shared
//    memory (DSMEM; two buffers, the tile's parity, so one cluster barrier
//    a tile suffices) and waits at the cluster barrier; the next tile's g
//    then loads;
// 4. stores dx[i] = direct[i] + 2 x[i] (partial_0[i] + partial_1[i]) for
//    its own i, which sit at the first product's places in its registers.
// A warp holds 2 m-tiles (wm, wm + 4 of a half) by 2 n-tiles (2 wn, 2 wn +
// 1) of the first product and 4 m-tiles (both halves) by the same n-tiles
// of the second. The first product's k is permuted as the forward's (gamma
// pairs read 8 bytes at a time), the second's is not.
__global__ void __launch_bounds__(clu::THREADS, 1)
gdn_bwd_kernel_dx_cluster(const float* __restrict__ g, const float* __restrict__ x,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float* __restrict__ dx, float* __restrict__ dn_out, int C, int P,
                          int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                          int gamma_aligned) {
  constexpr int RP = clu::RP, LDX = clu::LDX, LDD = clu::LDD, LDG = clu::LDG;
  constexpr int THREADS = clu::THREADS, KC = clu::KC, HALF = clu::HALF;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CK = (C + KC - 1) / KC * KC;         // input channels padded to the f32 sum
  float* gs = reinterpret_cast<float*>(smem4);   // gamma rows c0 .. c0 + HALF (HALF x LDG)
  float* betas = gs + HALF * LDG;                // beta's half
  float* xs = betas + HALF;                      // x tile (CK x LDX)
  float* dns = xs + clu::MAX_C * LDX;            // g tile of the block's channels, then dn
  float* recv = dns + HALF * LDD;                // [2][HALF][RP]: the peer's partials
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * HALF;                    // the block's first channel
  const int n_clusters = gridDim.x / 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 4;
  const int wn = warp / 4;
  // accumulator e of tile (mi, j): channel c0 + chan(mi, e) (the peer's
  // half for the second product's mi >= 2), pixel pix(j, e)
  auto chan = [&](int mi, int e) { return (wm + 4 * (mi & 1)) * 16 + gq + (e >= 2 ? 8 : 0); };
  auto pix = [&](int j, int e) { return (2 * wn + j) * 8 + 2 * tq + (e & 1); };
  // a partial's place in a receive buffer: row r, pixels swizzled by r so
  // that a warp's 8-byte stores and loads hit 32 banks
  auto slot = [&](int r, int pl) { return r * RP + (pl ^ ((r & 3) << 3)); };

  load_gamma_rows<HALF>(gamma, beta, C, c0, clu::MAX_C, LDG, gamma_aligned, gs, betas);
  auto load_x = [&](int tile) {  // all CK channels, zero past C and the image
    const int p0 = (tile % tiles_per_image) * RP;
    const float* s0 = x + (size_t)(tile / tiles_per_image) * C * P + p0;
    for (int e = tid; e < CK * (RP / 4); e += THREADS) {
      const int c = e / (RP / 4);
      const int p = (e % (RP / 4)) * 4;
      copy4(xs + c * LDX + p, s0 + (size_t)c * P + p, c < C ? P - p0 - p : 0, x_aligned);
    }
  };
  auto load_g = [&](int tile) {  // the block's HALF channels, zero past C and the image
    const int p0 = (tile % tiles_per_image) * RP;
    const float* s0 = g + (size_t)(tile / tiles_per_image) * C * P + p0;
    for (int e = tid; e < HALF * (RP / 4); e += THREADS) {
      const int r = e / (RP / 4);
      const int p = (e % (RP / 4)) * 4;
      const int c = c0 + r;
      copy4(dns + r * LDD + p, s0 + (size_t)c * P + p, c < C ? P - p0 - p : 0, x_aligned);
    }
  };
  const int first = blockIdx.x / 2;
  if (first < n_tiles) {
    load_x(first);
    load_g(first);
  }
  cp_async_commit();
  cluster.sync();  // both blocks have started before either writes to the other

  float direct[2][2][4], xr[2][2][4];
  int parity = 0;
  for (int tile = first; tile < n_tiles; tile += n_clusters, parity ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // the tile's x and g (and at first gamma) are in
    const int p0 = (tile % tiles_per_image) * RP;
    const size_t base = (size_t)(tile / tiles_per_image) * C * P + p0;

    // 1. n over the block's output channels; sums of KC channels start
    // from zero and are added in f32
    float acc[2][2][4] = {};
    for (int k0 = 0; k0 < CK; k0 += KC) {
      float part[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int k = k0 + ks * 8;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // B[k][n] = x[channel][pixel]^2
          const float* br = xs + (k + 2 * tq) * LDX + (2 * wn + j) * 8 + gq;
          const float v0 = br[0], v1 = br[LDX];
          split_tf32(v0 * v0, bh[j][0], bl[j][0]);
          split_tf32(v1 * v1, bh[j][1], bl[j][1]);
        }
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {  // A[m][k] = gamma[out][in]
          const int m0 = (wm + 4 * mi) * 16;
          const float2 r0 = *reinterpret_cast<const float2*>(gs + (m0 + gq) * LDG + k + 2 * tq);
          const float2 r8 = *reinterpret_cast<const float2*>(gs + (m0 + gq + 8) * LDG + k + 2 * tq);
          split_tf32(r0.x, ah[mi][0], al[mi][0]);
          split_tf32(r8.x, ah[mi][1], al[mi][1]);
          split_tf32(r0.y, ah[mi][2], al[mi][2]);
          split_tf32(r8.y, ah[mi][3], al[mi][3]);
        }
        mma_3xtf32_grid<false>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
    }
    // n -> dn (shared memory and dn_out), the direct term and x
    // (registers). Past the image x = g = 0, so dn = 0; past C dn keeps
    // the g tile's zeros.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = chan(mi, e), c = c0 + r, pl = pix(j, e);
          xr[mi][j][e] = c < C ? xs[c * LDX + pl] : 0.f;
          direct[mi][j][e] = 0.f;
          if (c >= C) continue;
          float dnv;
          gdn_terms(acc[mi][j][e] + betas[r], xr[mi][j][e], dns[r * LDD + pl], inverse,
                    direct[mi][j][e], dnv);
          dns[r * LDD + pl] = dnv;
          if (p0 + pl < P) dn_out[base + (size_t)c * P + pl] = dnv;
        }
    __syncthreads();  // dn is whole; the x tile is free
    if (tile + n_clusters < n_tiles) load_x(tile + n_clusters);
    cp_async_commit();

    // 2. Gamma^T dn over the block's output channels: mi 0, 1 at its own
    // input channels, 2, 3 at the peer's
    float acc2[4][2][4] = {};
    for (int k0 = 0; k0 < HALF; k0 += KC) {
      float part[4][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int k = k0 + ks * 8;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // B[k][n] = dn[output channel][pixel]
          const float* br = dns + (k + tq) * LDD + (2 * wn + j) * 8 + gq;
          split_tf32(br[0], bh[j][0], bl[j][0]);
          split_tf32(br[4 * LDD], bh[j][1], bl[j][1]);
        }
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {  // A[m][k] = gamma[out][in] transposed
          const int i0 = (mi < 2 ? c0 : HALF - c0) + (wm + 4 * (mi & 1)) * 16;
          const float* ar = gs + (k + tq) * LDG + i0 + gq;
          split_tf32(ar[0], ah[mi][0], al[mi][0]);
          split_tf32(ar[8], ah[mi][1], al[mi][1]);
          split_tf32(ar[4 * LDG], ah[mi][2], al[mi][2]);
          split_tf32(ar[4 * LDG + 8], ah[mi][3], al[mi][3]);
        }
        mma_3xtf32_grid<false>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[mi][j][e] += part[mi][j][e];
    }

    // 3. the peer's input channels to the peer
    float* mine = recv + parity * HALF * RP;
    float* theirs = cluster.map_shared_rank(mine, rank ^ 1);
#pragma unroll
    for (int mi = 2; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(theirs + slot(chan(mi, 2 * h), pix(j, 0))) =
              make_float2(acc2[mi][j][2 * h], acc2[mi][j][2 * h + 1]);
        }
    cluster.sync();  // the peer's partials are in mine; this block is done with dn
    if (tile + n_clusters < n_tiles) load_g(tile + n_clusters);
    cp_async_commit();

    // 4. dx = direct term + 2 x (partial_0 + partial_1): one addition of
    // two values, the same bits in both blocks' order
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = chan(mi, 2 * h), c = c0 + r, pl = pix(j, 0);
          if (c >= C) continue;
          const float2 q = *reinterpret_cast<const float2*>(mine + slot(r, pl));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * h + u;
            const float s = acc2[mi][j][e] + (u ? q.y : q.x);
            if (p0 + pl + u < P) {
              store1(dx + base + (size_t)c * P + pl + u, direct[mi][j][e] + 2.f * xr[mi][j][e] * s);
            }
          }
        }
  }
}

// Partial sums of dGamma[o][i] = sum_p dn[o][p] x[i][p]^2 and dbeta[o] =
// sum_p dn[o][p] over one fixed range of pixel chunks (blockIdx.y of
// gridDim.y slots), for one GT x GT output tile (blockIdx.x). dn and x of a
// chunk of KB pixels are staged by cp.async in a ring of GNS; 8 warps, each
// 48 output channels by 24 input channels (3 x 3 tiles of 16 x 8), hold the
// tile's sums in registers across the whole range, and the slot is written
// once. The blocks of the first column of tiles also sum dn for dbeta in a
// fixed order.
template <typename T>
__global__ void __launch_bounds__(bwd::THREADS)
gdn_bwd_kernel_dgamma(const float* __restrict__ dn, const T* __restrict__ x,
                      float* __restrict__ partials, int C, int P,
                      int chunks_per_image, int n_chunks, int aligned) {
  constexpr int THREADS = bwd::THREADS, GT = bwd::GT, KB = bwd::KB;
  constexpr int LDK = bwd::LDK, GNS = bwd::GNS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [GNS][2][GT][LDK]
  constexpr int STAGE = 2 * GT * LDK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 2;  // 48 output channels each
  const int wn = warp / 2;  // 24 input channels each
  const int tiles_i = (C + GT - 1) / GT;
  const int o0 = (blockIdx.x / tiles_i) * GT;
  const int i0 = (blockIdx.x % tiles_i) * GT;
  const int slot_id = blockIdx.y;
  const int c_begin = (int)((long long)n_chunks * slot_id / gridDim.y);
  const int c_end = (int)((long long)n_chunks * (slot_id + 1) / gridDim.y);
  const int n = c_end - c_begin;
  const bool sums_dbeta = i0 == 0;

  auto stage = [&](int ci, float* st) {
    const int b = ci / chunks_per_image;
    const int pp = (ci % chunks_per_image) * KB;
    const size_t base = (size_t)b * C * P;
    for (int e = tid; e < 2 * GT * (KB / 4); e += THREADS) {
      const int which = e / (GT * (KB / 4));  // 0: dn rows o, 1: x rows i
      const int rem = e - which * GT * (KB / 4);
      const int r = rem / (KB / 4);
      const int p = (rem % (KB / 4)) * 4;
      const int c = (which ? i0 : o0) + r;
      const size_t at = base + (size_t)c * P + pp + p;
      float* dst = st + (which * GT + r) * LDK + p;
      const int valid = c < C ? P - pp - p : 0;
      if (which) {
        copy4(dst, x + at, valid, aligned);
      } else {
        copy4(dst, dn + at, valid, aligned);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < GNS - 1; ++s) {
    if (s < n) stage(c_begin + s, ring + s * STAGE);
    cp_async_commit();
  }

  float acc[3][3][4] = {};
  float dbeta_acc = 0.f;
  for (int q = 0; q < n; ++q) {
    cp_async_wait<GNS - 2>();
    __syncthreads();
    if (q + GNS - 1 < n) stage(c_begin + q + GNS - 1, ring + ((q + GNS - 1) % GNS) * STAGE);
    cp_async_commit();
    const float* As = ring + (q % GNS) * STAGE;  // dn: [o][p]
    const float* Bs = As + GT * LDK;             // x:  [i][p]

    float part[3][3][4] = {};  // the chunk's sums, added to acc in f32
#pragma unroll
    for (int ks = 0; ks < KB / 8; ++ks) {
      uint32_t bh[3][2], bl[3][2], ah[3][4], al[3][4];
#pragma unroll
      for (int nj = 0; nj < 3; ++nj) {  // B[k = p][n = i] = x[i][p]^2
        const float* br = Bs + (wn * 24 + nj * 8 + gq) * LDK + ks * 8 + tq;
        split_tf32(br[0] * br[0], bh[nj][0], bl[nj][0]);
        split_tf32(br[4] * br[4], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {  // A[m = o][k = p] = dn[o][p]
        const float* ar = As + (wm * 48 + mi * 16 + gq) * LDK + ks * 8 + tq;
        split_tf32(ar[0], ah[mi][0], al[mi][0]);
        split_tf32(ar[8 * LDK], ah[mi][1], al[mi][1]);
        split_tf32(ar[4], ah[mi][2], al[mi][2]);
        split_tf32(ar[8 * LDK + 4], ah[mi][3], al[mi][3]);
      }
      mma_3xtf32_grid<false>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int nj = 0; nj < 3; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    if (sums_dbeta && tid < 2 * GT) {  // row tid / 2, half tid % 2 of the chunk
      const float* row = As + (tid / 2) * LDK + (tid % 2) * (KB / 2);
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < KB / 2; ++u) v += row[u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      dbeta_acc += v;
    }
  }

  const int CP = C + 1;
  float* part = partials + (size_t)slot_id * C * CP;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 3; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wm * 48 + mi * 16 + gq + (e >= 2 ? 8 : 0);
        const int i = i0 + wn * 24 + nj * 8 + 2 * tq + (e & 1);
        if (o < C && i < C) part[(size_t)o * CP + i] = acc[mi][nj][e];
      }
    }
  }
  if (sums_dbeta && tid < 2 * GT && tid % 2 == 0 && o0 + tid / 2 < C) {
    part[(size_t)(o0 + tid / 2) * CP + C] = dbeta_acc;
  }
}

// dgamma[o][i] = sum over slots of partials[k][o][i]; dbeta[o] likewise from
// column C; the slots are summed in order k = 0, 1, ...
__global__ void gdn_reduce_kernel(const float* __restrict__ partials,
                                  int n_partials, int C,
                                  float* __restrict__ dgamma,
                                  float* __restrict__ dbeta) {
  const int CP = C + 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * CP) return;
  float s = 0.f;
  for (int k = 0; k < n_partials; ++k) s += partials[(size_t)k * C * CP + e];
  const int o = e / CP;
  const int i = e % CP;
  if (i < C) {
    dgamma[(size_t)o * C + i] = s;
  } else {
    dbeta[o] = s;
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 design, 1 <= C <= 256 (the head note): bfloat16 operands on
// the tensor cores (mma.sync m16n8k16, f32 accumulators), each product cut
// into the fewest exact bfloat16 pieces; gamma and the x tiles held in
// bfloat16; tiles staged by 16-byte cp.async.
namespace bfd {
constexpr int MAX_C = 256;      // gamma is 128 KB in bfloat16: one block holds it
constexpr int THREADS = 256;    // dx's and dGamma's blocks (the forward's: its warpgroups)
constexpr int RP = 32;          // pixels per tile
constexpr int KC = 32;          // channels per sum added in f32
constexpr int LDX = RP + 8;     // tile rows of 80 bytes: an ldmatrix's 8 rows hit 8 bank groups
constexpr int PAD_G = 8;        // gamma rows of 2 K + 16 bytes, K a multiple of 32: likewise
constexpr int NS = 2;           // tiles in a forward warpgroup's ring
// dGamma: an output tile of GT x GT, pixels staged KB at a time in a ring of GNS
constexpr int GT = 96;
constexpr int KB = 32;
constexpr int LDN = KB + 8;     // f32 dn rows, 16-byte aligned for cp.async
constexpr int GNS = 3;
constexpr size_t STAGE = sizeof(float) * GT * LDN + sizeof(bf16) * GT * LDX;  // bytes a stage
}  // namespace bfd

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A or B fragments of four (x4) or two (x2) 8 x 8 matrices of 16-bit values,
// each row 16 bytes of shared memory at the address lane 8 q + r gives for
// row r of matrix q; .trans hands each thread a column's pair instead of a
// row's
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The pieces are truncations: a bfloat16 is the upper half of a float32's
// bit pattern, so cutting off the lower half gives a's top 8 significant
// bits exactly, and a - that is exact in f32. Byte permutes and f32
// subtractions, full-rate instructions, where rounding would take the
// conversion unit.
__device__ __forceinline__ float trunc_bf16(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xffff0000u);
}
// a and b truncated to bfloat16, packed as a pair with a in the low half
// (the lower k of an mma fragment's register)
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
// The squares of the two bfloat16 values of v (the low half first) as hi +
// lo, both bfloat16 pairs, exactly: a bfloat16 has 8 significant bits, so
// its square at most 16, hi the top 8 and lo the rest (down to 2^-133,
// bfloat16's least subnormal: what lies below, in squares under 2^-118,
// is under 2^-126 Gamma against n >= beta)
__device__ __forceinline__ void square_split(uint32_t v, uint32_t& hi, uint32_t& lo) {
  const float x0 = __uint_as_float(v << 16), x1 = __uint_as_float(v & 0xffff0000u);
  const float s0 = x0 * x0, s1 = x1 * x1;
  hi = bf16_pair(s0, s1);
  lo = bf16_pair(s0 - trunc_bf16(s0), s1 - trunc_bf16(s1));
}
// f32 a and b as hi + mid + lo, bfloat16 pairs, exactly: 24 significant
// bits, 8 a piece (each remainder starts at or below the bit under the
// last piece's; pieces under 2^-133 are lost, as above)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const float ra = a - trunc_bf16(a), rb = b - trunc_bf16(b);
  hi = bf16_pair(a, b);
  mid = bf16_pair(ra, rb);
  lo = bf16_pair(ra - trunc_bf16(ra), rb - trunc_bf16(rb));
}

// dst[0..8) = src[0..8) of bfloat16, the values at or past `valid` as 0: one
// 16-byte cp.async where the source is aligned and whole, else a
// synchronous store of what was loaded one value at a time
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int valid, bool aligned) {
  if (aligned && valid >= 8) {
    cp_async16(dst, src);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t lo = 2 * u < valid ? __bfloat16_as_ushort(src[2 * u]) : 0u;
    const uint32_t hi = 2 * u + 1 < valid ? __bfloat16_as_ushort(src[2 * u + 1]) : 0u;
    w[u] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// gamma (C x C, bfloat16) into rows x cols of shared memory (row stride
// ldg; cols a multiple of 8) and beta into rows floats, zero past C; all
// the block's threads
__device__ __forceinline__ void load_gamma_bf16(const bf16* __restrict__ gamma,
                                                const float* __restrict__ beta, int C, int rows,
                                                int cols, int ldg, int aligned, bf16* gs,
                                                float* betas) {
  for (int e = threadIdx.x; e < rows * (cols / 8); e += blockDim.x) {
    const int o = e / (cols / 8);
    const int i = (e % (cols / 8)) * 8;
    copy8(gs + o * ldg + i, gamma + (size_t)o * C + i, o < C ? C - i : 0, aligned);
  }
  for (int c = threadIdx.x; c < rows; c += blockDim.x) betas[c] = c < C ? beta[c] : 0.f;
}

// Tile `tile` (RP pixels of one image) of src (B x C x P, bfloat16), rows
// 0 .. CK - 1, into dst (row stride LDX), zero past C and past the image;
// thread t of nt
__device__ __forceinline__ void load_tile_bf16(const bf16* __restrict__ src, int C, int P,
                                               int tiles_per_image, int tile, int CK,
                                               int aligned, int t, int nt, bf16* dst) {
  constexpr int RP = bfd::RP, LDX = bfd::LDX;
  const int p0 = (tile % tiles_per_image) * RP;
  const bf16* s0 = src + (size_t)(tile / tiles_per_image) * C * P + p0;
  for (int e = t; e < CK * (RP / 8); e += nt) {
    const int c = e / (RP / 8);
    const int p = (e % (RP / 8)) * 8;
    copy8(dst + c * LDX + p, s0 + (size_t)c * P + p, c < C ? P - p0 - p : 0, aligned);
  }
}

// acc[mi][j] = Gamma x^2 over the CK input channels for the warp's MI
// m-tiles wm + 4 mi (gamma's rows zero past C up to the last:
// every m-tile runs, so the product is straight-line code) by the n-tiles
// n0 + 8 j, j < NJ, of the x tile xs (CK x LDX). gamma's A fragments come
// from its rows with ldmatrix, x's B fragments with ldmatrix.trans (each
// register a pixel's two neighbouring channels), squared and split in
// registers; two passes (lo, then hi). Each step's B fragments are asked
// for before the last step's mma run. Sums of KC channels start from zero
// and are added in f32 (the tensor cores' own additions do not round to
// nearest).
template <int MI, int NJ>
__device__ __forceinline__ void gamma_x2_product(float (&acc)[MI][NJ][4], const bf16* gs,
                                                 int ldg, const bf16* xs, int CK, int wm,
                                                 int n0) {
  constexpr int KC = bfd::KC, LDX = bfd::LDX;
  static_assert(NJ % 2 == 0, "one ldmatrix.x4 takes two n-tiles");
  const int lane = threadIdx.x % 32;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);  // the lane's row of a 16-row fragment
  const int lcol = 8 * (lane >> 4);                     // and its column offset
  const bf16* xl = xs + lrow * LDX + n0 + lcol;
  const bf16* gl = gs + (wm * 16 + lrow) * ldg + lcol;
  // B[k][n] = x[channel][pixel] of step k, n-tiles j, j + 1 in raw[j / 2]
  uint32_t raw[NJ / 2][4];
#pragma unroll
  for (int j = 0; j < NJ; j += 2) ldmatrix_x4_trans(raw[j / 2], xl + 8 * j);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  for (int k0 = 0; k0 < CK; k0 += KC) {
    float part[MI][NJ][4] = {};
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int k = k0 + ks * 16;
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        square_split(raw[j / 2][0], bh[j][0], bl[j][0]);
        square_split(raw[j / 2][1], bh[j][1], bl[j][1]);
        square_split(raw[j / 2][2], bh[j + 1][0], bl[j + 1][0]);
        square_split(raw[j / 2][3], bh[j + 1][1], bl[j + 1][1]);
      }
      const int kn = min(k + 16, CK - 16);  // the next step (the last reads its own again)
#pragma unroll
      for (int j = 0; j < NJ; j += 2) ldmatrix_x4_trans(raw[j / 2], xl + kn * LDX + 8 * j);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {  // A[m][k] = gamma[out][in]
        uint32_t a[4];
        ldmatrix_x4(a, gl + mi * 64 * ldg + k);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(part[mi][j], a, bl[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(part[mi][j], a, bh[j]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
  }
}

// acc[mi][j] = Gamma^T dn over the CK output channels (the k index) for the
// warp's MI m-tiles (wm + 4 mi) 16 (input channels, gamma's columns zero
// past C) by its n-tiles 16 wn + 8 j, j < 2: A = gamma transposed, by
// ldmatrix.trans from its rows; B = the three bfloat16 piece tiles of dn
// (lo, mid, hi; CK x LDX, by ldmatrix.trans): 3 passes, the smallest
// first. Each step's B fragments are asked for before the last step's
// mma run; sums of KC channels start from zero and are added in f32.
template <int MI>
__device__ __forceinline__ void gammaT_dn_product(float (&acc)[MI][2][4], const bf16* gs, int ldg,
                                                  const bf16* const (&dn3)[3], int CK, int wm,
                                                  int wn) {
  constexpr int KC = bfd::KC, LDX = bfd::LDX;
  const int lane = threadIdx.x % 32;
  // the lane's ldmatrix rows (.trans, the k index) in a tile and in gamma
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
  const int trow = (lane & 7) + 8 * (lane >> 4);
  const int tcol = 8 * ((lane >> 3) & 1);
  const int boff = lrow * LDX + 16 * wn + lcol;
  const bf16* al = gs + trow * ldg + wm * 16 + tcol;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  uint32_t b[3][4];  // registers 0, 1 n-tile 0; 2, 3 n-tile 1
#pragma unroll
  for (int q = 0; q < 3; ++q) ldmatrix_x4_trans(b[q], dn3[q] + boff);
  for (int k0 = 0; k0 < CK; k0 += KC) {
    float part[MI][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int k = k0 + ks * 16;
      uint32_t bk[3][2][2];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bk[q][j][0] = b[q][2 * j];
          bk[q][j][1] = b[q][2 * j + 1];
        }
      const int kn = min(k + 16, CK - 16) * LDX;  // the next step (the last reads its own)
#pragma unroll
      for (int q = 0; q < 3; ++q) ldmatrix_x4_trans(b[q], dn3[q] + kn + boff);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {  // A[m = input channel][k = output channel]
        uint32_t a[4];
        ldmatrix_x4_trans(a, al + k * ldg + mi * 64);
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(part[mi][j], a, bk[q][j]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
  }
}

// sqrt(n) on the MUFU unit, as rsqrtf's (the float32 kernels' sqrtf is
// IEEE: a dozen instructions and a branch, a sixth of the IGDN forward's time)
__device__ __forceinline__ float sqrt_approx(float n) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(n));
  return r;
}

// bfloat16 pairs of y or dx from f32: 4 bytes where the row allows
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b, int at, int P,
                                           int aligned) {
  if (aligned && at + 1 < P) {
    store2(dst, a, b);
  } else {
    if (at < P) store1(dst, a);
    if (at + 1 < P) store1(dst + 1, b);
  }
}

// The forward, 1 <= C <= 256: one persistent block per SM holds gamma (64 MI
// x CK bfloat16, rows zero past C) and beta, loaded once. Its GROUPS
// warpgroups walk their own tiles of RP pixels (warpgroup g of block q of
// n: tiles q + (GROUPS i + g) n), each through a ring of NS x tiles: tile
// i + 1 lands while tile i's product runs, and tile i + 2 is asked for as
// soon as tile i's epilogue is done with its buffer. Each warp holds MI
// m-tiles (wq, wq + 4, ...: 16 MI output channels) by all 4 n-tiles of its
// tile's product, so a split x^2 fragment feeds 2 MI mma (each of the
// four warps splits it; on the H100 a tile split two by two ran slower,
// and so did two warpgroups in place of three at 192 channels). The
// epilogue reads x from the same bfloat16 tile: y = x n^(-1/2)
// (IGDN x n^(+1/2)), rounded to bfloat16 once. Every tile is computed
// alone, in one fixed order, and each y has one writer: neither the grid
// nor the card changes a bit.
template <int MI, int GROUPS>
__global__ void __launch_bounds__(GROUPS * 128, 1)
gdn_fwd_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ y, int C, int P,
                    int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                    int gamma_aligned, int y_aligned) {
  constexpr int RP = bfd::RP, NT = RP / 8, KC = bfd::KC, LDX = bfd::LDX;
  constexpr int NS = bfd::NS, GROUP = 128;
  constexpr int ROWS = 64 * MI;  // output channels, zero past C
  extern __shared__ float4 smem4[];
  const int CK = (C + KC - 1) / KC * KC;  // input channels padded to the f32 sum
  const int LDG = CK + bfd::PAD_G;
  bf16* gs = reinterpret_cast<bf16*>(smem4);                 // gamma (ROWS x LDG)
  float* betas = reinterpret_cast<float*>(gs + ROWS * LDG);  // beta (ROWS)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int group = warp / 4;
  const int wq = warp % 4;  // m-tiles wq, wq + 4, ...
  const int gt = tid % GROUP;
  bf16* ring = reinterpret_cast<bf16*>(betas + ROWS) + group * NS * CK * LDX;  // NS x (CK x LDX)
  // named barriers: 1 + g the warpgroup's own, GROUPS + g the start of g
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(GROUP) : "memory");
  };
  auto let_next_start = [&]() {
    if (group + 1 < GROUPS) {
      asm volatile("bar.arrive %0, %1;\n" ::"r"(GROUPS + group + 1), "n"(2 * GROUP) : "memory");
    }
  };

  load_gamma_bf16(gamma, beta, C, ROWS, CK, LDG, gamma_aligned, gs, betas);
  const int step = GROUPS * gridDim.x;
  const int first = blockIdx.x + group * gridDim.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) {  // group 0 also holds gamma
    if (first + s * step < n_tiles) {
      load_tile_bf16(x, C, P, tiles_per_image, first + s * step, CK, x_aligned, gt, GROUP,
                     ring + s * CK * LDX);
    }
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();
  __syncthreads();  // gamma, beta and each warpgroup's first tile are in
  // warpgroup g starts when warpgroup g - 1 has run its first product, so
  // that they do not keep one phase (as the float32 forward's warpgroups)
  if (group > 0) asm volatile("bar.sync %0, %1;\n" ::"r"(GROUPS + group), "n"(2 * GROUP) : "memory");
  if (first >= n_tiles) let_next_start();

  int i = 0;
  for (int tile = first; tile < n_tiles; tile += step, ++i) {
    bf16* xs = ring + (i % NS) * CK * LDX;
    if (i > 0) {
      cp_async_wait<NS - 1>();  // this tile has landed (the next may not have)
      group_sync();             // for every thread of the warpgroup
    }
    float acc[MI][NT][4];
    gamma_x2_product<MI, NT>(acc, gs, LDG, xs, CK, wq, 0);
    if (i == 0) let_next_start();

    // accumulator e of tile (mi, j): channel (wq + 4 mi) 16 + gq (+8 for e
    // >= 2), pixels 8 j + 2 tq and + 1 (e even and odd)
    const int p0 = (tile % tiles_per_image) * RP;
    bf16* yt = y + (size_t)(tile / tiles_per_image) * C * P + p0;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (wq + 4 * mi) * 16 + gq + 8 * h;
        if (c >= C) continue;
        const float bc = betas[c];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int pl = 8 * j + 2 * tq;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + c * LDX + pl));
          const float n0 = acc[mi][j][2 * h] + bc, n1 = acc[mi][j][2 * h + 1] + bc;
          store_pair(yt + (size_t)c * P + pl,
                     xv.x * (inverse ? sqrt_approx(n0) : rsqrtf(n0)),
                     xv.y * (inverse ? sqrt_approx(n1) : rsqrtf(n1)), p0 + pl, P, y_aligned);
        }
      }
    }
    group_sync();  // the warpgroup is done with this buffer
    if (tile + NS * step < n_tiles) {
      load_tile_bf16(x, C, P, tiles_per_image, tile + NS * step, CK, x_aligned, gt, GROUP, xs);
    }
    cp_async_commit();
  }
}

// dx and dn, 1 <= C <= 256: one persistent block per SM holds gamma (64 MI
// x 64 MI bfloat16, zero past C) and beta, loaded once, and walks tiles of
// RP pixels, blockIdx.x, blockIdx.x + gridDim.x, ... Four bfloat16 tiles:
// x of the tile and of the next (asked for as the tile starts, so it lands
// while the tile's two products run), M and L. g is read by one thread
// each, at its own accumulators' places, so it goes from device memory to
// registers, asked for as the tile starts. Each warp holds MI m-tiles (wm
// = warp % 4 takes wm, wm + 4, ...) by 2 n-tiles (wn = warp / 4 takes
// pixels 16 wn ..) of both products. Per tile:
// 1. n = beta + Gamma x^2 (gamma_x2_product, 2 passes; x^2 split in
//    registers: splitting it once into M and L measured slower);
// 2. dn, the direct term of dx and x of the thread's own accumulators in
//    registers; after a barrier (every warp has read x for its product) dn
//    split into hi + mid + lo (split3), written over x (each place the one
//    thread's that read it) and into M and L, and dn in f32 to dn_out;
// 3. Gamma^T dn (gammaT_dn_product, 3 passes);
// 4. dx = direct + 2 x (Gamma^T dn), rounded to bfloat16 once.
// Channels past C have dn = 0 (their gamma rows and columns load as zero),
// pixels past the image x = g = 0, so dn = 0 there too.
template <int MI>
__global__ void __launch_bounds__(bfd::THREADS, 1)
gdn_bwd_kernel_dx_bf16(const bf16* __restrict__ g, const bf16* __restrict__ x,
                       const bf16* __restrict__ gamma, const float* __restrict__ beta,
                       bf16* __restrict__ dx, float* __restrict__ dn_out, int C, int P,
                       int tiles_per_image, int n_tiles, int inverse, int x_aligned,
                       int gamma_aligned, int pairs_aligned) {
  constexpr int RP = bfd::RP, KC = bfd::KC, LDX = bfd::LDX, NW = 2;
  // gamma's rows and columns zero past C up to ROWS: the first product's
  // m-tiles are its rows, the second's its columns
  constexpr int ROWS = 64 * MI, LDG = ROWS + bfd::PAD_G;
  extern __shared__ float4 smem4[];
  const int CK = (C + KC - 1) / KC * KC;
  const int T = CK * LDX;                                     // elements of a tile
  bf16* gs = reinterpret_cast<bf16*>(smem4);                  // gamma (ROWS x LDG)
  float* betas = reinterpret_cast<float*>(gs + ROWS * LDG);   // beta (ROWS)
  bf16* tiles = reinterpret_cast<bf16*>(betas + ROWS);        // x[2], M, L
  bf16* ms = tiles + 2 * T;
  bf16* ls = tiles + 3 * T;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 4;  // m-tiles wm, wm + 4, ...
  const int wn = warp / 4;  // pixels 16 wn .. 16 wn + 15
  auto chan = [&](int mi, int e) { return (wm + 4 * mi) * 16 + gq + (e >= 2 ? 8 : 0); };
  auto pix = [&](int j) { return 16 * wn + 8 * j + 2 * tq; };  // even e; odd e + 1

  load_gamma_bf16(gamma, beta, C, ROWS, ROWS, LDG, gamma_aligned, gs, betas);
  auto load_x = [&](int tile, int parity) {
    load_tile_bf16(x, C, P, tiles_per_image, tile, CK, x_aligned, tid, bfd::THREADS,
                   tiles + parity * T);
  };
  if (blockIdx.x < n_tiles) load_x(blockIdx.x, 0);
  cp_async_commit();

  float acc[MI][NW][4], direct[MI][NW][4], xr[MI][NW][4];
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
    bf16* xs = tiles + parity * T;
    cp_async_wait<0>();
    __syncthreads();  // the tile's x is in; the other x buffer, M and L are free
    if (tile + gridDim.x < n_tiles) load_x(tile + gridDim.x, parity ^ 1);
    cp_async_commit();
    const int p0 = (tile % tiles_per_image) * RP;
    const size_t base = (size_t)(tile / tiles_per_image) * C * P + p0;
    // g at the thread's accumulators' places, zero past C and the image
    __nv_bfloat162 gv[MI][NW][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan(mi, 2 * h), at = p0 + pix(j);
          const bf16* src = g + base + (size_t)c * P + pix(j);
          const bf16 zero = __float2bfloat16_rn(0.f);
          if (c < C && pairs_aligned && at + 1 < P) {
            gv[mi][j][h] = *reinterpret_cast<const __nv_bfloat162*>(src);
          } else {
            gv[mi][j][h].x = c < C && at < P ? src[0] : zero;
            gv[mi][j][h].y = c < C && at + 1 < P ? src[1] : zero;
          }
        }
    // 1-2. n -> dn (in acc), the direct term and x
    gamma_x2_product<MI, NW>(acc, gs, LDG, xs, CK, wm, 16 * wn);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan(mi, 2 * h);
          const bool live = c < C;
          const float2 xv = live ? __bfloat1622float2(
                                       *reinterpret_cast<const __nv_bfloat162*>(xs + c * LDX + pix(j)))
                                 : make_float2(0.f, 0.f);
          const float2 gf = __bfloat1622float2(gv[mi][j][h]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * h + u;
            xr[mi][j][e] = u ? xv.y : xv.x;
            float dnv = 0.f;
            direct[mi][j][e] = 0.f;
            if (live) {
              gdn_terms(acc[mi][j][e] + betas[c], xr[mi][j][e], u ? gf.y : gf.x, inverse,
                        direct[mi][j][e], dnv);
            }
            acc[mi][j][e] = dnv;
          }
        }
    __syncthreads();  // every warp has read x for its product
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if ((wm + 4 * mi) * 16 >= CK) continue;  // rows past the tiles' (dn = 0)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan(mi, 2 * h), pl = pix(j), at = c * LDX + pl;
          uint32_t hi, mid, lo;
          split3(acc[mi][j][2 * h], acc[mi][j][2 * h + 1], hi, mid, lo);
          *reinterpret_cast<uint32_t*>(xs + at) = hi;
          *reinterpret_cast<uint32_t*>(ms + at) = mid;
          *reinterpret_cast<uint32_t*>(ls + at) = lo;
          if (c < C) {
            float* dst = dn_out + base + (size_t)c * P + pl;
            if (pairs_aligned && p0 + pl + 1 < P) {
              *reinterpret_cast<float2*>(dst) = make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
            } else {
              if (p0 + pl < P) dst[0] = acc[mi][j][2 * h];
              if (p0 + pl + 1 < P) dst[1] = acc[mi][j][2 * h + 1];
            }
          }
        }
    }
    __syncthreads();  // dn's pieces are whole

    // 3. Gamma^T dn over the CK output channels (the k index)
    const bf16* const dn3[3] = {ls, ms, xs};
    gammaT_dn_product<MI>(acc, gs, LDG, dn3, CK, wm, wn);

    // 4. dx = direct term + 2 x (Gamma^T dn)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = chan(mi, 2 * h), pl = pix(j);
          if (c >= C) continue;
          const int e = 2 * h;
          store_pair(dx + base + (size_t)c * P + pl,
                     direct[mi][j][e] + 2.f * xr[mi][j][e] * acc[mi][j][e],
                     direct[mi][j][e + 1] + 2.f * xr[mi][j][e + 1] * acc[mi][j][e + 1],
                     p0 + pl, P, pairs_aligned);
        }
  }
}

// Partial sums of dGamma[o][i] = sum_p dn[o][p] x[i][p]^2 and dbeta[o] =
// sum_p dn[o][p], bfloat16 x, as gdn_bwd_kernel_dgamma's: one GT x GT
// output tile (blockIdx.x) over one fixed range of pixel chunks
// (blockIdx.y of gridDim.y slots), dn (f32) and x (bfloat16) of KB pixels
// staged by cp.async in a ring of GNS, 8 warps of 3 x 3 tiles of 16 x 8
// holding the tile's sums across the range, each slot written once. The
// pixels are the k index, contiguous in both: dn's A fragments are read as
// 8-byte pairs and split into hi + mid + lo in registers, x's B fragments
// come by ldmatrix, squared and split into hi + lo (splitting each chunk
// once into shared memory for all warps measured slower). Five passes, the
// six piece products less lo x lo (under 2^-24 of the product, as 3xTF32
// drops lo*lo), smallest first.
__global__ void __launch_bounds__(bfd::THREADS)
gdn_bwd_kernel_dgamma_bf16(const float* __restrict__ dn, const bf16* __restrict__ x,
                           float* __restrict__ partials, int C, int P, int chunks_per_image,
                           int n_chunks, int dn_aligned, int x_aligned) {
  constexpr int GT = bfd::GT, KB = bfd::KB, LDN = bfd::LDN, LDX = bfd::LDX, GNS = bfd::GNS;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);  // [GNS] x (dn GT x LDN f32, x GT x LDX bf16)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wm = warp % 2;  // 48 output channels each
  const int wn = warp / 2;  // 24 input channels each
  const int tiles_i = (C + GT - 1) / GT;
  const int o0 = (blockIdx.x / tiles_i) * GT;
  const int i0 = (blockIdx.x % tiles_i) * GT;
  const int slot_id = blockIdx.y;
  const int c_begin = (int)((long long)n_chunks * slot_id / gridDim.y);
  const int c_end = (int)((long long)n_chunks * (slot_id + 1) / gridDim.y);
  const int n = c_end - c_begin;
  const bool sums_dbeta = i0 == 0;

  auto stage = [&](int ci, char* st) {
    const int pp = (ci % chunks_per_image) * KB;
    const size_t base = (size_t)(ci / chunks_per_image) * C * P + pp;
    float* dns = reinterpret_cast<float*>(st);
    bf16* xs = reinterpret_cast<bf16*>(dns + GT * LDN);
    for (int e = tid; e < GT * (KB / 4); e += bfd::THREADS) {  // dn rows o0 ..
      const int r = e / (KB / 4);
      const int p = (e % (KB / 4)) * 4;
      const int c = o0 + r;
      copy4(dns + r * LDN + p, dn + base + (size_t)c * P + p, c < C ? P - pp - p : 0,
            dn_aligned);
    }
    for (int e = tid; e < GT * (KB / 8); e += bfd::THREADS) {  // x rows i0 ..
      const int r = e / (KB / 8);
      const int p = (e % (KB / 8)) * 8;
      const int c = i0 + r;
      copy8(xs + r * LDX + p, x + base + (size_t)c * P + p, c < C ? P - pp - p : 0, x_aligned);
    }
  };

#pragma unroll
  for (int s = 0; s < GNS - 1; ++s) {
    if (s < n) stage(c_begin + s, ring + s * bfd::STAGE);
    cp_async_commit();
  }

  float acc[3][3][4] = {};
  float dbeta_acc = 0.f;
  for (int q = 0; q < n; ++q) {
    cp_async_wait<GNS - 2>();
    __syncthreads();
    if (q + GNS - 1 < n) stage(c_begin + q + GNS - 1, ring + ((q + GNS - 1) % GNS) * bfd::STAGE);
    cp_async_commit();
    const float* As = reinterpret_cast<const float*>(ring + (q % GNS) * bfd::STAGE);  // dn [o][p]
    const bf16* Bs = reinterpret_cast<const bf16*>(As + GT * LDN);                    // x [i][p]

    float part[3][3][4] = {};  // the chunk's sums, added to acc in f32
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      uint32_t bh[3][2], bl[3][2];
#pragma unroll
      for (int nj = 0; nj < 3; ++nj) {  // B[k = p][n = i] = x[i][p]^2
        uint32_t r[2];
        ldmatrix_x2(r, Bs + (wn * 24 + nj * 8 + (lane & 7)) * LDX + ks * 16 + 8 * ((lane >> 3) & 1));
        square_split(r[0], bh[nj][0], bl[nj][0]);
        square_split(r[1], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {  // A[m = o][k = p] = dn[o][p]
        const float* ar = As + (wm * 48 + mi * 16 + gq) * LDN + ks * 16 + 2 * tq;
        uint32_t ah[4], am[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // rows gq, gq + 8; k 2 tq, 2 tq + 8
          const float2 v = *reinterpret_cast<const float2*>(ar + (r & 1) * 8 * LDN + (r >> 1) * 8);
          split3(v.x, v.y, ah[r], am[r], al[r]);
        }
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) mma_bf16(part[mi][nj], al, bh[nj]);
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) mma_bf16(part[mi][nj], am, bl[nj]);
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) mma_bf16(part[mi][nj], am, bh[nj]);
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) mma_bf16(part[mi][nj], ah, bl[nj]);
#pragma unroll
        for (int nj = 0; nj < 3; ++nj) mma_bf16(part[mi][nj], ah, bh[nj]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int nj = 0; nj < 3; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    if (sums_dbeta && tid < 2 * GT) {  // row tid / 2, half tid % 2 of the chunk
      const float* row = As + (tid / 2) * LDN + (tid % 2) * (KB / 2);
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < KB / 2; ++u) v += row[u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      dbeta_acc += v;
    }
  }

  const int CP = C + 1;
  float* part = partials + (size_t)slot_id * C * CP;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int nj = 0; nj < 3; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wm * 48 + mi * 16 + gq + (e >= 2 ? 8 : 0);
        const int i = i0 + wn * 24 + nj * 8 + 2 * tq + (e & 1);
        if (o < C && i < C) part[(size_t)o * CP + i] = acc[mi][nj][e];
      }
  if (sums_dbeta && tid < 2 * GT && tid % 2 == 0 && o0 + tid / 2 < C) {
    part[(size_t)(o0 + tid / 2) * CP + C] = dbeta_acc;
  }
}

int tiles_per_image(int P) { return (P + TP - 1) / TP; }

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > MAX_SMEM) return -3;
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

// x-like pointers of element type T aligned for 4-value loads (16 bytes in
// float32, 8 in bfloat16) along rows of P pixels
template <typename T>
bool rows_aligned4(int P, const void* a, const void* b = nullptr) {
  return P % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % (4 * sizeof(T)) == 0;
}

template <typename T>
int launch_dx_streamed(const T* g, const T* x, const float* gamma, const float* beta, T* dx,
                       float* direct, float* dn, int B, int C, int P, int inverse,
                       cudaStream_t s) {
  const int CK = (C + bwd::BK - 1) / bwd::BK * bwd::BK;
  const size_t smem =
      sizeof(float) * (2 * (size_t)CK * (bwd::SP + 8) + (size_t)bwd::NS * bwd::SLOT + CK);
  int rc = set_smem((const void*)gdn_bwd_kernel_dx_streamed<T>, smem);
  if (rc != 0) return rc;
  const int tpi = (P + bwd::SP - 1) / bwd::SP;
  const int x_aligned = rows_aligned4<T>(P, x, g);
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  gdn_bwd_kernel_dx_streamed<T><<<B * tpi, bwd::THREADS, smem, s>>>(
      g, x, gamma, beta, dx, direct, dn, C, P, tpi, inverse, x_aligned, gamma_aligned);
  return (int)cudaGetLastError();
}

int launch_dx_resident(const float* g, const float* x, const float* gamma, const float* beta,
                       float* dx, float* dn, int B, int C, int P, int inverse, cudaStream_t s) {
  const int CP = (C + 15) / 16 * 16;
  const size_t smem = sizeof(float) * ((size_t)CP * (CP + 4) + 2 * (size_t)CP * (bwd::RP + 8) + CP);
  int rc = set_smem((const void*)gdn_bwd_kernel_dx_resident, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return rc;
  const int tpi = (P + bwd::RP - 1) / bwd::RP;
  const int n_tiles = B * tpi;
  const int x_aligned = rows_aligned4<float>(P, x, g);
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  // one block per SM (gamma fills most of its shared memory); every tile is
  // computed alone, so the grid size changes no result
  gdn_bwd_kernel_dx_resident<<<n_tiles < sms ? n_tiles : sms, bwd::THREADS, smem, s>>>(
      g, x, gamma, beta, dx, dn, C, P, tpi, n_tiles, inverse, x_aligned, gamma_aligned);
  return (int)cudaGetLastError();
}

// A launch of `kernel` in clusters of two blocks of clu::THREADS threads
// and `smem` bytes of shared memory each (one size per kernel): as many
// clusters as the card holds at once, at most one a tile. That count is
// asked of the runtime: the H100's GPCs do not all hold an even number of
// free SMs, so it is not half the SMs. The kernel, its shared memory and
// the card fix it, so it is asked once a card, with the shared memory
// set; later launches only read it. A launch the card refuses returns its
// error; nothing falls back.
template <auto kernel, typename... Args>
int launch_cluster(size_t smem, int n_tiles, cudaStream_t s, Args... args) {
  constexpr int MAX_CARDS = 64;
  static std::atomic<int> slots_of[MAX_CARDS];  // 0: not asked yet
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  int slots = dev < MAX_CARDS ? slots_of[dev].load(std::memory_order_relaxed) : 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(clu::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (slots == 0) {
    if ((rc = set_smem((const void*)kernel, smem)) != 0) return rc;
    rc = (int)cudaOccupancyMaxActiveClusters(&slots, (const void*)kernel, &cfg);
    if (rc != 0) return rc;
    if (slots < 1) return -5;  // no cluster of two such blocks fits
    if (dev < MAX_CARDS) slots_of[dev].store(slots, std::memory_order_relaxed);
  }
  cfg.gridDim = dim3(2 * (n_tiles < slots ? n_tiles : slots));
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

int launch_fwd_cluster(const float* x, const float* gamma, const float* beta, float* y, int B,
                       int C, int P, int inverse, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)clu::HALF * clu::LDG + clu::HALF +
                                       2 * (size_t)clu::MAX_C * clu::LDX);
  const int tpi = (P + clu::RP - 1) / clu::RP;
  const int x_aligned = rows_aligned4<float>(P, x);
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  const int y_aligned = P % 2 == 0 && (uintptr_t)y % (2 * sizeof(float)) == 0;
  return launch_cluster<gdn_fwd_kernel_cluster>(smem, B * tpi, s, x, gamma, beta, y, C, P,
                                                   tpi, B * tpi, inverse, x_aligned,
                                                   gamma_aligned, y_aligned);
}

int launch_dx_cluster(const float* g, const float* x, const float* gamma, const float* beta,
                      float* dx, float* dn, int B, int C, int P, int inverse, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)clu::HALF * clu::LDG + clu::HALF +
                                       (size_t)clu::MAX_C * clu::LDX + clu::HALF * clu::LDD +
                                       2 * clu::HALF * clu::RP);
  const int tpi = (P + clu::RP - 1) / clu::RP;
  const int x_aligned = rows_aligned4<float>(P, x, g);
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  return launch_cluster<gdn_bwd_kernel_dx_cluster>(smem, B * tpi, s, g, x, gamma, beta, dx,
                                                      dn, C, P, tpi, B * tpi, inverse, x_aligned,
                                                      gamma_aligned);
}

template <typename T>
int launch_fwd_fma(const T* x, const float* gamma, const float* beta, T* y, int B, int C, int P,
                   int inverse, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)C * LD + BK * ALD);
  int rc = set_smem((const void*)gdn_fwd_kernel_fma<T>, smem);
  if (rc != 0) return rc;
  const int tpi = tiles_per_image(P);
  gdn_fwd_kernel_fma<T><<<B * tpi, THREADS, smem, s>>>(x, gamma, beta, y, C, P, tpi, inverse);
  return (int)cudaGetLastError();
}

int launch_fwd_resident(const float* x, const float* gamma, const float* beta, float* y, int B,
                        int C, int P, int inverse, cudaStream_t s) {
  const int CK = (C + fwd::KC - 1) / fwd::KC * fwd::KC;
  const size_t smem = sizeof(float) * ((size_t)fwd::MAX_C * (CK + fwd::PAD_G) + fwd::MAX_C +
                                       2 * (size_t)CK * fwd::LDT);
  int rc = set_smem((const void*)gdn_fwd_kernel_resident, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return rc;
  const int tpi = (P + fwd::RP - 1) / fwd::RP;
  const int n_tiles = B * tpi;
  const int x_aligned = rows_aligned4<float>(P, x);
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  const int y_aligned = P % 2 == 0 && (uintptr_t)y % (2 * sizeof(float)) == 0;
  // one block per SM (gamma fills most of its shared memory)
  gdn_fwd_kernel_resident<<<n_tiles < sms ? n_tiles : sms, fwd::THREADS, smem, s>>>(
      x, gamma, beta, y, C, P, tpi, n_tiles, inverse, x_aligned, gamma_aligned, y_aligned);
  return (int)cudaGetLastError();
}

// bfloat16 rows of P pixels aligned for 16-byte copies of 8 values
bool rows_aligned8(int P, const void* a, const void* b = nullptr) {
  return P % 8 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
}

// the forward at MI m-tiles a warp and GROUPS warpgroups a block
template <int MI, int GROUPS>
int launch_fwd_bf16(const bf16* x, const bf16* gamma, const float* beta, bf16* y, int B, int C,
                    int P, int inverse, cudaStream_t s) {
  const int CK = (C + bfd::KC - 1) / bfd::KC * bfd::KC;
  const size_t smem = sizeof(bf16) * 64 * MI * (size_t)(CK + bfd::PAD_G) + sizeof(float) * 64 * MI +
                      sizeof(bf16) * GROUPS * bfd::NS * (size_t)CK * bfd::LDX;
  int rc = set_smem((const void*)gdn_fwd_kernel_bf16<MI, GROUPS>, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return rc;
  const int tpi = (P + bfd::RP - 1) / bfd::RP;
  const int n_tiles = B * tpi;
  const int y_aligned = P % 2 == 0 && (uintptr_t)y % 4 == 0;
  // one block per SM (gamma and the rings fill most of its shared memory)
  gdn_fwd_kernel_bf16<MI, GROUPS><<<n_tiles < sms ? n_tiles : sms, GROUPS * 128, smem, s>>>(
      x, gamma, beta, y, C, P, tpi, n_tiles, inverse, rows_aligned8(P, x),
      rows_aligned8(C, gamma), y_aligned);
  return (int)cudaGetLastError();
}

// dx and dn at MI m-tiles a warp (4 warps over the channels: 64 MI >= C)
template <int MI>
int launch_dx_bf16(const bf16* g, const bf16* x, const bf16* gamma, const float* beta, bf16* dx,
                   float* dn, int B, int C, int P, int inverse, cudaStream_t s) {
  const int CK = (C + bfd::KC - 1) / bfd::KC * bfd::KC;
  const size_t smem = sizeof(bf16) * 64 * MI * (size_t)(64 * MI + bfd::PAD_G) +
                      sizeof(float) * 64 * MI + sizeof(bf16) * 4 * (size_t)CK * bfd::LDX;
  int rc = set_smem((const void*)gdn_bwd_kernel_dx_bf16<MI>, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return rc;
  const int tpi = (P + bfd::RP - 1) / bfd::RP;
  const int n_tiles = B * tpi;
  // dn's float pairs (8 bytes), g's and dx's bfloat16 pairs (4)
  const int pairs_aligned = P % 2 == 0 && ((uintptr_t)g | (uintptr_t)dx) % 4 == 0 &&
                            (uintptr_t)dn % 8 == 0;
  gdn_bwd_kernel_dx_bf16<MI><<<n_tiles < sms ? n_tiles : sms, bfd::THREADS, smem, s>>>(
      g, x, gamma, beta, dx, dn, C, P, tpi, n_tiles, inverse, rows_aligned8(P, x),
      rows_aligned8(C, gamma), pairs_aligned);
  return (int)cudaGetLastError();
}

int launch_dgamma_bf16(const float* dn, const bf16* x, float* partials, int n_partials, int B,
                       int C, int P, cudaStream_t s) {
  const size_t smem = bfd::GNS * bfd::STAGE;
  int rc = set_smem((const void*)gdn_bwd_kernel_dgamma_bf16, smem);
  if (rc != 0) return rc;
  const int cpi = (P + bfd::KB - 1) / bfd::KB;
  const int tiles = (C + bfd::GT - 1) / bfd::GT;
  gdn_bwd_kernel_dgamma_bf16<<<dim3(tiles * tiles, n_partials), bfd::THREADS, smem, s>>>(
      dn, x, partials, C, P, cpi, B * cpi, rows_aligned4<float>(P, dn), rows_aligned8(P, x));
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* x, const void* gamma, const void* beta, void* y, int B, int C, int P,
            int inverse, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* betaf = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  if constexpr (std::is_same<T, bf16>::value) {
    // bfloat16 up to 256 channels: the bfloat16 design, gamma in bfloat16
    const bf16* gammab = static_cast<const bf16*>(gamma);
    if (C <= 192) return launch_fwd_bf16<3, 3>(xt, gammab, betaf, yt, B, C, P, inverse, s);
    if (C <= bfd::MAX_C) return launch_fwd_bf16<4, 2>(xt, gammab, betaf, yt, B, C, P, inverse, s);
  } else {
    // float32: gamma resident in shared memory on the tensor cores, one
    // block up to 192 channels, a cluster of two up to 256
    const float* gammaf = static_cast<const float*>(gamma);
    if (C <= fwd::MAX_C) return launch_fwd_resident(xt, gammaf, betaf, yt, B, C, P, inverse, s);
    if (C <= clu::MAX_C) return launch_fwd_cluster(xt, gammaf, betaf, yt, B, C, P, inverse, s);
  }
  // above 256 channels gamma (float32) staged in chunks on the FMA units
  return launch_fwd_fma<T>(xt, static_cast<const float*>(gamma), betaf, yt, B, C, P, inverse, s);
}

// Partial slots of the backward's dGamma/dbeta sums for B images of P
// pixels: a function of the shapes alone, not of the card.
int backward_partials(int B, int P) {
  const long long chunks = (long long)B * ((P + bwd::KB - 1) / bwd::KB);
  return (int)(chunks < bwd::MAX_PARTIALS ? chunks : bwd::MAX_PARTIALS);
}

// dx's float32 direct term between the streamed kernel's two products has
// a workspace of its own only in bfloat16 (in float32 it waits in dx); the
// resident and cluster kernels keep it in registers
bool direct_in_workspace(int C, int dtype) { return dtype != 0 && C > clu::MAX_C; }

// dgamma[o][i] and dbeta[o] from the partial slots, in a fixed order
int launch_reduce(const float* partials, int n_partials, int C, void* dgamma, void* dbeta,
                  cudaStream_t s) {
  const int n = C * (C + 1);
  gdn_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      partials, n_partials, C, static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* g, const void* x, const void* gamma, const void* beta, void* dx,
             void* dgamma, void* dbeta, void* workspace, int B, int C, int P, int inverse,
             int n_partials, cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const float* betaf = static_cast<const float*>(beta);
  T* dxt = static_cast<T*>(dx);
  float* dn = static_cast<float*>(workspace);
  float* partials = dn + (size_t)B * C * P;
  int rc = 0;
  if constexpr (std::is_same<T, bf16>::value) {
    // bfloat16 up to 256 channels: the bfloat16 design, gamma in bfloat16
    if (C <= bfd::MAX_C) {
      const bf16* gammab = static_cast<const bf16*>(gamma);
      rc = C <= 192 ? launch_dx_bf16<3>(gt, xt, gammab, betaf, dxt, dn, B, C, P, inverse, s)
                    : launch_dx_bf16<4>(gt, xt, gammab, betaf, dxt, dn, B, C, P, inverse, s);
      if (rc == 0) rc = launch_dgamma_bf16(dn, xt, partials, n_partials, B, C, P, s);
      return rc != 0 ? rc : launch_reduce(partials, n_partials, C, dgamma, dbeta, s);
    }
  }
  // gamma in float32: resident in shared memory, one block up to MO
  // channels and a cluster of two up to 256 (float32); above, streamed
  // through the ring beside tiles of 16 pixels
  const float* gammaf = static_cast<const float*>(gamma);
  if (C > clu::MAX_C) {
    float* direct = sizeof(T) == sizeof(float)
                        ? reinterpret_cast<float*>(dxt)
                        : partials + (size_t)n_partials * C * (C + 1);
    rc = launch_dx_streamed<T>(gt, xt, gammaf, betaf, dxt, direct, dn, B, C, P, inverse, s);
  } else if constexpr (std::is_same<T, float>::value) {
    rc = C <= bwd::MO ? launch_dx_resident(gt, xt, gammaf, betaf, dxt, dn, B, C, P, inverse, s)
                      : launch_dx_cluster(gt, xt, gammaf, betaf, dxt, dn, B, C, P, inverse, s);
  }
  if (rc != 0) return rc;

  const size_t smem = sizeof(float) * (size_t)bwd::GNS * 2 * bwd::GT * bwd::LDK;
  rc = set_smem((const void*)gdn_bwd_kernel_dgamma<T>, smem);
  if (rc != 0) return rc;
  const int cpi = (P + bwd::KB - 1) / bwd::KB;
  const int tiles = (C + bwd::GT - 1) / bwd::GT;
  const int aligned = rows_aligned4<T>(P, x) && rows_aligned4<float>(P, dn);
  gdn_bwd_kernel_dgamma<T><<<dim3(tiles * tiles, n_partials), bwd::THREADS, smem, s>>>(
      dn, xt, partials, C, P, cpi, B * cpi, aligned);
  rc = (int)cudaGetLastError();
  return rc != 0 ? rc : launch_reduce(partials, n_partials, C, dgamma, dbeta, s);
}

}  // namespace

extern "C" {

// Floats of workspace the backward needs for B images of C channels and P
// pixels, x of dtype code `dtype` (0 float32, 1 bfloat16): dn (B x C x P),
// the partial slots of dGamma and dbeta (backward_partials(B, P) x C x
// (C + 1)), and in bfloat16 above 256 channels dx's direct term (B x C x P).
long long gdn_backward_workspace(int B, int C, int P, int dtype) {
  const long long elems = (long long)B * C * P;
  return elems + (long long)backward_partials(B, P) * C * (C + 1) +
         (direct_in_workspace(C, dtype) ? elems : 0);
}

// The dtype code of the gamma the kernels take for x of dtype code `dtype`
// and C channels: bfloat16 (1) in the bfloat16 design (bfloat16 x, C <=
// 256), else float32 (0).
int gdn_gamma_dtype(int C, int dtype) { return dtype == 1 && C <= bfd::MAX_C ? 1 : 0; }

// x, y: (B, C, P) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// gamma (C, C) in gdn_gamma_dtype(C, dtype) and beta (C,) float32.
// Returns 0, -3 when C needs more
// shared memory than a block has, -4 for an unknown dtype, -5 when no
// cluster of two of the kernel's blocks fits on the card, or the
// cudaError_t of the launch.
int gdn_forward(const void* x, const void* gamma, const void* beta, void* y,
                int B, int C, int P, int inverse, int dtype, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, gamma, beta, y, B, C, P, inverse, s);
  if (dtype == 1) return forward<bf16>(x, gamma, beta, y, B, C, P, inverse, s);
  return -4;
}

// g, x, dx: (B, C, P) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// gamma (C, C) in gdn_gamma_dtype(C, dtype); dgamma (C, C) and beta, dbeta
// (C,) float32; workspace:
// gdn_backward_workspace(B, C, P, dtype) floats, 16-byte aligned. Returns
// as gdn_forward does.
int gdn_backward(const void* g, const void* x, const void* gamma,
                 const void* beta, void* dx, void* dgamma, void* dbeta,
                 void* workspace, int B, int C, int P, int inverse, int dtype,
                 void* stream) {
  if (C == 0) return 0;
  if (dtype != 0 && dtype != 1) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_partials = backward_partials(B, P);
  if (n_partials == 0) {  // no pixels: the sums are zero
    cudaMemsetAsync(dgamma, 0, sizeof(float) * (size_t)C * C, s);
    cudaMemsetAsync(dbeta, 0, sizeof(float) * (size_t)C, s);
    return (int)cudaGetLastError();
  }
  return dtype == 0 ? backward<float>(g, x, gamma, beta, dx, dgamma, dbeta, workspace, B, C, P,
                                      inverse, n_partials, s)
                    : backward<bf16>(g, x, gamma, beta, dx, dgamma, dbeta, workspace, B, C, P,
                                     inverse, n_partials, s);
}

}  // extern "C"
