// Fused GDN / IGDN, forward and backward, for Hopper (sm_90a), float32.
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
// What bounds it on an H100: operations. Per pixel the forward does one
// C x C product (2 C^2 operations) on 2 C values moved (x in, y out), 96
// operations per byte at C = 192; the backward does three (6 C^2) on 3 C
// values (x, g in, dx out), 192 per byte. On the f32 FMA units (67 TFLOP/s)
// both are far above the 20 operations per byte at which that rate meets
// the memory's (3.35 TB/s). The backward's products run on the tensor cores
// in 3xTF32: three TF32 products (495 TFLOP/s dense) for each f32 product,
// 165 TFLOP/s of f32 products, which meets the memory's rate at ~50
// operations per byte, still under the backward's 192.
//
// The forward, kept simple (f32 FMA units): a block owns a tile of TP = 32
// pixels of one image and all C channels. x of the tile is read from device
// memory once, many loads in flight, into shared memory, and the product
// and epilogue run out of shared memory, x squared where it is read. gamma
// is staged through shared memory in chunks of BK input channels by TO =
// 192 output channels, and each thread keeps a 6 x 4 register tile (6
// channels, 4 pixels: 10 conflict-free shared-memory reads per 24
// multiply-adds).
//
// The backward:
// - All three products run on the tensor cores with mma.sync m16n8k8 in
//   3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
//   (integer rounding of the bit pattern) and the product accumulates
//   lo*hi + hi*lo + hi*hi, dropping lo*lo (about 2^-22 of the product). The
//   tensor cores' own additions do not round to nearest, so sums over 32
//   channels or pixels start from zero and are added up in f32: dx stays
//   within about 4e-6 of the plain version (tolerance 1e-5).
// - gdn_bwd_kernel_dx_resident (C <= 192, every GDN of the model): one
//   block per SM holds gamma in shared memory (150 KB at C = 192, loaded
//   once) and walks tiles of 32 pixels. Per tile no gamma moves and the
//   products run with no barrier inside; dn stays in shared memory, the
//   direct term of dx and x in registers, and the next tile's x loads
//   during the second product.
// - gdn_bwd_kernel_dx_streamed (C > 192): gamma streams through a
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

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

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

// acc[j][q] += sum_k A[c0 + ty*RM + j][k] * B[k][tx*RN + q], k < C.
// A is gamma read as gamma[c][k] (TRANS = false: rows are output channels,
// for n = Gamma x^2) or as gamma[k][c] (TRANS = true: for Gamma^T dn).
// B is the (C x LD) tile Bs in shared memory, squared when SQUARE. Ends with
// a barrier, so As can be restaged by the next call.
template <bool TRANS, bool SQUARE>
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
      const int kk = TRANS ? t / TO : t % BK;
      const int cc = TRANS ? t % TO : t / BK;
      const int c = c0 + cc;
      const int k = k0 + kk;
      v[r] = 0.f;
      if (c < C && k < C) {
        v[r] = TRANS ? gamma[(size_t)k * C + c] : gamma[(size_t)c * C + k];
      }
    }
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      const int t = tid + r * THREADS;
      const int kk = TRANS ? t / TO : t % BK;
      const int cc = TRANS ? t % TO : t / BK;
      As[kk * ALD + cc] = v[r];
    }
    __syncthreads();
    const int kmax = min(BK, C - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float* arow = As + kk * ALD + ty * RM;
      const float* brow = Bs + (size_t)(k0 + kk) * LD + tx * RN;
      float b[RN];
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        b[q] = brow[q];
        if (SQUARE) b[q] *= b[q];
      }
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

// dst[c][p] = src[c][p0 + p], zero past the end of the image; LOADS loads
// in flight per thread.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int C,
                                          int P, int p0, float* dst) {
  for (int t0 = threadIdx.x; t0 < C * TP; t0 += LOADS * THREADS) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * THREADS;
      const int c = t / TP;
      const int p = t % TP;
      v[u] = (t < C * TP && p0 + p < P) ? src[(size_t)c * P + p0 + p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * THREADS;
      if (t < C * TP) dst[(t / TP) * LD + t % TP] = v[u];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gdn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ y, int C,
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
    chunk_product<false, true>(gamma, C, c0, xs, As, acc);
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int o = c0 + ty * RM + j;
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int pl = tx * RN + q;
        if (o < C && p0 + pl < P) {
          const float n = acc[j][q] + beta[o];
          const float r = inverse ? sqrtf(n) : rsqrtf(n);
          y[base + (size_t)o * P + p0 + pl] = xs[o * LD + pl] * r;
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
// neighbours to overlap with.
template <int I, int J>
__device__ __forceinline__ void mma_3xtf32_grid(float (&c)[I][J][4], const uint32_t (&ah)[I][4],
                                                const uint32_t (&al)[I][4],
                                                const uint32_t (&bh)[J][2],
                                                const uint32_t (&bl)[J][2]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(c[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(c[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(c[i][j], ah[i], bh[j]);
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
constexpr int SP = 16;        // pixels per tile with gamma streamed (C > MO)
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

// dx and dn for C > MO, a tile of SP pixels of one image and all C
// channels per block. Shared memory: x and dn as (CK x SP) tiles (row
// stride SP + 8: the B fragments' reads hit 32 banks; g is staged in dn's
// place) and a ring of NS gamma chunks. Channels go in passes of MO; each
// pass runs the k-chunks of gamma through the ring, 8 warps each holding
// 3 m-tiles by SP / 16 n-tiles of accumulators. Chunk q + NS - 1 is in
// flight while chunk q computes; the ring runs on from the first product
// into the second. The direct term of dx waits in dx between the two.
__global__ void __launch_bounds__(bwd::THREADS)
gdn_bwd_kernel_dx_streamed(const float* __restrict__ g, const float* __restrict__ x,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           float* __restrict__ dx, float* __restrict__ dn_out, int C, int P,
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
      mma_3xtf32_grid(part, ah, al, bh, bl);
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
                dx[gi] = direct;
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
                                     ? dx[base + (size_t)c * P + p0 + pl] : 0.f;
            }
#pragma unroll
        for (int mi = 0; mi < 3; ++mi)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int c, pl;
              if (!at_of(mi, j, e, c, pl) || p0 + pl >= P) continue;
              dx[base + (size_t)c * P + p0 + pl] =
                  direct[mi][j][e] + 2.f * xs[c * LDT + pl] * acc[mi][j][e];
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
        mma_3xtf32_grid(part, ah, al, bh, bl);
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
            dx[base + (size_t)c * P + pl] = direct[mi][j][e] + 2.f * xr[mi][j][e] * acc[mi][j][e];
          }
        }
    __syncthreads();  // the next tile's g overwrites dn
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
__global__ void __launch_bounds__(bwd::THREADS)
gdn_bwd_kernel_dgamma(const float* __restrict__ dn, const float* __restrict__ x,
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
      const float* src = (which ? x : dn) + base + (size_t)c * P + pp + p;
      copy4(st + (which * GT + r) * LDK + p, src, c < C ? P - pp - p : 0, aligned);
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
      mma_3xtf32_grid(part, ah, al, bh, bl);
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

int tiles_per_image(int P) { return (P + TP - 1) / TP; }

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > MAX_SMEM) return -3;
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

int launch_dx_streamed(const float* g, const float* x, const float* gamma, const float* beta,
                       float* dx, float* dn, int B, int C, int P, int inverse, cudaStream_t s) {
  const int CK = (C + bwd::BK - 1) / bwd::BK * bwd::BK;
  const size_t smem =
      sizeof(float) * (2 * (size_t)CK * (bwd::SP + 8) + (size_t)bwd::NS * bwd::SLOT + CK);
  int rc = set_smem((const void*)gdn_bwd_kernel_dx_streamed, smem);
  if (rc != 0) return rc;
  const int tpi = (P + bwd::SP - 1) / bwd::SP;
  const int x_aligned = P % 4 == 0 && ((uintptr_t)x | (uintptr_t)g) % 16 == 0;
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  gdn_bwd_kernel_dx_streamed<<<B * tpi, bwd::THREADS, smem, s>>>(
      g, x, gamma, beta, dx, dn, C, P, tpi, inverse, x_aligned, gamma_aligned);
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
  const int x_aligned = P % 4 == 0 && ((uintptr_t)x | (uintptr_t)g) % 16 == 0;
  const int gamma_aligned = C % 4 == 0 && (uintptr_t)gamma % 16 == 0;
  // one block per SM (gamma fills most of its shared memory); every tile is
  // computed alone, so the grid size changes no result
  gdn_bwd_kernel_dx_resident<<<n_tiles < sms ? n_tiles : sms, bwd::THREADS, smem, s>>>(
      g, x, gamma, beta, dx, dn, C, P, tpi, n_tiles, inverse, x_aligned, gamma_aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial slots of the backward's dGamma/dbeta sums for B images of P
// pixels: a function of the shapes alone, not of the card.
int gdn_backward_partials(int B, int P) {
  const long long chunks = (long long)B * ((P + bwd::KB - 1) / bwd::KB);
  return (int)(chunks < bwd::MAX_PARTIALS ? chunks : bwd::MAX_PARTIALS);
}

// Floats of workspace the backward needs: dn (B x C x P) and the partial
// slots (gdn_backward_partials(B, P) x C x (C + 1)).
long long gdn_backward_workspace(int B, int C, int P) {
  return (long long)B * C * P + (long long)gdn_backward_partials(B, P) * C * (C + 1);
}

// x, y: (B, C, P) float32 contiguous; gamma (C, C); beta (C,).
// Returns 0, -3 when C needs more shared memory than a block has, or the
// cudaError_t of the launch.
int gdn_forward(const void* x, const void* gamma, const void* beta, void* y,
                int B, int C, int P, int inverse, void* stream) {
  if (B == 0 || P == 0 || C == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)C * LD + BK * ALD);
  int rc = set_smem((const void*)gdn_fwd_kernel, smem);
  if (rc != 0) return rc;
  const int tpi = tiles_per_image(P);
  gdn_fwd_kernel<<<B * tpi, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y), C, P, tpi,
      inverse);
  return (int)cudaGetLastError();
}

// g, x, dx: (B, C, P) float32 contiguous; gamma, dgamma (C, C); beta, dbeta
// (C,); workspace: gdn_backward_workspace(B, C, P) floats, 16-byte aligned.
int gdn_backward(const void* g, const void* x, const void* gamma,
                 const void* beta, void* dx, void* dgamma, void* dbeta,
                 void* workspace, int B, int C, int P, int inverse,
                 void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_partials = gdn_backward_partials(B, P);
  if (n_partials == 0) {  // no pixels: the sums are zero
    cudaMemsetAsync(dgamma, 0, sizeof(float) * (size_t)C * C, s);
    cudaMemsetAsync(dbeta, 0, sizeof(float) * (size_t)C, s);
    return (int)cudaGetLastError();
  }
  const float* gf = static_cast<const float*>(g);
  const float* xf = static_cast<const float*>(x);
  const float* gammaf = static_cast<const float*>(gamma);
  const float* betaf = static_cast<const float*>(beta);
  float* dxf = static_cast<float*>(dx);
  float* dn = static_cast<float*>(workspace);
  float* partials = dn + (size_t)B * C * P;
  // gamma resident in shared memory up to MO channels; above, gamma
  // streams through the ring beside tiles of 16 pixels
  int rc = C <= bwd::MO
               ? launch_dx_resident(gf, xf, gammaf, betaf, dxf, dn, B, C, P, inverse, s)
               : launch_dx_streamed(gf, xf, gammaf, betaf, dxf, dn, B, C, P, inverse, s);
  if (rc != 0) return rc;

  const size_t smem = sizeof(float) * (size_t)bwd::GNS * 2 * bwd::GT * bwd::LDK;
  rc = set_smem((const void*)gdn_bwd_kernel_dgamma, smem);
  if (rc != 0) return rc;
  const int cpi = (P + bwd::KB - 1) / bwd::KB;
  const int tiles = (C + bwd::GT - 1) / bwd::GT;
  const int aligned = P % 4 == 0 && ((uintptr_t)x | (uintptr_t)dn) % 16 == 0;
  gdn_bwd_kernel_dgamma<<<dim3(tiles * tiles, n_partials), bwd::THREADS, smem, s>>>(
      dn, xf, partials, C, P, cpi, B * cpi, aligned);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n = C * (C + 1);
  gdn_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      partials, n_partials, C, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}

}  // extern "C"
