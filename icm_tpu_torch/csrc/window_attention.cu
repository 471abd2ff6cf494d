// Window attention with a per-window bias class, for Hopper (sm_90a).
//
// Replaces icm_tpu/nn/pallas_kernels.py::_attn_kernel (the TPU Pallas
// kernel behind window_attention_fused). For every window w and head h:
//
//     out[w, h] = softmax((q[w, h] * scale) @ k[w, h]^T + bias[cls[w], h]) @ v[w, h]
//
// q, k, v, out: (W, H, N, D) contiguous, f32 or bf16; bias: (n_cls, H, N, N)
// f32 (the relative-position bias with the shifted-window mask folded in
// per window class); cls: (W,) int32. The numerics follow the Pallas
// kernel: q * scale is rounded to the input type, scores and softmax are
// f32, the softmax row is rounded to the input type before the PV product,
// which accumulates in f32; the output is rounded to the input type.
//
// What bounds it on an H100: bytes. A window-head does 4*N*N*D operations
// (two products) on 4*N*D values moved (q, k, v in, out back): in f32, N/4
// operations per byte whatever D, so 16 at N=64 (WACNN's 8x8 windows, D=24)
// and 4 at N=16 (4x4 windows: WACNN's D=40 and stf's D=16). On the tensor
// cores even three TF32 products per product (below) stay under the
// ~50 operations per byte at which their rate meets the memory's, so the
// floor is the bytes: about 15 us per 512-px image at N=64, D=24, f32; for
// stf's twelve launches a side at 2 x 512 px (W x H of 8192 x 3, 2048 x 6,
// 512 x 12 and 128 x 24 window-heads of 16 x 16), 30.0, 15.0, 7.5 and
// 3.8 us a launch, 0.1425 ms a side. The zigzag family's per-slice
// refiners attend on small maps: at 2 x 512 px a launch holds 32 to 512
// window-heads (N 16 or 64, D 8 or 16), 0.5-0.8 MB in f32, a byte bound of
// 0.16-0.24 us, far below the cost of a launch itself. The CRC family
// (stf9, stf11, stf14) adds D 32 at N 64 (MainCNNDecoder's 256-channel
// block: 512 windows x 8 heads at 2 x 512 px) and D 48 at N 16 (its
// 384-channel blocks, 128 x 8): 134 and 12.6 MB of q, k, v, out in f32,
// byte bounds of 40 and 3.8 us.
//
// What the design does about it:
// - The products run on the tensor cores with mma.sync, several query rows
//   per warp, flash-attention style: a warp owns 16 query rows of one
//   window-head and keeps their scores (16 x N) in registers as mma
//   accumulator fragments. The softmax runs in registers: a row lives in
//   the four lanes of a quad, so its max and sum take two shuffles each.
//   The probabilities go from the score accumulators into the PV product's
//   A operand without a trip through shared memory.
// - f32 inputs use 3xTF32: each operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi), and the product accumulates lo*hi + hi*lo + hi*hi
//   (lo*lo, about 2^-22 of the product, is dropped). The m16n8k8 TF32 shape
//   takes the head width (8, 16, 24, 32, 40, 48) as it is: D/8 k-steps in
//   q k^T, D/8 output tiles in the PV product (one of each at D = 8). In
//   the PV product the keys of each 8-key step are taken in the order 0,
//   2, 4, 6, 1, 3, 5, 7, so the score fragment (columns 2t, 2t+1 in lane t
//   of a quad) is the A fragment as it stands (columns t, t+4); v's rows
//   are read in the same order.
//   The tensor cores' own additions do not round to nearest, so each key
//   step's PV share is summed from zero and added to the output in f32, and
//   the bias is added to the scores after q k^T: the result stays within
//   about 2e-6 of the plain version (tolerance 1e-5).
// - bf16 inputs use m16n8k16 bf16 with f32 accumulation. q * scale and the
//   probabilities are rounded to bf16 before their products, as in the
//   Pallas kernel. The head width is padded to the k16 step with zeros in
//   shared memory (8 -> 16, 24 -> 32, 40 -> 48; 16, 32 and 48 need none):
//   the padded columns of q and k are zeroed before the copies and never
//   written by them, so they add exact zeros to q k^T; v's are never read,
//   since the PV product takes D / 8 output tiles of the real columns only.
// - A block of four warps takes one item: one window-head at N > 32 (a
//   warp per 16 query rows), two at N <= 32, four at N <= 16 (a warp each).
//   Its q, k, v and bias slabs are staged in shared memory by 16-byte
//   cp.async, coalesced (a window-head's N x D block and a class's N x N
//   slab are contiguous); rows past N load as zeros. Several blocks are
//   resident on an SM (five at N = 64, D = 24, f32), so one block's loads
//   are in flight while the others compute. On an H100 this was faster
//   than fewer blocks that each walk many window-heads through a
//   double-buffered stage, whose larger shared memory left fewer blocks
//   per SM.
// - Row strides are padded (D + 4 floats, the padded width + 8 bf16 values,
//   N + 8 floats for the bias) so that the fragment reads of a warp hit
//   distinct banks. f32: lane (g, t) reads word g*LD + t of q or k, and
//   LD = 12, 20, 28, 36, 44, 52 (D = 8, 16, 24, 32, 40, 48) is 4 times an
//   odd number, so g*LD mod 32 takes the eight multiples of 4 and t fills
//   the gaps; it reads v at word 2t*LD + g, and 2*LD mod 32 = 24, 8, 24,
//   8, 24, 8 puts the four t eight banks apart. bf16 (D = 8 laid out as
//   16): a q or k pair is word g*LD/2 + t, LD/2 = 12, 20, 28 (D 8 and 16,
//   24 and 32, 40 and 48; 4 times an odd number again); v's values are
//   words t*LD + g/2, two lanes to a word, and t*LD mod 32 (LD = 24, 40,
//   56) takes four distinct multiples of 8, so the quads' four words each
//   land eight banks apart.
// - A score more than 87 below its row's max (a masked key) takes
//   probability 0 rather than a subnormal exp, and the row is normalised by
//   one reciprocal: expf and division of subnormals take slow paths, which
//   about doubled the time at the shifted windows' -100 mask.
//
// Contract: any W with no padding by the caller; N from 1 to 128 (partial
// tiles masked: keys past N score -inf, rows past N are not written); D 8
// (the stf5 and stf7 refiners), 16 (stf, the stf6 and stf8 refiners), 24
// and 40 (WACNN), 32 and 48 (the CRC family's MainCNN transforms); NaN
// output for a window whose class is out of range; no atomics, every
// output element has one writer, so the bits are the same run to run
// (the decoder's x_hat must equal the encoder's).
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds); the wrapper is icm_tpu_torch/nn/window_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// Shapes of the shared-memory stage for element type T and head width D.
template <typename T, int D>
struct Layout;
template <int D>
struct Layout<float, D> {
  static constexpr int DP = D;      // contraction width of q k^T
  static constexpr int LD = D + 4;  // row stride in elements
};
template <int D>
struct Layout<__nv_bfloat16, D> {
  static constexpr int DP = (D + 15) / 16 * 16;  // zero-padded to the k16 step
  static constexpr int LD = DP + 8;
};

// NTM: most 8-key tiles a row can have (the padded N / 8), a power of two.
template <typename T, int D, int NTM>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const int32_t* __restrict__ cls, T* __restrict__ out, int W,
                        int H, int N, int n_cls, float scale, int whs) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static_assert(D * sizeof(T) % 16 == 0, "rows are copied in 16-byte chunks");
  extern __shared__ float4 smem4[];

  const int NP = (N + 15) / 16 * 16;  // rows staged per window-head
  const int RT = NP / 16;             // row tiles of 16 per window-head
  const int NT = NP / 8;              // key tiles of 8 (even)
  const int LDB = NP + 8;             // row stride of a staged bias slab (floats)
  const int rows = whs * NP;          // rows of each of q, k, v in the block
  // shared memory: q, k, v (rows x LD of T each), then the bias slabs
  // (rows x LDB floats)
  const size_t qkv_bytes = (size_t)3 * rows * LD * sizeof(T);
  const long long total_wh = (long long)W * H;
  const long long wh0 = (long long)blockIdx.x * whs;  // the block's first window-head
  char* buf = reinterpret_cast<char*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within an 8-row half of the tile
  const int t = lane % 4;  // lane within the quad

  // bf16: the padded columns of q and k enter q k^T, so they must be zero
  if constexpr (L::DP > D) {
    for (int r = tid; r < 2 * rows; r += THREADS) {
      T* row = reinterpret_cast<T*>(buf) + (size_t)r * LD;
      for (int c = D; c < L::DP; ++c) row[c] = __float2bfloat16(0.f);
    }
  }

  // stage q, k, v and the bias slab of each window-head; rows past N and
  // window-heads past the end load as zeros
  for (int wl = 0; wl < whs; ++wl) {
    const long long wh = wh0 + wl;
    const bool live = wh < total_wh;
    for (int which = 0; which < 3; ++which) {
      const T* src = which == 0 ? q : (which == 1 ? k : v);
      T* dst = reinterpret_cast<T*>(buf) + ((size_t)which * rows + wl * NP) * LD;
      for (int c = tid; c < NP * CPR; c += THREADS) {
        const int i = c / CPR;
        const int ch = c - i * CPR;
        const bool ok = live && i < N;
        const char* gp = reinterpret_cast<const char*>(src);
        if (ok) gp += (((size_t)wh * N + i) * D) * sizeof(T) + ch * 16;
        cp_async16(reinterpret_cast<char*>(dst + (size_t)i * LD) + ch * 16, gp,
                   ok ? 16 : 0);  // 0 source bytes: zero fill
      }
    }
    if (!live) continue;
    // the slab of the window's class (0 when out of range: that window's
    // output is NaN) and of the head
    const int w = (int)(wh / H);
    const int cw = cls[w];
    const int cc = cw >= 0 && cw < n_cls ? cw : 0;
    const float* slab = bias + ((size_t)cc * H + (int)(wh - (long long)w * H)) * (size_t)N * N;
    float* bdst = reinterpret_cast<float*>(buf + qkv_bytes) + (size_t)wl * NP * LDB;
    for (int c = tid; c < NP * (NP / 4); c += THREADS) {
      const int i = c / (NP / 4);
      const int j = (c - i * (NP / 4)) * 4;
      float* d = bdst + (size_t)i * LDB + j;
      if (N % 4 == 0) {  // rows of 16-byte chunks
        const bool ok = i < N && j < N;
        cp_async16(d, ok ? slab + (size_t)i * N + j : slab, ok ? 16 : 0);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (i < N && j + e < N) {
            cp_async4(d + e, slab + (size_t)i * N + j + e);
          } else {
            d[e] = 0.f;
          }
        }
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const T* qs = reinterpret_cast<const T*>(buf);
  const T* ks = qs + (size_t)rows * LD;
  const T* vs = ks + (size_t)rows * LD;
  const float* bs = reinterpret_cast<const float*>(buf + qkv_bytes);
  for (int task = warp; task < whs * RT; task += WARPS) {
    const int wl = task / RT;
    const int rt = task - wl * RT;
    const long long wh = wh0 + wl;
    if (wh >= total_wh) break;
    const int c = cls[wh / H];
    const bool valid = c >= 0 && c < n_cls;
    const int r0 = rt * 16 + g;  // this lane's rows: r0 and r0 + 8
    const int r1 = r0 + 8;
    const T* qa = qs + (size_t)(wl * NP) * LD;
    const T* ka = ks + (size_t)(wl * NP) * LD;
    const T* va = vs + (size_t)(wl * NP) * LD;

    float s[NTM][4] = {};  // scores, from zero; the bias is added after q k^T
    if constexpr (sizeof(T) == 4) {
      // q * scale as the A fragments of the D / 8 k-steps, split for 3xTF32
      constexpr int KS = D / 8;
      uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c0 = kk * 8 + t;
        split_tf32(qa[r0 * LD + c0] * scale, qh[kk][0], ql[kk][0]);
        split_tf32(qa[r1 * LD + c0] * scale, qh[kk][1], ql[kk][1]);
        split_tf32(qa[r0 * LD + c0 + 4] * scale, qh[kk][2], ql[kk][2]);
        split_tf32(qa[r1 * LD + c0 + 4] * scale, qh[kk][3], ql[kk][3]);
      }
      // key tiles in groups of four, each k-step as three passes over the
      // group, so that every mma has independent neighbours
      constexpr int NG = NTM < 4 ? NTM : 4;
#pragma unroll
      for (int n0 = 0; n0 < NTM; n0 += NG) {
        if (n0 < NT) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
            for (int u = 0; u < NG; ++u) {
              const T* krow = ka + (size_t)((n0 + u) * 8 + g) * LD + kk * 8 + t;
              split_tf32(krow[0], bh[u][0], bl[u][0]);
              split_tf32(krow[4], bh[u][1], bl[u][1]);
            }
#pragma unroll
            for (int u = 0; u < NG; ++u) mma_tf32(s[n0 + u], ql[kk], bh[u]);
#pragma unroll
            for (int u = 0; u < NG; ++u) mma_tf32(s[n0 + u], qh[kk], bl[u]);
#pragma unroll
            for (int u = 0; u < NG; ++u) mma_tf32(s[n0 + u], qh[kk], bh[u]);
          }
        }
      }
    } else {
      // bf16: q * scale rounded to bf16, k16 steps over the padded width
      constexpr int KS = L::DP / 16;
      const __nv_bfloat16 sc = __float2bfloat16(scale);
      auto qpair = [&](int r, int col) {
        const __nv_bfloat16* p = qa + (size_t)r * LD + col;
        return pack_bf16(__hmul(p[0], sc), __hmul(p[1], sc));
      };
      uint32_t qf[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c0 = kk * 16 + 2 * t;
        qf[kk][0] = qpair(r0, c0);
        qf[kk][1] = qpair(r1, c0);
        qf[kk][2] = qpair(r0, c0 + 8);
        qf[kk][3] = qpair(r1, c0 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) {
        if (nt < NT) {
          const T* krow = ka + (size_t)(nt * 8 + g) * LD;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t b[2];
            b[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 2 * t);
            b[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 2 * t + 8);
            mma_bf16(s[nt], qf[kk], b);
          }
        }
      }
    }

    // + bias, keys past N masked
    const float* brow = bs + (size_t)(wl * NP) * LDB + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      if (nt < NT) {
        const float2 b0 = *reinterpret_cast<const float2*>(brow + (size_t)r0 * LDB + nt * 8);
        const float2 b1 = *reinterpret_cast<const float2*>(brow + (size_t)r1 * LDB + nt * 8);
        s[nt][0] += b0.x;
        s[nt][1] += b0.y;
        s[nt][2] += b1.x;
        s[nt][3] += b1.y;
      }
    }
    // softmax over the row's N keys: a row lives in one quad
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      const int j = nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nt >= NT || j + (e & 1) >= N) s[nt][e] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      // exp of a score more than 87 below the row's max is under f32's
      // normal range (a masked key, -100): take it as 0 and keep expf
      // and the products below off their slow paths for subnormals
      s[nt][0] = s[nt][0] - m0 > -87.f ? expf(s[nt][0] - m0) : 0.f;
      s[nt][1] = s[nt][1] - m0 > -87.f ? expf(s[nt][1] - m0) : 0.f;
      s[nt][2] = s[nt][2] - m1 > -87.f ? expf(s[nt][2] - m1) : 0.f;
      s[nt][3] = s[nt][3] - m1 > -87.f ? expf(s[nt][3] - m1) : 0.f;
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // l >= 1: the max's own term
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      s[nt][0] *= inv0;
      s[nt][1] *= inv0;
      s[nt][2] *= inv1;
      s[nt][3] *= inv1;
    }

    // out = P v, D / 8 output tiles
    constexpr int DT = D / 8;
    float o[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int kk = 0; kk < NTM; ++kk) {
        if (kk < NT) {
          // keys kk*8 + 2t (A column t) and kk*8 + 2t + 1 (A column t + 4)
          uint32_t ah[4], al[4];
          split_tf32(s[kk][0], ah[0], al[0]);
          split_tf32(s[kk][2], ah[1], al[1]);
          split_tf32(s[kk][1], ah[2], al[2]);
          split_tf32(s[kk][3], ah[3], al[3]);
          const T* v0 = va + (size_t)(kk * 8 + 2 * t) * LD + g;
          uint32_t bh[DT][2], bl[DT][2];
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            split_tf32(v0[dt * 8], bh[dt][0], bl[dt][0]);
            split_tf32(v0[LD + dt * 8], bh[dt][1], bl[dt][1]);
          }
          // this key tile's share from zero, added to o in f32: the
          // tensor cores' own additions do not round to nearest
          float part[DT][4] = {};
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) mma_tf32(part[dt], al, bh[dt]);
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) mma_tf32(part[dt], ah, bl[dt]);
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) mma_tf32(part[dt], ah, bh[dt]);
#pragma unroll
          for (int dt = 0; dt < DT; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[dt][e] += part[dt][e];
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NTM / 2; ++kk) {
        if (2 * kk < NT) {
          uint32_t a[4];
          a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          const T* v0 = va + (size_t)(kk * 16 + 2 * t) * LD + g;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            uint32_t b[2];
            b[0] = pack_bf16(v0[dt * 8], v0[LD + dt * 8]);
            b[1] = pack_bf16(v0[8 * LD + dt * 8], v0[9 * LD + dt * 8]);
            mma_bf16(o[dt], a, b);
          }
        }
      }
    }

    T* obase = out + (size_t)wh * N * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r < N) {
          const float a = valid ? o[dt][2 * half] : NAN;
          const float b = valid ? o[dt][2 * half + 1] : NAN;
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(obase + (size_t)r * D + col) = make_float2(a, b);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)r * D + col) =
                __floats2bfloat162_rn(a, b);
          }
        }
      }
    }
  }
}

template <typename T, int D, int NTM>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* cls, void* out, int W, int H, int N, int n_cls,
           float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  const int NP = (N + 15) / 16 * 16;
  const int RT = NP / 16;
  const int whs = RT >= WARPS ? 1 : (RT == 3 ? 1 : WARPS / RT);
  // q, k, v and the bias slabs of the block's window-heads
  const size_t smem = (size_t)whs * NP * (3 * L::LD * sizeof(T) + (NP + 8) * sizeof(float));
  auto kernel = window_attention_kernel<T, D, NTM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = ((long long)W * H + whs - 1) / whs;
  if (grid > 0x7fffffff) return -5;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int32_t*>(cls),
      static_cast<T*>(out), W, H, N, n_cls, scale, whs);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_n(const void* q, const void* k, const void* v, const void* bias,
               const void* cls, void* out, int W, int H, int N, int n_cls,
               float scale, cudaStream_t stream) {
  if (N <= 16) return launch<T, D, 2>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
  if (N <= 32) return launch<T, D, 4>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
  if (N <= 64) return launch<T, D, 8>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
  return launch<T, D, 16>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* bias, const void* cls, void* out, int W, int H,
             int N, int n_cls, float scale, cudaStream_t stream) {
  switch (D) {
#define CASE(DD) \
  case DD:       \
    return dispatch_n<T, DD>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
    // the zigzag family's refiners, stf's, WACNN's, the CRC family's
    CASE(8) CASE(16) CASE(24) CASE(32) CASE(40) CASE(48)
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns 0, -1 for an unsupported head
// width, -4 for N outside 1..128, or the cudaError_t of the launch.
int window_attention_fwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* cls, void* out, int W,
                         int H, int N, int D, int n_cls, float scale,
                         int dtype, void* stream) {
  if (W == 0 || H == 0) return 0;
  if (N < 1 || N > 128) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, bias, cls, out, W, H, N, n_cls, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, bias, cls, out, W, H, N, n_cls,
                                   scale, s);
  return -2;
}

}  // extern "C"
