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
// values (x, g in, dx out), 192 per byte. Both are far above the 20
// operations per byte at which the card's f32 rate (67 TFLOP/s, no tensor
// cores) meets its memory rate (3.35 TB/s).
//
// What the design does about it, kept simple (no tensor cores yet: f32
// products must stay f32): a block owns a tile of TP = 32 pixels of one
// image and all C channels. x (and in the backward g) of the tile are read
// from device memory once, many loads in flight, into shared memory, and
// every product and epilogue runs out of shared memory, x squared where it
// is read. gamma is staged through shared memory in chunks of BK input
// channels by TO = 192 output channels, and each thread keeps a 6 x 4
// register tile (6 channels, 4 pixels: 10 conflict-free shared-memory
// reads per 24 multiply-adds). In the backward, dn and the direct term of
// dx never leave shared memory: the three products (n, Gamma^T dn,
// dn x^2^T) run back to back on the tile; in the last one each warp owns 8
// output channels by 128 input channels, lane l taking channels l, l+32,
// l+64, l+96, so its reads of x fall in 32 different banks and its
// read-add-write of the partial sums is coalesced, all reads issued before
// the first write.
//
// The sum of dGamma and dbeta over all pixels (the Pallas kernel revisits one
// VMEM block across sequential grid steps) is a deterministic two-stage
// reduce: the backward launches a fixed number of blocks (at most
// MAX_PARTIALS, independent of the card), each owning a fixed contiguous
// range of tiles and accumulating its partial (C x (C + 1): dGamma with dbeta
// as an extra column) in its own slot of a workspace, and a second kernel
// sums the slots in a fixed order. No atomics anywhere: every output has one
// writer and a fixed order of sums, so the results are the same bits run to
// run. Pixels past the end of an image (a ragged last tile, any P) load as
// zero, so they add nothing to dn and hence nothing to the sums.
//
// Plain C interface for ctypes (no PyTorch headers); the wrapper is
// icm_tpu_torch/nn/gdn_fused.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
constexpr int GO = 8;           // dGamma: output channels per warp group
constexpr int GQ = 4;           // dGamma: input channels per lane (stride 32)
constexpr int STAGE = BK * TO / THREADS;  // gamma values each thread stages
constexpr int LOADS = 8;        // tile values each thread has in flight
constexpr int MAX_PARTIALS = 256;
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

__global__ void __launch_bounds__(THREADS)
gdn_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               float* __restrict__ dx, float* __restrict__ partials, int C,
               int P, int tiles_per_image, int n_tiles, int inverse) {
  extern __shared__ float smem[];
  float* xs = smem;              // (C, LD): x of the tile
  float* dns = xs + C * LD;      // (C, LD): dn
  float* dds = dns + C * LD;     // (C, LD): g, then the direct term of dx
  float* As = dds + C * LD;      // (BK, ALD): staged gamma chunk
  const int tid = threadIdx.x;
  const int tx = tid % (TP / RN);
  const int ty = tid / (TP / RN);
  const int blk = blockIdx.x;
  const int t_begin = (int)((long long)n_tiles * blk / gridDim.x);
  const int t_end = (int)((long long)n_tiles * (blk + 1) / gridDim.x);
  const int CP = C + 1;          // dGamma columns plus the dbeta column
  float* part = partials + (size_t)blk * C * CP;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b = tile / tiles_per_image;
    const int p0 = (tile % tiles_per_image) * TP;
    const size_t base = (size_t)b * C * P;

    load_tile(x + base, C, P, p0, xs);
    load_tile(g + base, C, P, p0, dds);
    __syncthreads();

    // 1. n = beta + Gamma x^2; dn and the direct term of dx, per output
    //    channel. Past the end of the image x = g = 0, so dn = 0 there.
    for (int c0 = 0; c0 < C; c0 += TO) {
      float acc[RM][RN] = {};
      chunk_product<false, true>(gamma, C, c0, xs, As, acc);
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int o = c0 + ty * RM + j;
        if (o >= C) continue;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int at = o * LD + tx * RN + q;
          const float n = acc[j][q] + beta[o];
          const float r = rsqrtf(n);
          const float xv = xs[at];
          const float gv = dds[at];
          if (inverse) {
            dds[at] = gv * (n * r);
            dns[at] = 0.5f * gv * xv * r;
          } else {
            dds[at] = gv * r;
            dns[at] = -0.5f * gv * xv * (r * r * r);
          }
        }
      }
    }
    __syncthreads();

    // 2. dx = direct term + 2 x (Gamma^T dn), per input channel
    for (int c0 = 0; c0 < C; c0 += TO) {
      float acc[RM][RN] = {};
      chunk_product<true, false>(gamma, C, c0, dns, As, acc);
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int i = c0 + ty * RM + j;
        if (i >= C) continue;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int pl = tx * RN + q;
          if (p0 + pl < P) {
            const int at = i * LD + pl;
            dx[base + (size_t)i * P + p0 + pl] = dds[at] + 2.f * xs[at] * acc[j][q];
          }
        }
      }
    }

    // 3. this tile's share of dGamma[o][i] = sum_p dn[o][p] x[i][p]^2 and of
    //    dbeta[o] = sum_p dn[o][p] (column i = C), added into the block's
    //    slot. A warp group is GO output channels by 32 * GQ input
    //    channels; lane l takes channels i0 + l + 32 q, so the lanes' reads
    //    of x hit 32 banks and their reads and writes of the slot are
    //    coalesced; all of a lane's slot reads are issued before its writes.
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int n_og = (C + GO - 1) / GO;
    const int n_ig = (CP + 32 * GQ - 1) / (32 * GQ);
    for (int grp = warp; grp < n_og * n_ig; grp += THREADS / 32) {
      const int o0 = (grp / n_ig) * GO;
      const int i0 = (grp % n_ig) * (32 * GQ) + lane;
      float acc[GO][GQ] = {};
      if (tile != t_begin) {
#pragma unroll
        for (int j = 0; j < GO; ++j) {
#pragma unroll
          for (int q = 0; q < GQ; ++q) {
            const int i = i0 + 32 * q;
            if (o0 + j < C && i < CP) acc[j][q] = part[(size_t)(o0 + j) * CP + i];
          }
        }
      }
      for (int pl = 0; pl < TP; ++pl) {
        float a[GO];
        float sq[GQ];
#pragma unroll
        for (int j = 0; j < GO; ++j) {
          a[j] = o0 + j < C ? dns[(o0 + j) * LD + pl] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < GQ; ++q) {
          const int i = i0 + 32 * q;
          const float xv = i < C ? xs[i * LD + pl] : 0.f;
          sq[q] = i == C ? 1.f : xv * xv;
        }
#pragma unroll
        for (int j = 0; j < GO; ++j) {
#pragma unroll
          for (int q = 0; q < GQ; ++q) acc[j][q] = fmaf(a[j], sq[q], acc[j][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < GO; ++j) {
#pragma unroll
        for (int q = 0; q < GQ; ++q) {
          const int i = i0 + 32 * q;
          if (o0 + j < C && i < CP) part[(size_t)(o0 + j) * CP + i] = acc[j][q];
        }
      }
    }
    __syncthreads();  // the next tile overwrites xs, dns and dds
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

}  // namespace

extern "C" {

// Number of partial slots the backward uses for B images of P pixels; the
// caller allocates a workspace of n x C x (C + 1) floats.
int gdn_backward_partials(int B, int P) {
  const long long n_tiles = (long long)B * tiles_per_image(P);
  return (int)(n_tiles < MAX_PARTIALS ? n_tiles : MAX_PARTIALS);
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
// (C,); workspace: gdn_backward_partials(B, P) x C x (C + 1) floats.
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
  const size_t smem = sizeof(float) * (3 * (size_t)C * LD + BK * ALD);
  int rc = set_smem((const void*)gdn_bwd_kernel, smem);
  if (rc != 0) return rc;
  const int tpi = tiles_per_image(P);
  gdn_bwd_kernel<<<n_partials, THREADS, smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(dx), static_cast<float*>(workspace), C, P, tpi,
      B * tpi, inverse);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n = C * (C + 1);
  gdn_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(workspace), n_partials, C,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}

}  // extern "C"
