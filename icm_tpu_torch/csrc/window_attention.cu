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
// (two products) on 4*N*D values moved (q, k, v in, out back). In f32
// that is 16 operations per byte at N=64, D=24 and 4 at N=16, D=40, under
// the 20 operations per byte at which the card's f32 rate (67 TFLOP/s)
// meets its memory rate (3.35 TB/s). At W=256 windows per 512-px image
// (N=64, D=24, 8 heads, f32) q, k, v and out are 4 x 12.6 MB per image,
// so the floor is about 15 us per image.
//
// What the design does about it: each of q, k, v is read from device
// memory once and out written once; the N x N scores never leave the SM.
// One block per (window, head), one thread per query row. The block
// stages k and v of its window-head in shared memory in f32 (read by every
// thread as 16-byte broadcasts, four multiply-adds per read), the thread
// keeps its scaled q row and its output row in registers, and
// writes its row of scores to a padded shared-memory row (N+1 stride, no
// bank conflicts) so that the exact softmax (max, sum, divide) runs in f32
// without a second pass over k. The bias row is read from the
// (n_cls, H, N, N) class table, which stays in L2 (512 KB at N=64).
// No atomics: every output element has one writer, so the result is
// deterministic, which the autoregressive coder needs. Any W is taken:
// the grid is (W, H) and needs no padding. A window whose class is out of
// range gets NaN output rather than a silent wrong answer.
//
// Plain C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds); the wrapper is icm_tpu_torch/nn/window_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// round an f32 value to T's precision and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

template <typename T, int D>
__global__ void window_attention_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const int32_t* __restrict__ cls,
                                        T* __restrict__ out, int H, int N,
                                        int n_cls, float scale) {
  static_assert(D % 4 == 0, "rows are read as float4");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (N, D), 16-byte rows
  float* vs = ks + N * D;                       // (N, D)
  float* sc = vs + N * D;                       // (N, N + 1) score rows

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const size_t base = ((size_t)w * H + h) * (size_t)N * D;

  for (int t = threadIdx.x; t < N * D; t += blockDim.x) {
    ks[t] = to_f32<T>(k[base + t]);
    vs[t] = to_f32<T>(v[base + t]);
  }
  __syncthreads();

  const int c = cls[w];
  const bool valid = c >= 0 && c < n_cls;
  const float* bias_h = bias + ((size_t)(valid ? c : 0) * H + h) * (size_t)N * N;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = round_to<T>(to_f32<T>(q[base + (size_t)i * D + d]) * scale);
    }
    const float* brow = bias_h + (size_t)i * N;
    float* srow = sc + i * (N + 1);

    float m = -INFINITY;
    for (int j = 0; j < N; ++j) {
      const float4* kj = reinterpret_cast<const float4*>(ks + j * D);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kj[d4];  // one 16-byte broadcast read, 4 FMAs
        s = fmaf(qr[4 * d4 + 0], kk.x, s);
        s = fmaf(qr[4 * d4 + 1], kk.y, s);
        s = fmaf(qr[4 * d4 + 2], kk.z, s);
        s = fmaf(qr[4 * d4 + 3], kk.w, s);
      }
      s += brow[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = expf(srow[j] - m);
      srow[j] = p;
      l += p;
    }
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float a = round_to<T>(srow[j] / l);
      const float4* vj = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vj[d4];
        acc[4 * d4 + 0] = fmaf(a, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(a, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(a, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(a, vv.w, acc[4 * d4 + 3]);
      }
    }
    T* orow = out + base + (size_t)i * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(valid ? acc[d] : NAN);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* cls, void* out, int W, int H, int N, int n_cls,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)N * D + (size_t)N * (N + 1));
  auto kernel = window_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = N < 32 ? N : ((N + 31) / 32) * 32;
  dim3 grid(W, H);
  kernel<<<grid, threads > 1024 ? 1024 : threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int32_t*>(cls), static_cast<T*>(out), H, N, n_cls,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* bias, const void* cls, void* out, int W, int H,
             int N, int n_cls, float scale, cudaStream_t stream) {
  switch (D) {
#define CASE(DD) \
  case DD:       \
    return launch<T, DD>(q, k, v, bias, cls, out, W, H, N, n_cls, scale, stream);
    CASE(24) CASE(40)  // the head widths of WACNN's window blocks
#undef CASE
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns 0, -1 for an unsupported head
// width, or the cudaError_t of the launch.
int window_attention_fwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* cls, void* out, int W,
                         int H, int N, int D, int n_cls, float scale,
                         int dtype, void* stream) {
  if (W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, bias, cls, out, W, H, N, n_cls, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, bias, cls, out, W, H, N, n_cls,
                                   scale, s);
  return -2;
}

}  // extern "C"
