// Lane-parallel rANS, encode and decode, for Hopper (sm_90a): the device
// wire's entropy coder.
//
// Replaces two functions of icm_tpu/coding/device_rans.py that JAX runs as
// integer jnp under lax.scan (not Pallas):
//   decode_lanes (:178, with init_lanes :165)  per lane, T dependent steps:
//       peek = state & 0xFFFF; (value, f << 16 | start) = lut2[r, peek];
//       state = f * (state >> 16) + start; if state < 2^16, pull the lane's
//       next 16-bit word. (state, ptr) carry across calls, so the ChARM
//       slice chain continues the same streams.
//   encode_lanes (:231)  per lane, the T symbols in reverse: escape test
//       and (f, c) from fc; emit the low 16 bits if state >= f << 16; then
//       state = (state / f) << 16 + state % f + c. Words come out in decode
//       order [hi, lo, w_{K-1} .. w_0], with the lane's length and a byte
//       per symbol that marks an escape (its raw value travels beside the
//       stream; the wrapper compacts the marks).
// The words are the same, bit for bit, as JAX's and as the numpy oracle's
// (np_encode): 32-bit state, 16-bit words and precision, L = 2^16.
//
// Layout: values, rows and escape marks are (T, lanes) row-major, so the
// lanes of one step sit side by side and a warp's loads of one step are
// coalesced. Words are 16-bit (read as unsigned short). lut2 is the packed
// (n_rows * 65536, 2) pair table, fc the (n_rows, n_sym) table of
// f << 16 | c, eo the (n_rows, 2) (escape symbol, offset) pairs.
//
// What bounds it on an H100: not bytes and not operations. Each lane is a
// chain of T dependent steps; a decode step makes two dependent loads (the
// lut2 pair at an address its state picks, then, one time in a few, the
// next word), an encode step a 32-bit division after two dependent loads
// (eo, then fc at the symbol eo gives). The bytes are small: y at 2 x
// 512^2 is 2048 lanes x T = 320 symbols, under 8 MB with each distinct
// table entry it needs, about 2 us at 3.35 TB/s. The chain is T steps of
// a load's latency each (the 64-row Gaussian lut2, 33.6 MB, fits the 50 MB
// L2; the 192-row bottleneck table, 100.7 MB, does not). 2048 lanes fill
// only 32 blocks of 64 threads, a quarter of the SMs, so no amount of
// width hides the chain: latency sets the pace. Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W: y's ten decode launches of 32
// steps 0.336 ms (about 1 us a step), y's encode of 320 steps 0.138 ms
// (its loads do not depend on the state, so several stay in flight).
//
// What the design does about it: one thread per lane runs all T steps in
// a loop, with state and pointer in registers, so a step costs its loads'
// latency and a few integer instructions, and not a kernel launch (a
// Python loop of tensor ops would launch ~8 kernels a step). The loads
// that do not depend on the state (the step's row, value) are issued
// first in the step. Blocks of 64 threads spread the lanes over as many
// SMs as there are blocks. Packing lanes, splitting a lane's steps and
// holding lut2 close to the SMs are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kL = 1u << 16;  // renormalization interval lower bound
constexpr int kThreads = 64;

__global__ void rans_decode_lanes_kernel(
    const unsigned short* __restrict__ words, long long n_words,
    const int* __restrict__ off, const int* __restrict__ rows,
    const uint2* __restrict__ lut2, const unsigned* __restrict__ state_in,
    const int* __restrict__ ptr_in, int* __restrict__ values,
    unsigned* __restrict__ state_out, int* __restrict__ ptr_out, int T,
    int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const long long base = off[l];
  const long long last = n_words - 1;
  unsigned state;
  int ptr;
  if (state_in != nullptr) {
    state = state_in[l];
    ptr = ptr_in[l];
  } else {  // the flushed final encoder state: hi, lo
    const long long a = base < last ? base : last;
    const long long b = base + 1 < last ? base + 1 : last;
    state = ((unsigned)words[a] << 16) | (unsigned)words[b];
    ptr = 2;
  }
  for (int t = 0; t < T; ++t) {
    const size_t i = (size_t)t * lanes + l;
    const int r = rows[i];
    const uint2 e = lut2[((size_t)r << 16) + (state & 0xFFFFu)];
    values[i] = ((int)e.x ^ 0x8000) - 0x8000;  // sign-extend 16 bits
    state = (e.y >> 16) * (state >> 16) + (e.y & 0xFFFFu);
    if (state < kL) {
      long long w = base + ptr;
      if (w > last) w = last;  // a truncated stream reads no further
      state = (state << 16) | (unsigned)words[w];
      ++ptr;
    }
  }
  state_out[l] = state;
  ptr_out[l] = ptr;
}

__global__ void rans_encode_lanes_kernel(
    const int* __restrict__ values, const int* __restrict__ rows,
    const unsigned* __restrict__ fc, const int2* __restrict__ eo, int n_sym,
    unsigned short* __restrict__ buf, int* __restrict__ lengths,
    unsigned char* __restrict__ esc, int T, int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int maxw = T + 2;
  unsigned short* out = buf + (size_t)l * maxw;
  unsigned state = kL;
  int k = 0;  // emissions so far; emission k goes to slot maxw - 1 - k
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * lanes + l;
    const int v = values[i];
    const int r = rows[i];
    const int2 so = eo[r];  // (escape symbol, offset)
    const long long u = (long long)v - so.y;
    const bool is_esc = u < 0 || u >= so.x;
    esc[i] = is_esc;
    const unsigned x = fc[(size_t)r * n_sym + (is_esc ? so.x : (int)u)];
    const unsigned f = x >> 16;
    if (state >= (f << 16)) {
      out[maxw - 1 - k] = (unsigned short)(state & 0xFFFFu);
      ++k;
      state >>= 16;
    }
    const unsigned q = state / f;
    state = (q << 16) + (state - q * f) + (x & 0xFFFFu);
  }
  // decode order: hi, lo, then emissions K-1 .. 0, which sit at slots
  // maxw-K .. maxw-1; move them down to 2 .. K+1 (the source never lies
  // below the destination) and zero the rest of the row
  out[0] = (unsigned short)(state >> 16);
  out[1] = (unsigned short)(state & 0xFFFFu);
  const int src = maxw - k;
  for (int j = 0; j < k; ++j) out[2 + j] = out[src + j];
  for (int j = k + 2; j < maxw; ++j) out[j] = 0;
  lengths[l] = k + 2;
}

}  // namespace

extern "C" {

// Decode T symbols from each of `lanes` streams. state_in/ptr_in null:
// start each lane from its flushed state at words[off[l]].
int rans_decode_lanes(const void* words, long long n_words, const void* off,
                      const void* rows, const void* lut2, const void* state_in,
                      const void* ptr_in, void* values, void* state_out,
                      void* ptr_out, int T, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  rans_decode_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)words, n_words, (const int*)off, (const int*)rows,
      (const uint2*)lut2, (const unsigned*)state_in, (const int*)ptr_in,
      (int*)values, (unsigned*)state_out, (int*)ptr_out, T, lanes);
  return (int)cudaGetLastError();
}

// Encode (T, lanes) values into (lanes, T + 2) word rows in decode order,
// per-lane lengths and (T, lanes) escape marks.
int rans_encode_lanes(const void* values, const void* rows, const void* fc,
                      const void* eo, int n_sym, void* buf, void* lengths,
                      void* esc, int T, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  rans_encode_lanes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)values, (const int*)rows, (const unsigned*)fc,
      (const int2*)eo, n_sym, (unsigned short*)buf, (int*)lengths,
      (unsigned char*)esc, T, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
