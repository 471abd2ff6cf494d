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
// coalesced. Words are 16-bit (read as unsigned short).
//
// What bounds them on an H100: not bytes and not operations but each
// lane's chain of T dependent steps; a step's latency sets the pace, and
// one warp an SM issues every instruction of a step in order, so what a
// step waits for includes every load in its instruction stream: a lookup
// in a table the size of lut2 (33.6 MB, 100.7 MB), or a load, then a
// dependent gather, then a 32-bit division the card has no instruction for.
//
// What this design does about it:
// - Decode: the lookup reads compact tables (device_rans.compact_tables:
//   each row's CDF as 16-bit words and a coarse index, 135,648 bytes for
//   the 64 Gaussian rows against lut2's 33.6 MB, 24,576 for the 192
//   bottleneck rows against 100.7 MB): the index's bucket, then a binary
//   search in it for lut2's exact answer. When they fit, each block stages
//   them into shared memory with bulk copies (cp.async.bulk, one mbarrier)
//   while its lanes start; otherwise they are read through L1 (chosen from
//   their size before the launch). A chunk of 32 steps' rows and the
//   lane's next 40 words (from a 16-byte boundary of their address) come by
//   cp.async into shared memory, and the word a renormalisation would take
//   is read before the lookup, so no step waits on device memory. The lanes
//   are cut into at most one block an SM, one lane a thread (two or four
//   lanes a thread, their steps side by side, measured 2-4x slower).
// - Encode: division by f is a multiply-high by its reciprocal
//   (device_rans.reciprocals: exact for every 32-bit state), from a table
//   of (f << 16 | c, reciprocal) pairs. The raw values and rows of a
//   32-step stage are loaded into registers two stages ahead of the chain,
//   the pairs gathered by cp.async one stage ahead into a ring in shared
//   memory, so a step is the state's own arithmetic. The emissions go to a
//   row in shared memory, and the block writes its lanes' rows out once, in
//   decode order with the zero tail, neighbouring threads on neighbouring
//   4-byte words. Where a block's rows do not fit (T past ~6,900 steps),
//   the kernel writes the emissions to the output rows and moves them into
//   place at the end (chosen from T before the launch).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6; phase 6
// of chip_smoke.py through tools/torch_ab_rans.py): y of 2 images of 512^2
// (2048 lanes x 320 steps) decodes in 0.147 ms over its 10 launches and
// encodes in 0.055 ms; at 32 images (32768 lanes) 0.192 and 0.143 ms. One
// lane alone decodes in 0.078 ms. With every symbol its row's most likely,
// so that almost no lane searches, the 2048 lanes decode in 0.112 ms
// (tools/torch_sweep_rans.py): the search's halvings and a warp's wait for
// its slowest lane are a quarter of the time; the rest of the gap to one
// lane is not the search.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kL = 1u << 16;  // renormalization interval lower bound
constexpr int kEscVal = 0x7FFF;    // decoded value of an escaped symbol
constexpr int kBulkBytes = 32768;  // bytes per bulk copy (a multiple of 16)
constexpr int kChunk = 32;         // decode: steps whose rows one copy group brings
constexpr int kWindow = 40;        // decode: words of a lane's window (kChunk + 7 of alignment, rounded to 8)
constexpr int kStage = 32;         // encode: steps in each stage of the ring
constexpr int kBarBytes = 16;      // decode: the tables' mbarrier, padded to 16 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ long long clamp_to(long long i, long long last) {
  return i < last ? i : last;
}

// asynchronous copies into shared memory, completed by cp_async_wait_all:
// they hold no register, so no load of the step's chain waits behind them
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes of which the first src_bytes are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 8 bytes from an 8-byte boundary
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// table reads: from shared memory, or from device memory through L1
template <bool kSmem>
__device__ __forceinline__ unsigned ld16(const unsigned short* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kSmem>
__device__ __forceinline__ int4 ld_row(const int4* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// ctab (compact_tables): int4 per row (CDF start, index start, esc | k << 16,
// offset), then the rows' indexes and CDFs as 16-bit words; starts count
// 16-bit words from the table's start. Dynamic shared memory: with kSmem the
// table's mbarrier (16 bytes) and the table, then each chunk's rows
// [kChunk][threads], then each thread's window of kWindow words. `mis`: the
// words' address past a 16-byte boundary, in words (windows start on such
// boundaries).
template <bool kSmem>
__global__ void __launch_bounds__(1024) rans_decode_lanes_kernel(
    const unsigned short* __restrict__ words, long long n_words,
    const int* __restrict__ off, const int* __restrict__ rows,
    const unsigned char* __restrict__ ctab, int ctab_bytes,
    const unsigned* __restrict__ state_in, const int* __restrict__ ptr_in,
    int* __restrict__ values, unsigned* __restrict__ state_out,
    int* __restrict__ ptr_out, int T, int lanes, int mis) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  int* rows_s = reinterpret_cast<int*>(smem + (kSmem ? kBarBytes + ctab_bytes : 0));
  unsigned short* win =
      reinterpret_cast<unsigned short*>(rows_s + kChunk * nt) + tid * kWindow;
  const unsigned char* tab = ctab;
  if constexpr (kSmem) {
    if (tid == 0) {
      const unsigned b = smem_addr(bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(ctab_bytes) : "memory");
      for (int o = 0; o < ctab_bytes; o += kBulkBytes) {
        const int n = ctab_bytes - o < kBulkBytes ? ctab_bytes - o : kBulkBytes;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(smem + kBarBytes + o)), "l"(ctab + o), "r"(n), "r"(b)
            : "memory");
      }
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    tab = smem + kBarBytes;
  }

  const int l = blockIdx.x * nt + tid;
  if (l >= lanes) return;
  const long long last = n_words - 1;
  const long long base = off[l];
  const unsigned wlast = words[last];  // what a read past the end gives
  unsigned state;
  int ptr;
  if (state_in != nullptr) {
    state = state_in[l];
    ptr = ptr_in[l];
  } else {  // the flushed final encoder state: hi, lo
    state = ((unsigned)words[clamp_to(base, last)] << 16) |
            (unsigned)words[clamp_to(base + 1, last)];
    ptr = 2;
  }
  const int4* meta = reinterpret_cast<const int4*>(tab);
  const unsigned short* t16 = reinterpret_cast<const unsigned short*>(tab);
  const auto wait_tables = [&] {  // the tables' bulk copy
    if constexpr (kSmem) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "WAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
          "@!p bra WAIT;\n"
          "}\n" ::"r"(smem_addr(bar))
          : "memory");
    }
  };
  if (T == 0) wait_tables();  // no block ends with its copy in flight
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    // the chunk's rows, and the words it can read (at most one a step),
    // from a 16-byte boundary of their address; words outside the stream
    // are not read
    const int n = T - c0 < kChunk ? T - c0 : kChunk;
    for (int j = 0; j < n; ++j) {
      cp_async4(rows_s + j * nt + tid, rows + (size_t)(c0 + j) * lanes + l);
    }
    const long long a = ((base + ptr + mis) & ~7LL) - mis;
#pragma unroll
    for (int i = 0; i < kWindow / 8; ++i) {
      const long long s = a + 8 * i, left = n_words - s;
      if (s >= 0 && left > 0) {
        cp_async16(win + 8 * i, words + s, left >= 8 ? 16 : 2 * (int)left);
      } else if (s < 0) {  // the 16 bytes straddle the stream's start
        for (int j = -(int)s; j < 8 && s + j < n_words; ++j) win[8 * i + j] = words[s + j];
      }
    }
    cp_async_commit();
    if (c0 == 0) wait_tables();
    cp_async_wait_all();

    int4 m1 = ld_row<kSmem>(meta + rows_s[tid]);  // the next step's row record
    for (int j = 0; j < n; ++j) {
      const int4 m = m1;
      if (j + 1 < n) m1 = ld_row<kSmem>(meta + rows_s[(j + 1) * nt + tid]);
      // the word a renormalisation would read, fetched before the lookup
      // (a truncated stream reads no further than its last word)
      const long long p = base + ptr;
      const unsigned w = p <= last ? (unsigned)win[p - a] : wlast;
      const unsigned peek = state & 0xFFFFu;
      // the index's bucket bounds lut2's symbol: the rightmost s in
      // [lo, hi] with cdf[s] <= peek
      const int esc = m.z & 0xFFFF;
      const unsigned short* bucket = t16 + m.y + (peek >> (16 - (m.z >> 16)));
      int lo = (int)ld16<kSmem>(bucket), hi = (int)ld16<kSmem>(bucket + 1);
      const unsigned short* cdf = t16 + m.x;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (ld16<kSmem>(cdf + mid) <= peek) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const unsigned c0w = ld16<kSmem>(cdf + lo), c1w = ld16<kSmem>(cdf + lo + 1);
      values[(size_t)(c0 + j) * lanes + l] = lo == esc ? kEscVal : lo + m.w;
      // freq mod 2^16: the row's last entry, 65536, is stored as 0
      state = ((c1w - c0w) & 0xFFFFu) * (state >> 16) + (peek - c0w);
      const bool renorm = state < kL;
      state = renorm ? (state << 16) | w : state;
      ptr += renorm;
    }
  }
  state_out[l] = state;
  ptr_out[l] = ptr;
}

// Dynamic shared memory: eo (n_rows pairs, padded to 16 bytes); the codes'
// ring [2 stages][kStage][threads] of (f << 16 | c, reciprocal) pairs; with
// kSmemOut each thread's emission row of `stride` 16-bit words, then the
// lanes' counts and states.
template <bool kSmemOut>
__global__ void __launch_bounds__(256) rans_encode_lanes_kernel(
    const int* __restrict__ values, const int* __restrict__ rows,
    const uint2* __restrict__ fcr, const int2* __restrict__ eo, int n_rows, int n_sym,
    unsigned short* __restrict__ buf, int* __restrict__ lengths,
    unsigned char* __restrict__ esc, int T, int lanes, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  int2* eo_s = reinterpret_cast<int2*>(smem);
  uint2* code_s = reinterpret_cast<uint2*>(smem + ((n_rows * 8 + 15) & ~15));
  unsigned short* rows_s = reinterpret_cast<unsigned short*>(code_s + 2 * kStage * nt);
  for (int i = tid; i < n_rows; i += nt) eo_s[i] = eo[i];
  __syncthreads();

  const int l = blockIdx.x * nt + tid;
  const bool live = l < lanes;
  const int maxw = T + 2;
  unsigned short* out = kSmemOut ? rows_s + tid * stride : buf + (size_t)l * maxw;
  unsigned state = kL;
  int k = 0;  // emissions so far; emission k goes to slot maxw - 1 - k

  // step s of the coding order (t = T - 1 - s): its code sits in stage
  // (s / kStage) & 1 of the ring; the raw inputs of one stage are held in
  // registers from the iteration before the one that gathers its codes
  int v[kStage], r[kStage];
  auto code = [&](int s0, int j) { return code_s + (((s0 / kStage) & 1) * kStage + j) * nt + tid; };
  auto load_raw = [&](int s0, int n) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < n) {
        const size_t i = (size_t)(T - 1 - s0 - j) * lanes + l;
        v[j] = values[i];
        r[j] = rows[i];
      }
    }
  };
  // the escape marks of those steps, and their codes gathered from fcr
  auto fetch_code = [&](int s0, int n) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < n) {
        const int2 so = eo_s[r[j]];  // (escape symbol, offset)
        const long long u = (long long)v[j] - so.y;
        const bool is_esc = u < 0 || u >= so.x;
        esc[(size_t)(T - 1 - s0 - j) * lanes + l] = is_esc;
        cp_async8(code(s0, j), fcr + (size_t)r[j] * n_sym + (is_esc ? so.x : (int)u));
      }
    }
    cp_async_commit();
  };
  // the chain over the n steps of a stage: the codes are read first, so
  // only the state's own arithmetic is left between steps
  auto code_stage = [&](int s0, int n) {
    uint2 xq[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < n) xq[j] = *code(s0, j);
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (j < n) {
        const unsigned f = xq[j].x >> 16;
        if (state >= (f << 16)) {
          out[maxw - 1 - k] = (unsigned short)(state & 0xFFFFu);
          ++k;
          state >>= 16;
        }
        // state / f for state < f << 16: multiply-high, the reciprocal's
        // 33rd bit as + state, then shift by ceil(log2 f)
        const unsigned shift = 32 - __clz((int)(f - 1));
        const unsigned d =
            (unsigned)(((unsigned long long)__umulhi(state, xq[j].y) + state) >> shift);
        state = (d << 16) + (state - d * f) + (xq[j].x & 0xFFFFu);
      }
    }
  };
  // a stage's steps: kStage for every stage but the last (the constant
  // count leaves the unrolled loops without a test a step)
  const auto count = [&](int s0) { return T - s0 < kStage ? T - s0 : kStage; };

  if (live) {
    // while the chain codes stage s0, the codes of stage s0 + kStage are
    // on their way, and the raw inputs of stage s0 + 2 kStage
    load_raw(0, count(0));
    fetch_code(0, count(0));
    load_raw(kStage, count(kStage));
    for (int s0 = 0; s0 < T; s0 += kStage) {
      cp_async_wait_all();  // the codes of stage s0
      if (s0 + 3 * kStage <= T) {
        fetch_code(s0 + kStage, kStage);
        load_raw(s0 + 2 * kStage, kStage);
        code_stage(s0, kStage);
      } else {
        fetch_code(s0 + kStage, count(s0 + kStage));
        load_raw(s0 + 2 * kStage, count(s0 + 2 * kStage));
        code_stage(s0, count(s0));
      }
    }
  }

  if constexpr (kSmemOut) {
    int* k_s = reinterpret_cast<int*>(rows_s + (size_t)nt * stride);
    unsigned* state_s = reinterpret_cast<unsigned*>(k_s + nt);
    if (live) {
      k_s[tid] = k;
      state_s[tid] = state;
      lengths[l] = k + 2;
    }
    __syncthreads();
    // the block's rows are one contiguous span of the output: write it row
    // by row, the block's threads along the row
    const int l0 = blockIdx.x * nt;
    const int nl = lanes - l0 < nt ? lanes - l0 : nt;
    for (int ll = 0; ll < nl; ++ll) {
      const int K = k_s[ll];
      const unsigned st = state_s[ll];
      // word j of the row, 2 <= j < K + 2, is src[j]
      const unsigned short* src = rows_s + (size_t)ll * stride + (maxw - K - 2);
      auto word = [&](int j) -> unsigned {
        return j == 0 ? st >> 16 : j == 1 ? st & 0xFFFFu : j < K + 2 ? src[j] : 0u;
      };
      unsigned short* dst = buf + (size_t)(l0 + ll) * maxw;
      if ((maxw & 1) == 0) {  // rows start on 4-byte boundaries
        unsigned* dst32 = reinterpret_cast<unsigned*>(dst);
        for (int p = tid; p < maxw / 2; p += nt) {
          dst32[p] = word(2 * p) | (word(2 * p + 1) << 16);
        }
      } else {
        for (int j = tid; j < maxw; j += nt) dst[j] = (unsigned short)word(j);
      }
    }
  } else if (live) {
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
}

constexpr int kDevices = 64;

// Raises the kernel's dynamic shared memory limit on the current device to
// `bytes` when that is more than 48 KB and more than it was raised to there
// before (`allowed`, one entry per device for each kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[kDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

// Shared memory of a decode block: the tables and their barrier when
// staged, and each thread's chunk of rows and window of words.
int rans_decode_smem_bytes(int ctab_bytes, int threads, int smem_tables) {
  return (smem_tables ? kBarBytes + ctab_bytes : 0) + threads * (4 * kChunk + 2 * kWindow);
}

// Shared memory of an encode block (see rans_encode_lanes_kernel); neither
// kernel has static shared memory.
int rans_encode_smem_bytes(int T, int n_rows, int threads, int smem_out) {
  const int stride = 2 * (((T + 3) / 2) | 1);
  return ((n_rows * 8 + 15) & ~15) + threads * (16 * kStage + (smem_out ? 2 * stride + 8 : 0));
}

// Shared memory a block may take on the current device (with the opt-in
// past 48 KB that the launches make), or -1 on error.
int rans_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Decode T symbols from each of `lanes` streams. state_in/ptr_in null:
// start each lane from its flushed state at words[off[l]]. ctab: the
// compact tables, ctab_bytes a multiple of 16; smem_tables: stage them in
// shared memory, else read them through L1.
int rans_decode_lanes(const void* words, long long n_words, const void* off,
                      const void* rows, const void* ctab, int ctab_bytes,
                      const void* state_in, const void* ptr_in, void* values,
                      void* state_out, void* ptr_out, int T, int lanes,
                      int threads, int smem_tables, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + threads - 1) / threads;
  const int bytes = rans_decode_smem_bytes(ctab_bytes, threads, smem_tables);
  static int allowed[2][kDevices] = {};
  const auto launch = [&](auto kernel) {
    const cudaError_t err = allow_smem(kernel, bytes, allowed[smem_tables != 0]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
        (const unsigned short*)words, n_words, (const int*)off, (const int*)rows,
        (const unsigned char*)ctab, ctab_bytes, (const unsigned*)state_in,
        (const int*)ptr_in, (int*)values, (unsigned*)state_out, (int*)ptr_out, T,
        lanes, (int)((reinterpret_cast<unsigned long long>(words) >> 1) & 7));
    return cudaGetLastError();
  };
  return (int)(smem_tables ? launch(rans_decode_lanes_kernel<true>)
                           : launch(rans_decode_lanes_kernel<false>));
}

// Encode (T, lanes) values into (lanes, T + 2) word rows in decode order,
// per-lane lengths and (T, lanes) escape marks. fcr: (f << 16 | c,
// reciprocal) pairs, (n_rows, n_sym); smem_out: keep each lane's row in
// shared memory until the end.
int rans_encode_lanes(const void* values, const void* rows, const void* fcr,
                      const void* eo, int n_rows, int n_sym, void* buf, void* lengths,
                      void* esc, int T, int lanes, int threads, int smem_out,
                      void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + threads - 1) / threads;
  const int stride = 2 * (((T + 3) / 2) | 1);  // 16-bit words, an odd count of banks
  const int bytes = rans_encode_smem_bytes(T, n_rows, threads, smem_out);
  static int allowed[2][kDevices] = {};
  const auto launch = [&](auto kernel) {
    const cudaError_t err = allow_smem(kernel, bytes, allowed[smem_out != 0]);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
        (const int*)values, (const int*)rows, (const uint2*)fcr, (const int2*)eo, n_rows,
        n_sym, (unsigned short*)buf, (int*)lengths, (unsigned char*)esc, T, lanes, stride);
    return cudaGetLastError();
  };
  return (int)(smem_out ? launch(rans_encode_lanes_kernel<true>)
                        : launch(rans_encode_lanes_kernel<false>));
}

}  // extern "C"
