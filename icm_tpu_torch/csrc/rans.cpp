// Native rANS entropy coder for icm_tpu_torch: a copy of the JAX package's
// icm_tpu/coding/cpp/rans.cpp, kept byte-for-byte in its code so both
// packages write the same host-wire streams (tests/test_torch_entropy_coding.py
// holds the two against each other).
//
// 64-bit-state rANS with 32-bit renormalization words, 16-bit coder
// precision and a 4-bit bypass escape — the coding scheme of the
// reference's prebuilt `compressai.ans` pybind11 module (interval
// L = 1<<31). Takes zero-copy int32/float32 arrays through a plain C ABI
// (driven from Python with ctypes) and offers threaded batch entry points:
// one stream per image.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr int kBypassPrecision = 4;
constexpr int32_t kMaxBypass = (1 << kBypassPrecision) - 1;
constexpr uint64_t kRansL = 1ull << 31;
constexpr int kBucketBits = 8;  // decode bucket-LUT width (64 rows -> 32KB)

struct Op {
  // kind 0: symbol (a = start, b = freq); kind 1: bypass bits (a = value)
  uint32_t a;
  uint32_t b;
  uint8_t kind;
};

void build_ops(const int32_t* symbols, const int32_t* indexes, int64_t n,
               const int32_t* cdfs, int64_t cdf_stride,
               const int32_t* cdf_lengths, const int32_t* offsets,
               std::vector<Op>& ops) {
  ops.reserve(ops.size() + static_cast<size_t>(n) + (n >> 3));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    const int32_t* cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    int32_t value = symbols[i] - offsets[idx];
    uint32_t raw_val = 0;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
    }
    const uint32_t start = static_cast<uint32_t>(cdf[value]);
    const uint32_t freq = static_cast<uint32_t>(cdf[value + 1]) - start;
    ops.push_back(Op{start, freq, 0});
    if (value == max_value) {
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;
      int32_t val = n_bypass;
      while (val >= kMaxBypass) {
        ops.push_back(Op{static_cast<uint32_t>(kMaxBypass), 0, 1});
        val -= kMaxBypass;
      }
      ops.push_back(Op{static_cast<uint32_t>(val), 0, 1});
      for (int32_t j = 0; j < n_bypass; ++j) {
        ops.push_back(Op{
            (raw_val >> (j * kBypassPrecision)) & kMaxBypass, 0, 1});
      }
    }
  }
}

void encode_ops(const std::vector<Op>& ops, std::vector<uint8_t>& out) {
  uint64_t state = kRansL;
  std::vector<uint32_t> words;
  words.reserve(ops.size() / 2 + 4);
  for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
    if (it->kind == 0) {
      const uint64_t freq = it->b;
      const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
      while (state >= x_max) {
        words.push_back(static_cast<uint32_t>(state));
        state >>= 32;
      }
      state = ((state / freq) << kPrecision) + (state % freq) + it->a;
    } else {
      const uint64_t x_max = (kRansL >> kBypassPrecision) << 32;
      while (state >= x_max) {
        words.push_back(static_cast<uint32_t>(state));
        state >>= 32;
      }
      state = (state << kBypassPrecision) | it->a;
    }
  }
  const size_t nw = words.size() + 2;
  out.resize(nw * 4);
  uint32_t* w = reinterpret_cast<uint32_t*>(out.data());
  w[0] = static_cast<uint32_t>(state >> 32);
  w[1] = static_cast<uint32_t>(state);
  for (size_t i = 0; i < words.size(); ++i) {
    w[2 + i] = words[words.size() - 1 - i];
  }
}

// Direct reverse-order encode: LIFO without materializing the op buffer.
// Iterates symbols backward; within a symbol the forward op order is
// [sym, count-chunks..., value-chunks...], so reversed processing emits
// value chunks (reversed), count chunks (reversed), then the symbol.
// Produces the identical byte stream to build_ops + encode_ops.
void encode_reverse(const int32_t* symbols, const int32_t* indexes, int64_t n,
                    const int32_t* cdfs, int64_t cdf_stride,
                    const int32_t* cdf_lengths, const int32_t* offsets,
                    std::vector<uint8_t>& out) {
  uint64_t state = kRansL;
  std::vector<uint32_t> words;
  words.reserve(static_cast<size_t>(n) / 2 + 4);

  auto put_bits = [&](uint32_t bits) {
    constexpr uint64_t x_max = (kRansL >> kBypassPrecision) << 32;
    while (state >= x_max) {
      words.push_back(static_cast<uint32_t>(state));
      state >>= 32;
    }
    state = (state << kBypassPrecision) | bits;
  };

  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t idx = indexes[i];
    const int32_t* cdf = cdfs + idx * cdf_stride;
    const int32_t max_value = cdf_lengths[idx] - 2;
    int32_t value = symbols[i] - offsets[idx];
    uint32_t raw_val = 0;
    bool bypass = false;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
      bypass = true;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
      bypass = true;
    }
    if (bypass || value == max_value) {
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassPrecision)) != 0) ++n_bypass;
      for (int32_t j = n_bypass - 1; j >= 0; --j) {
        put_bits((raw_val >> (j * kBypassPrecision)) & kMaxBypass);
      }
      // count chunks, reversed: forward order is floor(n/15) full chunks
      // then the remainder — reversed emits remainder first
      int32_t val = n_bypass;
      put_bits(static_cast<uint32_t>(val % kMaxBypass));
      for (int32_t j = 0; j < val / kMaxBypass; ++j) {
        put_bits(static_cast<uint32_t>(kMaxBypass));
      }
    }
    const uint32_t start = static_cast<uint32_t>(cdf[value]);
    const uint64_t freq = static_cast<uint32_t>(cdf[value + 1]) - start;
    const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
    while (state >= x_max) {
      words.push_back(static_cast<uint32_t>(state));
      state >>= 32;
    }
    state = ((state / freq) << kPrecision) + (state % freq) + start;
  }

  const size_t nw = words.size() + 2;
  out.resize(nw * 4);
  uint32_t* w = reinterpret_cast<uint32_t*>(out.data());
  w[0] = static_cast<uint32_t>(state >> 32);
  w[1] = static_cast<uint32_t>(state);
  for (size_t i = 0; i < words.size(); ++i) {
    w[2 + i] = words[words.size() - 1 - i];
  }
}

struct Decoder {
  std::vector<uint32_t> words;
  uint64_t state = 0;
  size_t pos = 0;

  void init(const uint8_t* stream, int64_t nbytes) {
    const size_t nw = static_cast<size_t>(nbytes) / 4;
    words.resize(nw);
    std::memcpy(words.data(), stream, nw * 4);
    state = (static_cast<uint64_t>(words[0]) << 32) | words[1];
    pos = 2;
  }

  inline void renorm() {
    while (state < kRansL && pos < words.size()) {
      state = (state << 32) | words[pos++];
    }
  }

  inline uint32_t get_bits(int nbits) {
    const uint32_t val = static_cast<uint32_t>(state & ((1u << nbits) - 1));
    state >>= nbits;
    renorm();
    return val;
  }

  void decode(const int32_t* indexes, int64_t n, const int32_t* cdfs,
              int64_t cdf_stride, const int32_t* cdf_lengths,
              const int32_t* offsets, int32_t* out,
              const uint16_t* lut = nullptr) {
    constexpr uint64_t mask = (1ull << kPrecision) - 1;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t idx = indexes[i];
      const int32_t* cdf = cdfs + idx * cdf_stride;
      const int32_t L = cdf_lengths[idx];
      const int32_t max_value = L - 2;
      const uint32_t cum = static_cast<uint32_t>(state & mask);
      int32_t lo;
      if (lut != nullptr) {
        // bucket table (see EntropyTables.symbol_lut): start symbol for
        // this 256-wide cum bucket, then a short scan in the cached row
        lo = lut[(static_cast<int64_t>(idx) << kBucketBits) |
                 (cum >> (kPrecision - kBucketBits))];
        while (static_cast<uint32_t>(cdf[lo + 1]) <= cum) ++lo;
      } else {
        // largest s with cdf[s] <= cum (cdf strictly increasing)
        int32_t hi = L - 1;
        lo = 0;
        while (lo + 1 < hi) {
          const int32_t mid = (lo + hi) >> 1;
          if (static_cast<uint32_t>(cdf[mid]) <= cum) lo = mid; else hi = mid;
        }
      }
      const uint32_t start = static_cast<uint32_t>(cdf[lo]);
      const uint64_t freq = static_cast<uint32_t>(cdf[lo + 1]) - start;
      state = freq * (state >> kPrecision) + cum - start;
      renorm();
      int32_t value = lo;
      if (value == max_value) {
        uint32_t val = get_bits(kBypassPrecision);
        uint32_t n_bypass = val;
        while (val == static_cast<uint32_t>(kMaxBypass)) {
          val = get_bits(kBypassPrecision);
          n_bypass += val;
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass; ++j) {
          raw_val |= get_bits(kBypassPrecision) << (j * kBypassPrecision);
        }
        value = static_cast<int32_t>(raw_val >> 1);
        if (raw_val & 1) {
          value = -value - 1;
        } else {
          value += max_value;
        }
      }
      out[i] = value + offsets[idx];
    }
  }
};

struct Encoder {
  std::vector<Op> ops;
};

}  // namespace

extern "C" {

// ---- one-shot encode / decode --------------------------------------------

// Returns malloc'd stream in *out (caller frees via rans_free_buffer);
// return value is the byte length.
int64_t rans_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                                 int64_t n, const int32_t* cdfs,
                                 int64_t cdf_stride, const int32_t* cdf_lengths,
                                 const int32_t* offsets, uint8_t** out) {
  std::vector<uint8_t> buf;
  encode_reverse(symbols, indexes, n, cdfs, cdf_stride, cdf_lengths, offsets,
                 buf);
  *out = static_cast<uint8_t*>(std::malloc(buf.size()));
  std::memcpy(*out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

void rans_free_buffer(uint8_t* p) { std::free(p); }

int64_t rans_decode_with_indexes(const uint8_t* stream, int64_t nbytes,
                                 const int32_t* indexes, int64_t n,
                                 const int32_t* cdfs, int64_t cdf_stride,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, int32_t* out) {
  Decoder dec;
  dec.init(stream, nbytes);
  dec.decode(indexes, n, cdfs, cdf_stride, cdf_lengths, offsets, out);
  return n;
}

// ---- buffered encoder ----------------------------------------------------

void* rans_enc_new() { return new Encoder(); }

void rans_enc_put(void* enc, const int32_t* symbols, const int32_t* indexes,
                  int64_t n, const int32_t* cdfs, int64_t cdf_stride,
                  const int32_t* cdf_lengths, const int32_t* offsets) {
  build_ops(symbols, indexes, n, cdfs, cdf_stride, cdf_lengths, offsets,
            static_cast<Encoder*>(enc)->ops);
}

int64_t rans_enc_flush(void* enc, uint8_t** out) {
  Encoder* e = static_cast<Encoder*>(enc);
  std::vector<uint8_t> buf;
  encode_ops(e->ops, buf);
  e->ops.clear();
  *out = static_cast<uint8_t*>(std::malloc(buf.size()));
  std::memcpy(*out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

void rans_enc_free(void* enc) { delete static_cast<Encoder*>(enc); }

// ---- stateful decoder ----------------------------------------------------

void* rans_dec_new(const uint8_t* stream, int64_t nbytes) {
  Decoder* d = new Decoder();
  d->init(stream, nbytes);
  return d;
}

void rans_dec_decode(void* dec, const int32_t* indexes, int64_t n,
                     const int32_t* cdfs, int64_t cdf_stride,
                     const int32_t* cdf_lengths, const int32_t* offsets,
                     int32_t* out) {
  static_cast<Decoder*>(dec)->decode(indexes, n, cdfs, cdf_stride, cdf_lengths,
                                     offsets, out);
}

void rans_dec_free(void* dec) { delete static_cast<Decoder*>(dec); }

// ---- batched stateful decoder ---------------------------------------------
// B parallel decoder states (one stream per batch item); each decode call
// consumes (B, N) indexes and fills (B, N) symbols — the autoregressive
// slice loop costs ONE native call per slice for the whole batch.

struct BatchDecoder {
  std::vector<Decoder> decs;
};

void* rans_dec_batch_new(const uint8_t* streams, const int64_t* offsets,
                         const int64_t* sizes, int64_t batch) {
  BatchDecoder* bd = new BatchDecoder();
  bd->decs.resize(batch);
  for (int64_t b = 0; b < batch; ++b) {
    bd->decs[b].init(streams + offsets[b], sizes[b]);
  }
  return bd;
}

void rans_dec_batch_decode(void* h, const int32_t* indexes, int64_t batch,
                           int64_t per_item, const int32_t* cdfs,
                           int64_t cdf_stride, const int32_t* cdf_lengths,
                           const int32_t* offsets, int32_t* out,
                           int num_threads) {
  BatchDecoder* bd = static_cast<BatchDecoder*>(h);
  const int nt = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    for (int64_t b = tid; b < batch; b += nt) {
      bd->decs[b].decode(indexes + b * per_item, per_item, cdfs, cdf_stride,
                         cdf_lengths, offsets, out + b * per_item);
    }
  };
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& t : threads) t.join();
}

void rans_dec_batch_decode_lut(void* h, const int32_t* indexes, int64_t batch,
                               int64_t per_item, const int32_t* cdfs,
                               int64_t cdf_stride, const int32_t* cdf_lengths,
                               const int32_t* offsets, const uint16_t* lut,
                               int32_t* out, int num_threads) {
  BatchDecoder* bd = static_cast<BatchDecoder*>(h);
  const int nt = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    for (int64_t b = tid; b < batch; b += nt) {
      bd->decs[b].decode(indexes + b * per_item, per_item, cdfs, cdf_stride,
                         cdf_lengths, offsets, out + b * per_item, lut);
    }
  };
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& t : threads) t.join();
}

void rans_dec_batch_free(void* h) { delete static_cast<BatchDecoder*>(h); }

// ---- threaded batch entry points -----------------------------------------
// One independent stream per batch item; streams are concatenated into a
// caller-provided arena with per-item offsets.

int64_t rans_encode_batch(const int32_t* symbols, const int32_t* indexes,
                          int64_t batch, int64_t per_item, const int32_t* cdfs,
                          int64_t cdf_stride, const int32_t* cdf_lengths,
                          const int32_t* offsets, uint8_t** out,
                          int64_t* item_sizes, int num_threads) {
  std::vector<std::vector<uint8_t>> bufs(batch);
  const int nt = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    for (int64_t b = tid; b < batch; b += nt) {
      encode_reverse(symbols + b * per_item, indexes + b * per_item, per_item,
                     cdfs, cdf_stride, cdf_lengths, offsets, bufs[b]);
    }
  };
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& t : threads) t.join();

  int64_t total = 0;
  for (int64_t b = 0; b < batch; ++b) {
    item_sizes[b] = static_cast<int64_t>(bufs[b].size());
    total += item_sizes[b];
  }
  *out = static_cast<uint8_t*>(std::malloc(total));
  int64_t off = 0;
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(*out + off, bufs[b].data(), bufs[b].size());
    off += item_sizes[b];
  }
  return total;
}

void rans_decode_batch(const uint8_t* streams, const int64_t* item_offsets,
                       const int64_t* item_sizes, const int32_t* indexes,
                       int64_t batch, int64_t per_item, const int32_t* cdfs,
                       int64_t cdf_stride, const int32_t* cdf_lengths,
                       const int32_t* offsets, int32_t* out, int num_threads) {
  const int nt = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    for (int64_t b = tid; b < batch; b += nt) {
      Decoder dec;
      dec.init(streams + item_offsets[b], item_sizes[b]);
      dec.decode(indexes + b * per_item, per_item, cdfs, cdf_stride,
                 cdf_lengths, offsets, out + b * per_item);
    }
  };
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& t : threads) t.join();
}

// ---- pmf -> quantized cdf -------------------------------------------------
// Integer semantics identical to icm_tpu.entropy.base.pmf_to_quantized_cdf_np
// (and to the reference _CXX.pmf_to_quantized_cdf semantics).

int pmf_to_quantized_cdf(const float* pmf, int64_t n, int precision,
                         int32_t* cdf_out /* length n+1 */) {
  std::vector<uint32_t> cdf(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const float p = pmf[i];
    if (!(p >= 0.f) || !std::isfinite(p)) return -1;
    cdf[i + 1] = static_cast<uint32_t>(
        std::lround(static_cast<double>(p) * (1 << precision)));
  }
  uint64_t total = std::accumulate(cdf.begin(), cdf.end(), uint64_t{0});
  if (total == 0) return -2;
  for (auto& c : cdf) {
    c = static_cast<uint32_t>(
        (static_cast<uint64_t>(1 << precision) * c) / total);
  }
  std::partial_sum(cdf.begin(), cdf.end(), cdf.begin());
  cdf[n] = 1u << precision;

  for (int64_t i = 0; i < n; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      uint32_t best_freq = ~0u;
      int64_t best_steal = -1;
      for (int64_t j = 0; j < n; ++j) {
        const uint32_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < 0) return -3;
      if (best_steal < i) {
        for (int64_t j = best_steal + 1; j <= i; ++j) --cdf[j];
      } else {
        for (int64_t j = i + 1; j <= best_steal; ++j) ++cdf[j];
      }
    }
  }
  for (int64_t i = 0; i <= n; ++i) cdf_out[i] = static_cast<int32_t>(cdf[i]);
  return 0;
}

// Batched rows: pmf (rows, max_len) + per-row tail mass appended as the
// final symbol; writes cdf rows of width (max_len + 2).
int pmf_to_quantized_cdf_rows(const float* pmf, int64_t rows, int64_t max_len,
                              const float* tail_mass,
                              const int32_t* pmf_lengths, int precision,
                              int32_t* cdf_out, int num_threads) {
  const int nt = std::max(1, std::min<int>(num_threads, rows));
  std::vector<int> rc(nt, 0);
  std::vector<std::thread> threads;
  auto work = [&](int tid) {
    std::vector<float> prob;
    for (int64_t r = tid; r < rows; r += nt) {
      const int64_t L = pmf_lengths[r];
      prob.assign(pmf + r * max_len, pmf + r * max_len + L);
      prob.push_back(tail_mass[r]);
      int ret = pmf_to_quantized_cdf(prob.data(), L + 1, precision,
                                     cdf_out + r * (max_len + 2));
      if (ret != 0) rc[tid] = ret;
    }
  };
  for (int t = 1; t < nt; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto& t : threads) t.join();
  for (int r : rc) if (r != 0) return r;
  return 0;
}

}  // extern "C"
