// Native host-side data runtime for air_tpu_torch: a copy of
// air_tpu/runtime/loader.cc, so both packages draw the same permutation for
// the same (seed, epoch).
//
// TPU-native counterpart of the reference's TensorFlow C++ input machinery
// (TFRecordReader + shuffle_batch queue runners, reference
// multi_mnist.py:228-251, training.py:76-81): deterministic epoch
// permutations and multi-threaded batch gathers that run off the Python GIL
// (ctypes releases it during the call).
//
// Build: g++ -O3 -shared -fPIC loader.cc -o libairloader.so -lpthread
// (driven by air_tpu_torch/runtime/native.py, into air_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// SplitMix64 — tiny, seedable, high-quality stream for Fisher-Yates.
static inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Deterministic permutation of [0, n) for (seed, epoch).
void shuffle_perm(uint64_t seed, uint64_t epoch, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = static_cast<int32_t>(i);
  uint64_t state = seed * 0x9E3779B97f4A7C15ULL + epoch + 1;
  // warm up the stream
  splitmix64(&state);
  splitmix64(&state);
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(&state) % static_cast<uint64_t>(i + 1);
    int32_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Parallel row gather: dst[k, :] = src[idx[k], :], float32.
void gather_f32(const float* src, int64_t row_len, const int32_t* idx,
                int64_t n_idx, float* dst, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [=](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      std::memcpy(dst + k * row_len, src + (int64_t)idx[k] * row_len,
                  sizeof(float) * row_len);
    }
  };
  if (n_threads == 1 || n_idx < 4 * n_threads) {
    work(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_idx ? lo + chunk : n_idx;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Scalar gather: dst[k] = src[idx[k]], int32.
void gather_i32(const int32_t* src, const int32_t* idx, int64_t n_idx,
                int32_t* dst) {
  for (int64_t k = 0; k < n_idx; ++k) dst[k] = src[idx[k]];
}

}  // extern "C"
