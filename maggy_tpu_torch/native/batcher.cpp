// Host-side data-loading primitives for the training input pipeline.
//
// The port's own copy of the JAX package's batcher, the same code: a seeded
// permutation generator and a multithreaded row-gather that
// assembles minibatches outside the GIL, so a Python prefetch thread
// overlaps host batching with the card's step time.
//
// C ABI (consumed via ctypes from maggy_tpu_torch/train/native_loader.py):
//   mtl_perm(n, seed, out)                - seeded Fisher-Yates permutation
//   mtl_gather(src, row_bytes, idx, m, dst, threads)
//                                         - dst[i] = src[idx[i]] row copy
//   mtl_version()                         - ABI version for sanity checks

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int64_t mtl_version() { return 1; }

// xoshiro256** — fast, seedable, good enough for shuffling
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    for (int i = 0; i < 4; ++i) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * (__uint128_t)n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

void mtl_perm(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Rng rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

void mtl_gather(const uint8_t* src, int64_t row_bytes, const int64_t* idx,
                int64_t m, uint8_t* dst, int32_t threads) {
  if (threads < 1) threads = 1;
  if (threads == 1 || m < threads * 4) {
    for (int64_t i = 0; i < m; ++i)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  (size_t)row_bytes);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)threads);
  int64_t chunk = (m + threads - 1) / threads;
  for (int32_t t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < m ? lo + chunk : m;
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                    (size_t)row_bytes);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
