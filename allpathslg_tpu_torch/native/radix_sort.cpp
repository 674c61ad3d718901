// Parallel LSD radix sort for uint64 keys with an int64 payload.
//
// Native host runtime component: the reference's OpenMP ParallelSort /
// SortSync (ref: src/ParallelVecUtilities.h) backs every host-side
// aggregation; here the device owns the hot sorts (lax.sort) and this
// library owns the *host* aggregation paths (pathsdb CSR builds, link
// accumulation, stage-boundary lexsorts) where numpy's single-threaded
// sorts dominate wall-clock at genome scale.
//
// Design: 8 passes of 8-bit LSD radix; per-pass parallel histogram over
// T thread-chunks, exclusive scan of the 256*T counters serially (tiny),
// then parallel stable scatter per chunk. Ping-pong buffers.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Plan {
  int n_threads;
  int64_t n;
  int64_t chunk;
};

Plan make_plan(int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? static_cast<int>(hw) : 4;
  if (t > 32) t = 32;
  if (n < (1 << 16)) t = 1;
  Plan p{t, n, (n + t - 1) / t};
  return p;
}

void pass(const uint64_t* key_in, const int64_t* pay_in, uint64_t* key_out,
          int64_t* pay_out, int64_t n, int shift, const Plan& plan) {
  const int T = plan.n_threads;
  std::vector<int64_t> hist(static_cast<size_t>(T) * 256, 0);

  auto count = [&](int t) {
    int64_t lo = t * plan.chunk, hi = std::min(n, lo + plan.chunk);
    int64_t* h = hist.data() + static_cast<size_t>(t) * 256;
    for (int64_t i = lo; i < hi; ++i)
      ++h[(key_in[i] >> shift) & 0xFF];
  };
  {
    std::vector<std::thread> ths;
    for (int t = 1; t < T; ++t) ths.emplace_back(count, t);
    count(0);
    for (auto& th : ths) th.join();
  }

  // exclusive scan over (digit, thread) in digit-major order => stable
  int64_t sum = 0;
  for (int d = 0; d < 256; ++d)
    for (int t = 0; t < T; ++t) {
      int64_t& c = hist[static_cast<size_t>(t) * 256 + d];
      int64_t v = c;
      c = sum;
      sum += v;
    }

  auto scatter = [&](int t) {
    int64_t lo = t * plan.chunk, hi = std::min(n, lo + plan.chunk);
    int64_t* h = hist.data() + static_cast<size_t>(t) * 256;
    for (int64_t i = lo; i < hi; ++i) {
      int d = (key_in[i] >> shift) & 0xFF;
      int64_t at = h[d]++;
      key_out[at] = key_in[i];
      pay_out[at] = pay_in[i];
    }
  };
  {
    std::vector<std::thread> ths;
    for (int t = 1; t < T; ++t) ths.emplace_back(scatter, t);
    scatter(0);
    for (auto& th : ths) th.join();
  }
}

}  // namespace

extern "C" {

// Sorts (keys, payload) in place (stable). Returns 0 on success.
int radix_sort_u64(uint64_t* keys, int64_t* payload, int64_t n) {
  if (n <= 1) return 0;
  Plan plan = make_plan(n);
  std::vector<uint64_t> kbuf(static_cast<size_t>(n));
  std::vector<int64_t> pbuf(static_cast<size_t>(n));
  uint64_t* ka = keys;
  uint64_t* kb = kbuf.data();
  int64_t* pa = payload;
  int64_t* pb = pbuf.data();
  // skip high-byte passes that are all zero (common: small id spaces)
  uint64_t ormask = 0;
  for (int64_t i = 0; i < n; ++i) ormask |= keys[i];
  for (int shift = 0; shift < 64; shift += 8) {
    if (((ormask >> shift) & 0xFF) == 0) continue;  // identity pass
    pass(ka, pa, kb, pb, n, shift, plan);
    std::swap(ka, kb);
    std::swap(pa, pb);
  }
  if (ka != keys) {
    std::memcpy(keys, ka, sizeof(uint64_t) * static_cast<size_t>(n));
    std::memcpy(payload, pa, sizeof(int64_t) * static_cast<size_t>(n));
  }
  return 0;
}

}  // extern "C"
