// CHD-style perfect hash builder for the minimizer index lookup.
//
// The device lookup (ma_tpu_torch/index/minimizer.py) replaces the bucketed
// binary search (1 + steps + 1 HBM gathers per query lane) with exactly
// two gathers: a displacement read D[h & (m-1)] and one packed table row
// (hash, row_lo, row_hi). This builder assigns per-bucket displacements
// so every unique hash lands in a private table slot:
//
//   slot(h, d) = ((h ^ (d * C1)) * C2) >> (32 - tlog)      (all uint32)
//
// Standard compress-hash-displace (Belazzougui, Botelho, Dietzfelbinger,
// ESA 2009) specialized to power-of-two table sizes and the repo's
// already-well-mixed minimizer hashes (invertible hash64 over 2k bits).
//
// Reference-role note: the reference's minimizer lookup is minimap2's
// bucketed hashtable (libs/minimizerscpp/src/index.cpp); this is the
// TPU-shaped equivalent where gather count, not instruction count, is
// the budget.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {
constexpr uint32_t C1 = 0x27d4eb2fu;
constexpr uint32_t C2 = 0x9e3779b1u;

inline uint32_t slot_of(uint32_t h, uint32_t d, int tlog) {
  return (uint32_t)((h ^ (d * C1)) * C2) >> (32 - tlog);
}
}  // namespace

extern "C" int chd_build(const uint32_t* hu, const int32_t* uoff, int64_t U,
                         int64_t tlog, int64_t mlog, int32_t* D,
                         int32_t* table /* [T][3] */) {
  const int64_t T = int64_t(1) << tlog;
  const int64_t m = int64_t(1) << mlog;
  // bucket the keys: b = h & (m-1)
  std::vector<int32_t> bcnt(m + 1, 0);
  for (int64_t i = 0; i < U; ++i) ++bcnt[(hu[i] & (m - 1)) + 1];
  std::vector<int64_t> boff(m + 1, 0);
  std::partial_sum(bcnt.begin(), bcnt.end(), boff.begin());
  std::vector<int32_t> keys(U);
  {
    std::vector<int64_t> cur(boff.begin(), boff.end() - 1);
    for (int64_t i = 0; i < U; ++i) keys[cur[hu[i] & (m - 1)]++] = (int32_t)i;
  }
  // process buckets largest first
  std::vector<int32_t> order(m);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return boff[a + 1] - boff[a] > boff[b + 1] - boff[b];
  });
  std::vector<uint8_t> used(T, 0);
  std::vector<uint32_t> slots;
  memset(D, 0, sizeof(int32_t) * m);
  for (int64_t t = 0; t < 3 * T; ++t) table[t] = 0;
  for (int32_t b : order) {
    int64_t lo = boff[b], hi = boff[b + 1];
    if (lo == hi) continue;
    int64_t nk = hi - lo;
    bool placed = false;
    for (uint32_t d = 1; d < (1u << 20); ++d) {
      slots.clear();
      bool ok = true;
      for (int64_t k = lo; k < hi && ok; ++k) {
        uint32_t s = slot_of(hu[keys[k]], d, (int)tlog);
        if (used[s]) {
          ok = false;
          break;
        }
        for (uint32_t prev : slots)
          if (prev == s) {
            ok = false;
            break;
          }
        slots.push_back(s);
      }
      if (!ok || (int64_t)slots.size() != nk) continue;
      for (int64_t k = lo; k < hi; ++k) {
        int32_t key = keys[k];
        uint32_t s = slots[k - lo];
        used[s] = 1;
        table[3 * (int64_t)s + 0] = (int32_t)hu[key];
        table[3 * (int64_t)s + 1] = uoff[key];
        table[3 * (int64_t)s + 2] = uoff[key + 1];
      }
      D[b] = (int32_t)d;
      placed = true;
      break;
    }
    if (!placed) return 1;  // caller retries with a larger table
  }
  return 0;
}
