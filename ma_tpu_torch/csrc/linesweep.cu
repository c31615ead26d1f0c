// Kernel B: the harmonization shadow line sweep.
//
// Replaces the Pallas kernel ma_tpu/ops/harmonize_pallas.py `_sweep_kernel`
// (entry `linesweep_sorted_pallas`; reference harmonization.cpp
// linesweep:182-249). Elements arrive presorted by (start asc, end desc).
// A per-row stack of (end, dist, seed) grows when an element's end passes
// every end seen so far, replaces the suffix of entries whose end is >= the
// element's when none of them is closer (dist <= the element's), or drops
// the element. The output is the survivor mask at ORIGINAL positions.
// `dist` is float32 and compared exactly as the plain version compares it.
//
// What bounds it on the H100: per row, M sequential steps of dependent
// loads (M = 64 on short reads, up to 2048 on long reads); rows are
// independent, so one thread per row (reads x SoCs x strands ~ 65k rows on
// the main path). The Pallas kernel kept [M, rows] stack planes in VMEM and
// scanned all M slots per step; here the stack lives in global scratch laid
// out [M, R] (neighbouring rows' threads touch neighbouring words, so a warp's
// accesses coalesce and stay in L1/L2), which takes any M up to 2048 with one
// code path. The stack's ends are strictly increasing (every push either
// appends an end above all others or replaces the suffix of ends >= it), so
// the suffix of entries with end >= e is found by walking down from the top
// and stopping at the first smaller end: O(suffix) instead of O(M) a step.
#include "common.cuh"

__global__ void linesweep_kernel(const int* __restrict__ s_end,
                                 const float* __restrict__ s_dist,
                                 const int* __restrict__ s_valid,
                                 const int* __restrict__ s_orig,
                                 unsigned char* __restrict__ surv,
                                 int* __restrict__ st_end, float* __restrict__ st_dist,
                                 int* __restrict__ st_seed, int R, int M) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t row = static_cast<size_t>(r) * M;
  int sp = 0;
  int x = -1;  // max end of the valid elements so far
  for (int j = 0; j < M; ++j) {
    if (!s_valid[row + j]) continue;
    const int e = s_end[row + j];
    const float d = s_dist[row + j];
    int p = sp;
    bool closer = false;
    while (p > 0 && st_end[static_cast<size_t>(p - 1) * R + r] >= e) {
      --p;
      if (st_dist[static_cast<size_t>(p) * R + r] <= d) closer = true;
    }
    const bool grow = e > x;
    if (grow || !closer) {
      const int put = grow ? sp : p;  // entries past `put` die
      const size_t at = static_cast<size_t>(put) * R + r;
      st_end[at] = e;
      st_dist[at] = d;
      st_seed[at] = s_orig[row + j];
      sp = put + 1;
    }
    x = e > x ? e : x;
  }
  unsigned char* out = surv + row;
  for (int k = 0; k < M; ++k) out[k] = 0;
  for (int p = 0; p < sp; ++p) {
    const int s = st_seed[static_cast<size_t>(p) * R + r];
    if (s >= 0 && s < M) out[s] = 1;
  }
}

extern "C" int ma_linesweep(const void* s_end, const void* s_dist, const void* s_valid,
                            const void* s_orig, void* surv, void* st_end, void* st_dist,
                            void* st_seed, int R, int M, void* stream) {
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  linesweep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s_end), static_cast<const float*>(s_dist),
      static_cast<const int*>(s_valid), static_cast<const int*>(s_orig),
      static_cast<unsigned char*>(surv), static_cast<int*>(st_end),
      static_cast<float*>(st_dist), static_cast<int*>(st_seed), R, M);
  return ma_launch_status();
}
