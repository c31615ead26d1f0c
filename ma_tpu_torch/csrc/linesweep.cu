// Kernel B: the harmonization shadow line sweep, sort included.
//
// Replaces the Pallas kernel ma_tpu/ops/harmonize_pallas.py `_sweep_kernel`
// together with the sort in front of it (ma_tpu/ops/harmonize.py
// `_linesweep`; reference harmonization.cpp linesweep:182-249). Each row of
// M elements (start, end, dist, valid) is processed in the order (start
// asc, end desc, original index asc) over its valid elements: the order of
// the stable sort by (valid ? start : 2^30, -end) there, restricted to the
// valid elements, which are the only ones the sweep reads. A per-row stack
// of elements grows when an element's end passes every end seen so far,
// replaces the suffix of entries whose end is >= the element's when none of
// them is closer (dist <= the element's), or drops the element. The output
// is the survivor mask at the ORIGINAL positions. `dist` is float32 and
// compared exactly as the plain version compares it.
//
// What bounds it on the H100: the bytes are 13 per element in and 1 out
// (59 MB at R = 65,536, M = 64: 0.018 ms at 3.35 TB/s); the work is the
// sort (M log^2 M / 4 compare-exchanges of a 64-bit key + index per row)
// and the sweep, whose steps are dependent within a row. Design:
//  - sort key (start biased to unsigned) << 32 | ~(end biased), ties by the
//    original index with a flag bit set for invalid elements: unique, so the
//    bitonic network gives the stable sort's order over the valid elements
//    exactly, and they come first;
//  - M <= 64: a block is one warp and a tile of 32 rows. The warp loads the
//    tile into shared memory with coalesced 16-byte loads (all in flight
//    before the sort), forming each element's key as it lands; the rows
//    holding two or more valid elements are sorted together by one bitonic
//    network over their 64 slots (each lane does a compare-exchange of every
//    such row per stage, so the 21 stages cost 21 warp syncs per tile, not
//    per row; rows of the main path hold a few valid elements, most none);
//    then each lane sweeps one row with its stack (element indices) in
//    shared memory, and the survivor bytes of the tile leave in 16-byte
//    stores;
//  - M > 64 (up to 2048 on long reads, 8192 in their overflow rescue): a
//    block of 128 threads per row sorts it (bitonic over the next power of
//    two S, __syncthreads between stages) and thread 0 sweeps it: R = 512
//    rows make 512 blocks. Its shared memory is 10 S + 11 M bytes, 168 KB at
//    M = 8192 (the H100 gives a block up to 227 KB).
// Per-row arrays in shared memory have a padded stride, so the lanes of a
// warp, each on its own row, fall on different banks.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SMALL_M = 64;   // rows of at most this many elements: warp tiles
constexpr int TILE = 32;      // rows per warp tile
constexpr int BIG_T = 128;    // threads per row for M > SMALL_M
constexpr int MAX_M = 8192;   // element indices fit in 15 bits (bit 15 flags invalid)

__device__ __forceinline__ uint64_t sort_key(int start, int end) {
  const uint32_t s = static_cast<uint32_t>(start) ^ 0x80000000u;
  const uint32_t e = ~(static_cast<uint32_t>(end) ^ 0x80000000u);  // end desc
  return (static_cast<uint64_t>(s) << 32) | e;
}

// One stage of a bitonic network over key/id [S]: thread t of T handles the
// pairs t, t + T, ...; lexicographic on (key, id).
__device__ __forceinline__ void bitonic_stage(uint64_t* key, uint16_t* id, int S, int k, int j,
                                              int t, int T) {
  for (int c = t; c < S / 2; c += T) {
    const int i = 2 * c - (c & (j - 1));
    const int l = i + j;
    const uint64_t ka = key[i], kb = key[l];
    const uint16_t ia = id[i], ib = id[l];
    const bool gt = ka > kb || (ka == kb && ia > ib);
    if (gt == ((i & k) == 0)) {
      key[i] = kb;
      key[l] = ka;
      id[i] = ib;
      id[l] = ia;
    }
  }
}

// The sweep of one row over its nv valid elements in processing order;
// marks the survivors in surv (zeroed by the caller). Index type I. The
// stack's ends increase strictly, so an element whose end passes the
// largest one is pushed without a walk; otherwise the walk down the entries
// whose end is >= its own stops at the first closer one (the element dies)
// or at the first smaller end (the entries above die and it takes their
// place): each entry is walked over at most once before it dies, or once
// per element it kills.
template <typename I>
__device__ void sweep_row(const I* order, int nv, const int* end, const float* dist, I* stk,
                          unsigned char* surv) {
  int sp = 0;
  int x = -1;  // max end of the valid elements so far
  for (int q = 0; q < nv; ++q) {
    const int el = order[q];
    const int e = end[el];
    if (e > x) {
      stk[sp++] = static_cast<I>(el);
      x = e;
      continue;
    }
    const float d = dist[el];
    int p = sp;
    bool closer = false;
    while (p > 0 && end[stk[p - 1]] >= e) {
      --p;
      if (dist[stk[p]] <= d) {
        closer = true;
        break;
      }
    }
    if (!closer) {  // entries past p die
      stk[p] = static_cast<I>(el);
      sp = p + 1;
    }
  }
  for (int p = 0; p < sp; ++p) surv[stk[p]] = 1;
}

// Copy n bytes of shared memory to global memory, coalesced, with 16-byte
// stores where both sides allow.
__device__ void store_bytes(unsigned char* g, const unsigned char* s, int n, int t, int T) {
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0 && (n & 15) == 0) {
    for (int k = t; k < n / 16; k += T)
      reinterpret_cast<uint4*>(g)[k] = reinterpret_cast<const uint4*>(s)[k];
  } else {
    for (int k = t; k < n; k += T) g[k] = s[k];
  }
}

// M <= 64: one warp, TILE rows.
__global__ void __launch_bounds__(32)
    linesweep_small(const int* __restrict__ starts, const int* __restrict__ ends,
                    const float* __restrict__ dists, const unsigned char* __restrict__ valid,
                    unsigned char* __restrict__ surv, int R, int M) {
  constexpr int LD = SMALL_M + 1;      // word stride of a row
  constexpr int LDB = SMALL_M + 4;     // byte stride of a row
  constexpr uint64_t KMAX = ~0ull;
  __shared__ uint64_t s_key[TILE * SMALL_M];  // sort keys, KMAX past M
  __shared__ int s_end[TILE * LD];
  __shared__ float s_dist[TILE * LD];
  // element index of each slot, 0x80 set for an invalid one (whose key is
  // the largest: valid elements sort first whatever their keys); the
  // processing order after the sort
  __shared__ uint8_t s_id[TILE * LDB];
  __shared__ uint8_t s_stack[TILE * LDB];
  __shared__ __align__(16) unsigned char s_surv[TILE * SMALL_M];
  __shared__ int s_nv[TILE];

  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * TILE;
  const int rows = min(TILE, R - r0);
  const size_t base = static_cast<size_t>(r0) * M;
  if (M < SMALL_M) {
    for (int r = 0; r < TILE; ++r) {
      for (int i = M + lane; i < SMALL_M; i += 32) {
        s_key[r * SMALL_M + i] = KMAX;
        s_id[r * LDB + i] = 0xff;
      }
    }
  }
  // ---- the tile's rows, coalesced, every load in flight before the sort:
  // 16-byte loads (4 elements of one row) where M and the pointers allow
  const bool vec = (M & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(starts + base) | reinterpret_cast<uintptr_t>(ends + base) |
                     reinterpret_cast<uintptr_t>(dists + base)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(valid + base) & 3) == 0;
  auto put = [&](int r, int i, int st, int e, float d, bool v) {
    s_key[r * SMALL_M + i] = v ? sort_key(st, e) : KMAX;
    s_id[r * LDB + i] = static_cast<uint8_t>(i | (v ? 0 : 0x80));
    s_end[r * LD + i] = e;
    s_dist[r * LD + i] = d;
  };
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(starts + base);
    const int4* e4 = reinterpret_cast<const int4*>(ends + base);
    const float4* d4 = reinterpret_cast<const float4*>(dists + base);
    const uint32_t* v4 = reinterpret_cast<const uint32_t*>(valid + base);
#pragma unroll 4
    for (int k = lane; k < rows * M / 4; k += 32) {
      const int4 a = s4[k], b = e4[k];
      const float4 c = d4[k];
      const uint32_t v = v4[k];
      const int r = 4 * k / M, i = 4 * k - r * M;
      put(r, i, a.x, b.x, c.x, v & 0xff);
      put(r, i + 1, a.y, b.y, c.y, (v >> 8) & 0xff);
      put(r, i + 2, a.z, b.z, c.z, (v >> 16) & 0xff);
      put(r, i + 3, a.w, b.w, c.w, v >> 24);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      for (int i = lane; i < M; i += 32) {
        const size_t g = base + static_cast<size_t>(r) * M + i;
        put(r, i, starts[g], ends[g], dists[g], valid[g]);
      }
    }
  }
  __syncwarp();
  // ---- the valid elements of each row; rows with two or more are sorted
  // together by one bitonic network over their 64 slots (a compare-exchange
  // of each sorted row per lane and stage, __syncwarp between stages)
  unsigned sortmask = 0;
  for (int r = 0; r < rows; ++r) {
    const unsigned m0 = __ballot_sync(0xffffffffu, s_id[r * LDB + lane] < 0x80);
    const unsigned m1 = __ballot_sync(0xffffffffu, s_id[r * LDB + lane + 32] < 0x80);
    const int nv = __popc(m0) + __popc(m1);
    if (lane == 0) {
      s_nv[r] = nv;
      if (nv == 1) s_id[r * LDB] = static_cast<uint8_t>(m0 ? __ffs(m0) - 1 : 31 + __ffs(m1));
    }
    if (nv > 1) sortmask |= 1u << r;
  }
  for (int k = 2; sortmask && k <= SMALL_M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * lane - (lane & (j - 1)), l = i + j;
      const bool up = (i & k) == 0;
      for (unsigned mk = sortmask; mk; mk &= mk - 1) {
        const int r = __ffs(mk) - 1;
        uint64_t* key = s_key + r * SMALL_M;
        uint8_t* id = s_id + r * LDB;
        const uint64_t ka = key[i], kb = key[l];
        const uint8_t ia = id[i], ib = id[l];
        if ((ka > kb || (ka == kb && ia > ib)) == up) {
          key[i] = kb;
          key[l] = ka;
          id[i] = ib;
          id[l] = ia;
        }
      }
      __syncwarp();
    }
  }
  for (int k = lane; k < TILE * SMALL_M / 16; k += 32)
    reinterpret_cast<uint4*>(s_surv)[k] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  // ---- one lane sweeps each row
  if (lane < rows)
    sweep_row<uint8_t>(s_id + lane * LDB, s_nv[lane], s_end + lane * LD, s_dist + lane * LD,
                       s_stack + lane * LDB, s_surv + lane * M);
  __syncwarp();
  store_bytes(surv + base, s_surv, rows * M, lane, 32);
}

// M > 64: one block of BIG_T threads per row; S = next power of two >= M.
__global__ void __launch_bounds__(BIG_T)
    linesweep_big(const int* __restrict__ starts, const int* __restrict__ ends,
                  const float* __restrict__ dists, const unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ surv, int R, int M, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem);         // [S]
  int* s_end = reinterpret_cast<int*>(s_key + S);              // [M]
  float* s_dist = reinterpret_cast<float*>(s_end + M);         // [M]
  uint16_t* s_id = reinterpret_cast<uint16_t*>(s_dist + M);    // [S]
  uint16_t* s_stack = s_id + S;                                // [M]
  unsigned char* s_surv = reinterpret_cast<unsigned char*>(s_stack + M);  // [M]

  __shared__ int s_nv;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * M;
  if (t == 0) s_nv = 0;
  __syncthreads();
  int nv = 0;
  // keys (the largest for an invalid element), and element indices with
  // 0x8000 set for an invalid one (so that valid elements sort first
  // whatever their keys)
  for (int i = t; i < S; i += BIG_T) {
    uint64_t key = ~0ull;
    uint16_t id = 0xffff;
    if (i < M) {
      const int e = ends[base + i];
      s_end[i] = e;
      s_dist[i] = dists[base + i];
      s_surv[i] = 0;
      const bool v = valid[base + i];
      if (v) key = sort_key(starts[base + i], e);
      id = static_cast<uint16_t>(i | (v ? 0 : 0x8000));
      nv += v;
    }
    s_key[i] = key;
    s_id[i] = id;
  }
  if (nv) atomicAdd(&s_nv, nv);
  for (int k = 2; k <= S; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      bitonic_stage(s_key, s_id, S, k, j, t, BIG_T);
    }
  }
  __syncthreads();
  if (t == 0) sweep_row<uint16_t>(s_id, s_nv, s_end, s_dist, s_stack, s_surv);
  __syncthreads();
  store_bytes(surv + base, s_surv, M, t, BIG_T);
}

}  // namespace

// starts / ends int32 [R, M], dists float32 [R, M], valid uint8 [R, M]
// (any order) -> surv uint8 [R, M] at the original positions; M <= MAX_M.
extern "C" int ma_linesweep(const void* starts, const void* ends, const void* dists,
                            const void* valid, void* surv, int R, int M, void* stream) {
  if (M < 1 || M > MAX_M) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int*>(starts);
  const auto* e = static_cast<const int*>(ends);
  const auto* d = static_cast<const float*>(dists);
  const auto* v = static_cast<const unsigned char*>(valid);
  auto* out = static_cast<unsigned char*>(surv);
  if (M <= SMALL_M) {
    linesweep_small<<<(R + TILE - 1) / TILE, 32, 0, st>>>(s, e, d, v, out, R, M);
  } else {
    int S = 1;
    while (S < M) S <<= 1;
    const size_t smem = static_cast<size_t>(S) * (8 + 2) + static_cast<size_t>(M) * (4 + 4 + 2 + 1);
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          linesweep_big, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    linesweep_big<<<R, BIG_T, smem, st>>>(s, e, d, v, out, R, M, S);
  }
  return ma_launch_status();
}
