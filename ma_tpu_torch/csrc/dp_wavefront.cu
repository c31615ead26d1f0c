// Kernel D: banded 2-piece affine-gap DP with z-drop as an anti-diagonal
// wavefront, emitting the direction byte of every cell.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_pallas.py `_dp_kernel` (entry
// `banded_align_pallas`), which computes cell for cell what the XLA scan
// ma_tpu/ops/dp.py `banded_align` computes. Cell (i, j) lies on diagonal
// d = i + j, lane i; it reads the lane's own H, E1, E2 from diagonal d-1,
// lane i-1's H, F1, F2 from d-1 and lane i-1's H from d-2. Recurrence,
// virtual row / column (gap_cost), tie order (diag, E1, F1, E2, F2) and
// direction-byte layout follow the plain version
// ma_tpu_torch/ops/dp_wavefront.py `banded_align_wavefront_plain`; every
// (diagonal, lane) byte is written, masked cells included (E and F are
// kept unmasked outside the band, and a traceback in a gap state follows
// them there). Output: dirs [P, M+N-1, M] uint8 and out [4, P] int32
// (score, max_i, max_j, zdropped).
//
// What bounds it on the H100: every cell's recurrence (about 46 integer
// operations) and every cell's byte to device memory; at P = 256, M = 1024,
// N = 4096 that is 1.342 G cells, 3.69 ms of int32 work at 16.73 T op/s
// against 0.40 ms of writes, so the integer work. The design keeps the
// chain of D = M+N-1 diagonals free of block-wide steps:
//  - lanes in registers: a thread owns L = 4 consecutive lanes (2 where
//    the problems are too few to fill the SMs with warps) and keeps
//    their H (d-1, d-2), E1, E2, F1, F2 and query codes in registers; the
//    target codes shift one lane down per diagonal (lane i at d+1 takes lane
//    i-1's code at d), so a thread takes its first lane's code from its left
//    neighbour by __shfl_up_sync and a warp loads one code per diagonal from
//    the target staged in shared memory as bytes (read from device memory
//    where it does not fit);
//  - warps pipelined: a warp owns 32 L consecutive lanes (a chunk); lane
//    i-1's values come from the thread's own registers, by __shfl_up_sync,
//    or, for a warp's first lane, from a ring of RING diagonals in shared
//    memory that the warp to its left fills. Each pair of neighbouring warps
//    synchronizes on its own through per-warp progress counters, once per
//    group of PUB diagonals (a group waits for the left warp's lanes it
//    reads and for the right warp to have read the slots it overwrites),
//    so warps run skewed by a group or two and no barrier of the block sits
//    in the diagonal loop. A team of W <= 16 warps takes one problem; where
//    M needs more chunks, the warps take them in rounds, the last warp's
//    edge lane going, one group at a time, to a global buffer [P, 2, D]
//    (double-buffered by round) and from there into the first warp's ring
//    in the next round;
//  - the book off the critical path: each thread keeps its lanes' best (h,
//    first lane) per diagonal in shared memory; at a group's end the warp
//    folds the group's 8 diagonals at once (a lane takes 8 threads of one
//    diagonal, 4 lanes combine by shuffle) and adds one 64-bit key
//    h * 2^32 + (2^32 - 1 - i) (h biased) per diagonal to the problem's
//    per-diagonal table by atomicMax in L2; after the sweep one warp folds
//    the table 32 diagonals at a time: a prefix argmax with strict > (the
//    earliest diagonal reaching the running maximum) gives the book, and the
//    first diagonal that drops ends it, which is what the per-diagonal check
//    gives, since a drop freezes the book and changes no cell;
//  - one L-byte store per thread per diagonal, 32 L contiguous bytes a
//    warp, where M % L == 0, bytes otherwise;
//  - several problems per block where M is small and P large (G teams).
// The max-plus steps use the DPX intrinsic __vibmax_s32 (the max and which
// argument won, ties to the first: the plain version's tie order); on sm_90a
// it compiles to a compare and two selects, about 46 instructions a cell.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NEG = -(1 << 30);
constexpr int CONT_E1 = 0x08, CONT_F1 = 0x10, CONT_E2 = 0x20, CONT_F2 = 0x40;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WMAX = 16;         // warps of a team (one problem)
constexpr int RING = 32;         // diagonals a warp-edge ring holds
constexpr int PUB = 8;           // a warp publishes its progress every PUB diagonals
static_assert(RING >= PUB + 2, "the ring must outlast the progress lag");
static_assert(PUB == 8, "a group's book fold gives each diagonal 4 lanes of 8 threads");

struct Scores {
  int match, mismatch, go1, ge1, go2, ge2;
};

__device__ __forceinline__ int gap_cost(int k, const Scores& s) {
  return max(-(s.go1 + k * s.ge1), -(s.go2 + k * s.ge2));
}

// Shared memory of one team: W + 1 edge rings (int4 slots: H, F1, F2 of a
// warp's last lane, ring w read by warp w; ring 0 takes the last round's
// edge and ring W the last warp's for the next round), each warp's book of
// its group (PUB x 32 threads' best h and lane), W progress counters, the
// target bytes if staged.
__host__ __device__ inline int team_smem_bytes(int W, int tbytes) {
  return (W + 1) * RING * 16 + W * PUB * 32 * 8 + (W * 4 + 15) / 16 * 16 + tbytes;
}

__device__ __forceinline__ int ld_volatile(const int* p) { return *const_cast<const volatile int*>(p); }

__device__ __forceinline__ void st_volatile(int* p, int v) { *const_cast<volatile int*>(p) = v; }

// Per-diagonal key: biased h in the high half, 2^32 - 1 - lane in the low
// half, so the largest key is the maximal h at its first lane; 0 = none.
__device__ __forceinline__ unsigned long long diag_key(int h, unsigned lane) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(h) ^ 0x80000000u) << 32) |
         (0xffffffffu - lane);
}

// A code as the kernel compares it, in one byte: every code >= 4 is N (4),
// any other keeps its low byte, so 0..3 and -128..-1 compare as they are
// (the wrapper stages the target in the same form).
__device__ __forceinline__ unsigned code_byte(int c) {
  return c >= 4 ? 4u : static_cast<unsigned>(c) & 0xffu;
}

// L lanes a thread (4, or 2 where few problems would leave SMs idle).
template <int L>
__global__ void __launch_bounds__(512)
    dp_wavefront_kernel(const int* __restrict__ q, const unsigned char* __restrict__ t,
                        const int* __restrict__ lens, unsigned char* __restrict__ dirs,
                        int* __restrict__ out, unsigned long long* __restrict__ keys,
                        int4* __restrict__ wrap, int P, int M, int N, Scores s, int zdrop,
                        int is_global, int W, int G, int staged) {
  constexpr int CHUNK = 32 * L;  // lanes a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = 32 * W;
  const int team = threadIdx.x / T;
  const int ti = threadIdx.x - team * T;
  const int lane = ti & 31, wi = ti >> 5;
  const int tbytes = staged ? (N + 15) / 16 * 16 : 0;
  unsigned char* base = smem_raw + static_cast<size_t>(team) * team_smem_bytes(W, tbytes);
  int4* ring = reinterpret_cast<int4*>(base);                            // [W + 1][RING]
  int2* book = reinterpret_cast<int2*>(base + (W + 1) * RING * 16);       // [W][PUB][32]
  int* prog = reinterpret_cast<int*>(base + (W + 1) * RING * 16 + W * PUB * 256);  // [W]
  unsigned char* tsm = base + team_smem_bytes(W, 0);                 // [N] if staged
  const int D = M + N - 1;
  const int p = blockIdx.x * G + team;
  const bool live = p < P;
  const int nch = (M + CHUNK - 1) / CHUNK;
  const unsigned char* tp = t + static_cast<size_t>(p) * N;
  const unsigned char* tb = staged ? tsm : tp;  // the target as bytes (code_byte)
  unsigned long long* kp = keys + static_cast<size_t>(p) * D;

  // ---- set-up (before the sweep): zeroed keys and counters, staged target
  if (live) {
    for (int k = ti; k < D; k += T) kp[k] = 0ull;
    if (ti < W) prog[ti] = 0;
    if (staged)
      for (int k = ti; k < N; k += T) tsm[k] = tp[k];
    if (ti == 0 && is_global) out[p] = NEG;
  }
  __threadfence();
  __syncthreads();

  const int m = live ? lens[p * 3 + 0] : 0, n = live ? lens[p * 3 + 1] : 0;
  const int w = live ? lens[p * 3 + 2] : 0;
  const int mm = min(m, M);
  const int wc = min(w, 1 << 29);
  const int dend = is_global && m >= 1 && n >= 1 ? m + n - 2 : -1;  // the end cell's diagonal
  const int c1 = s.go1 + s.ge1, c2 = s.go2 + s.ge2;
  const int* qp = q + static_cast<size_t>(p) * M;
  const bool aligned = M % L == 0;
  int seen_left = 0, seen_right = 0;  // progress last read of the neighbour warps

  for (int rnd = 0; live; ++rnd) {
    const int c = rnd * W + wi;  // this warp's chunk in this round
    if (c >= nch) break;
    const int cbase = c * CHUNK;
    const int i0 = cbase + lane * L;
    const bool has_left = c > 0, has_right = c + 1 < nch;
    const bool from_wrap = wi == 0 && rnd > 0;  // the left lane is the last round's last
    const bool to_wrap = wi == W - 1 && has_right;  // the right lane is the next round's first
    // per-lane constants: query codes, the diagonals of the in-band cells
    unsigned qw = 0;
    int dlo[L];
    unsigned span[L];
    int H1[L], H2[L], E1[L], E2[L], F1[L], F2[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + k;
      const unsigned qc = i < M ? code_byte(qp[i]) : 4u;
      qw |= qc << (8 * k);
      const int lo = max(i, 2 * i - wc), hi = min(i + n - 1, 2 * i + wc);
      const bool any = i < mm && lo <= hi;
      dlo[k] = any ? lo : INT_MAX;
      span[k] = any ? static_cast<unsigned>(hi - lo) : 0u;
      H1[k] = H2[k] = E1[k] = E2[k] = F1[k] = F2[k] = NEG;
    }
    unsigned tw = 0x04040404u;  // the lanes' target codes at the last diagonal
    int plH1 = NEG;             // the left lane's H one diagonal back
    unsigned char* row = dirs + static_cast<size_t>(p) * D * M + i0;  // this thread's bytes
    // a target code of the warp's first lane
    auto tcode = [&](int jv) -> unsigned {
      return static_cast<unsigned>(jv) < static_cast<unsigned>(N) ? tb[jv] : 4u;
    };
    unsigned tnext = tcode(-cbase);
    // lane i-1's state at d-1 for the warp's first lane: the left warp's
    // edge lane in this warp's ring, loaded one diagonal ahead within a group
    auto edge_in = [&](int d) -> int4 {
      return ring[wi * RING + ((rnd * D + d - 1) & (RING - 1))];
    };
    int4 vnext;
    int d1 = 0;  // the end of the current group

    // one diagonal; EDGE: some lane of the warp lies at j <= 0, where the
    // virtual column and the i = 0 row enter
    auto diagonal = [&](int d, auto edge) {
      constexpr bool EDGE = decltype(edge)::value;
      const int g = rnd * D + d;  // this warp's step, counted over rounds
      // ---- lane i-1's H, F1, F2 at d-1 and H at d-2 for the thread's first
      // lane: the left thread's last lane, or the left warp's edge lane, or
      // lane 0's virtual row
      const int4 v = vnext;
      if (d + 1 < d1) vnext = edge_in(d + 1);
      int lH1 = __shfl_up_sync(FULL, H1[L - 1], 1);
      int lF1 = __shfl_up_sync(FULL, F1[L - 1], 1);
      int lF2 = __shfl_up_sync(FULL, F2[L - 1], 1);
      if (lane == 0) {
        const bool none = EDGE && d == 0;  // diagonal -1 holds NEG everywhere
        lH1 = none ? NEG : v.x;
        lF1 = none ? NEG : v.y;
        lF2 = none ? NEG : v.z;
      }
      int lH2 = plH1;
      plH1 = lH1;
      if (c == 0 && lane == 0) {  // lane 0's virtual neighbour (the i = 0 row)
        lH1 = lH2 = gap_cost(d, s);
        lF1 = NEG + s.ge1;
        lF2 = NEG + s.ge2;
      }
      // ---- target codes one lane down
      const unsigned up = __shfl_up_sync(FULL, tw, 1);
      tw = (tw << 8) | (lane == 0 ? tnext : (up >> (8 * (L - 1))) & 0xffu);
      tnext = tcode(d + 1 - cbase);
      // ---- the cells, last lane first (each reads its left lane's old state)
      unsigned word = 0;
      int bh = INT_MIN, bk = 0;
#pragma unroll
      for (int k = L - 1; k >= 0; --k) {
        const int xH1 = k > 0 ? H1[k - 1] : lH1, xH2 = k > 0 ? H2[k - 1] : lH2;
        const int xF1 = k > 0 ? F1[k - 1] : lF1, xF2 = k > 0 ? F2[k - 1] : lF2;
        int hl, e1x, e2x, hu, f1x, f2x, dg;
        if (EDGE) {
          const int i = i0 + k, jv = d - i;
          const bool jp = jv > 0;
          hl = jp ? H1[k] : (i > 0 ? gap_cost(i, s) : NEG);
          e1x = jp ? E1[k] - s.ge1 : NEG;
          e2x = jp ? E2[k] - s.ge2 : NEG;
          if (i > 0) {
            hu = xH1;
            f1x = xF1 - s.ge1;
            f2x = xF2 - s.ge2;
            dg = jp ? xH2 : gap_cost(i, s);
          } else {
            hu = jp ? gap_cost(jv, s) : NEG;
            f1x = f2x = NEG;
            dg = jv == 0 ? 0 : gap_cost(jv, s);
          }
        } else {
          hl = H1[k];
          e1x = E1[k] - s.ge1;
          e2x = E2[k] - s.ge2;
          hu = xH1;
          f1x = xF1 - s.ge1;
          f2x = xF2 - s.ge2;
          dg = xH2;
        }
        bool ce1, ce2, cf1, cf2, keep;
        const int ne1 = __vibmax_s32(e1x, hl - c1, &ce1);  // continue: e1x >= open
        const int ne2 = __vibmax_s32(e2x, hl - c2, &ce2);
        const int nf1 = __vibmax_s32(f1x, hu - c1, &cf1);
        const int nf2 = __vibmax_s32(f2x, hu - c2, &cf2);
        const unsigned qc = (qw >> (8 * k)) & 0xff, tc = (tw >> (8 * k)) & 0xff;
        int sc = qc == tc ? s.match : -s.mismatch;
        sc = qc == 4 || tc == 4 ? 0 : sc;
        int h = dg + sc, src = 0;
        h = __vibmax_s32(h, ne1, &keep);  // ties keep the earlier source
        src = keep ? src : 1;
        h = __vibmax_s32(h, nf1, &keep);
        src = keep ? src : 2;
        h = __vibmax_s32(h, ne2, &keep);
        src = keep ? src : 3;
        h = __vibmax_s32(h, nf2, &keep);
        src = keep ? src : 4;
        const bool valid = static_cast<unsigned>(d - dlo[k]) <= span[k];
        const int hv = valid ? h : NEG;
        word |= static_cast<unsigned>(src | (ce1 ? CONT_E1 : 0) | (cf1 ? CONT_F1 : 0) |
                                      (ce2 ? CONT_E2 : 0) | (cf2 ? CONT_F2 : 0))
                << (8 * k);
        bool first;
        bh = __vibmax_s32(hv, bh, &first);  // a tie goes to the smaller lane
        bk = first ? k : bk;
        H2[k] = H1[k];
        H1[k] = hv;
        E1[k] = ne1;
        E2[k] = ne2;
        F1[k] = nf1;
        F2[k] = nf2;
      }
      if (d == dend) {  // the global end cell (NEG where it lies outside the band)
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (i0 + k == m - 1) out[p] = H1[k];
      }
      // ---- the bytes: one store a thread where rows stay aligned
      if (aligned) {
        if (i0 < M) {
          if (L == 4) {
            __stcs(reinterpret_cast<unsigned*>(row), word);
          } else {
            __stcs(reinterpret_cast<unsigned short*>(row), static_cast<unsigned short>(word));
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (i0 + k < M) row[k] = static_cast<unsigned char>(word >> (8 * k));
      }
      row += M;
      // ---- the edge lane for the right warp (or the next round's first)
      if (has_right && lane == 31)
        ring[(wi + 1) * RING + (g & (RING - 1))] = make_int4(H1[L - 1], F1[L - 1], F2[L - 1], 0);
      // ---- this thread's best (h, first lane) of the diagonal, folded with
      // the warp's at the group's end
      book[(wi * PUB + (d & (PUB - 1))) * 32 + lane] = make_int2(bh, i0 + bk);
    };

    // the diagonals in groups of PUB: each group first waits for the left
    // warp's lanes it reads and for the right warp to have read the ring
    // slots it will overwrite, and publishes this warp's progress after
    const int edge_end = min(D, cbase + CHUNK);  // diagonals where some lane has j <= 0
    for (int d0 = 0; d0 < D; d0 += PUB) {
      d1 = min(d0 + PUB, D);
      if (has_left) {
        const int need = (from_wrap ? rnd - 1 : rnd) * D + d1 - 1;
        if (seen_left < need) {
          const int* src = &prog[wi > 0 ? wi - 1 : W - 1];
          do {
            seen_left = ld_volatile(src);
          } while (seen_left < need);
          __threadfence_block();
        }
      }
      if (has_right && wi < W - 1) {
        const int need = rnd * D + d1 + 1 - RING;
        if (seen_right < need) {
          do {
            seen_right = ld_volatile(&prog[wi + 1]);
          } while (seen_right < need);
          __threadfence_block();
        }
      }
      if (from_wrap) {  // the last round's edge lane into this warp's ring
        const int d = d0 + lane;
        if (d < d1 && d >= 1)
          ring[(rnd * D + d - 1) & (RING - 1)] =
              __ldcg(&wrap[(static_cast<size_t>(p) * 2 + ((rnd - 1) & 1)) * D + d - 1]);
        __syncwarp();
      }
      vnext = edge_in(d0);
      if (d1 <= edge_end) {
        for (int d = d0; d < d1; ++d) diagonal(d, std::true_type{});
      } else if (d0 >= edge_end) {
        for (int d = d0; d < d1; ++d) diagonal(d, std::false_type{});
      } else {
        for (int d = d0; d < d1; ++d) {
          if (d < edge_end) {
            diagonal(d, std::true_type{});
          } else {
            diagonal(d, std::false_type{});
          }
        }
      }
      __syncwarp();
      if (to_wrap && d0 + lane < d1)  // this group's edge lane for the next round
        __stcg(&wrap[(static_cast<size_t>(p) * 2 + (rnd & 1)) * D + d0 + lane],
               ring[W * RING + ((rnd * D + d0 + lane) & (RING - 1))]);
      {
        // the group's warp maxima into the table: lane l folds 8 threads'
        // bests of diagonal d0 + l / 4 (the first thread wins a tie, as the
        // smaller lane), then each 4 lanes combine theirs
        const int j = lane >> 2;
        const int2* b = book + (wi * PUB + j) * 32 + (lane & 3) * 8;
        int hb = INT_MIN, ib = 0;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int2 e = b[x];
          if (e.x > hb) {
            hb = e.x;
            ib = e.y;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const int h2 = __shfl_down_sync(FULL, hb, o), i2 = __shfl_down_sync(FULL, ib, o);
          if (h2 > hb || (h2 == hb && i2 < ib)) {
            hb = h2;
            ib = i2;
          }
        }
        if ((lane & 3) == 0 && d0 + j < d1 && hb > NEG)  // some lane in the band
          atomicMax(&kp[d0 + j], diag_key(hb, static_cast<unsigned>(ib)));
      }
      if (lane == 0) {
        __threadfence_block();
        st_volatile(&prog[wi], rnd * D + d1);
      }
    }
  }

  // ---- the book, rebuilt from the per-diagonal table by the team's warp 0
  __threadfence();
  __syncthreads();
  if (!live || wi != 0) return;
  const int g0 = is_global ? NEG : 0;
  unsigned long long carry = 0ull;  // the best key of the diagonals before
  int carry_arg = 0;                // the first maximal lane at carry's diagonal
  int rgmax = g0, rgi = -1, rgj = -1;
  bool dropped = false;
  for (int b = 0; b < D; b += 32) {
    const int d = b + lane;
    const unsigned long long raw = d < D ? __ldcg(&kp[d]) : 0ull;
    const int dmax = raw ? static_cast<int>(static_cast<unsigned>(raw >> 32) ^ 0x80000000u) : NEG;
    const int darg = raw ? static_cast<int>(0xffffffffu - static_cast<unsigned>(raw)) : 0;
    // the earliest diagonal reaching the running maximum: inclusive prefix max
    unsigned long long k = raw ? diag_key(dmax, static_cast<unsigned>(d)) : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, k, o);
      if (lane >= o) k = y > k ? y : k;
    }
    const unsigned long long best = k > carry ? k : carry;
    const int bmax = static_cast<int>(static_cast<unsigned>(best >> 32) ^ 0x80000000u);
    const int bd = static_cast<int>(0xffffffffu - static_cast<unsigned>(best));
    const int here = __shfl_sync(FULL, darg, bd >= b ? bd - b : 0);
    const int barg = bd >= b ? here : carry_arg;
    int gmax = g0, gi = -1, gj = -1;
    if (best && bmax > g0) {
      gmax = bmax;
      gi = barg;
      gj = bd - barg;
    }
    bool drop = false;
    if (zdrop >= 0 && d < D && gi >= 0) {
      // an in-band cell on d: a lane i < min(m, M) with 0 <= d - i < n, |2i - d| <= w
      const int lo = max(max(0, d - n + 1), (d - wc + 1) >> 1);
      const int hi = min(min(mm - 1, d), (d + wc) >> 1);
      drop = lo <= hi && gmax - dmax > zdrop + abs((darg - gi) - ((d - darg) - gj)) * s.ge1;
    }
    const unsigned ball = __ballot_sync(FULL, drop);
    const int at = ball ? __ffs(ball) - 1 : 31;
    rgmax = __shfl_sync(FULL, gmax, at);
    rgi = __shfl_sync(FULL, gi, at);
    rgj = __shfl_sync(FULL, gj, at);
    if (ball) {
      dropped = true;
      break;
    }
    carry = __shfl_sync(FULL, best, 31);
    carry_arg = __shfl_sync(FULL, barg, 31);
  }
  if (lane == 0) {
    if (!is_global) out[0 * P + p] = rgmax;
    out[1 * P + p] = rgi;
    out[2 * P + p] = rgj;
    out[3 * P + p] = dropped ? 1 : 0;
  }
}

// Lanes a thread: 4, or 2 where 4 would give the SMs fewer than 8 warps
// each (where problems are few, each runs its diagonals at the speed of one
// warp's chain, so more, narrower warps per problem shorten it).
int lanes_per_thread(int P, int M, int sms) {
  return static_cast<long long>(P) * ((M + 127) / 128) >= 8LL * sms ? 4 : 2;
}

int team_warps(int M, int L) {
  const int chunks = (M + 32 * L - 1) / (32 * L);
  return chunks < WMAX ? chunks : WMAX;
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// Lanes a thread kernel D takes by default for P problems of M lanes on
// this device (4 or 2).
extern "C" long long ma_dp_wavefront_lanes(int P, int M) {
  return lanes_per_thread(P, M, device_sms());
}

// int32 per problem of the round buffer [2, D, 4] that kernel D needs at L
// lanes a thread where a problem's lanes take more than one round of its
// team's warps, else 0.
extern "C" long long ma_dp_wavefront_round_ints(int M, int N, int L) {
  return (M + 32 * L - 1) / (32 * L) > team_warps(M, L) ? 2LL * (M + N - 1) * 4 : 0;
}

// q [P, M] int32 codes; t [P, N] uint8 target codes in code_byte's form;
// lens [P, 3] int32 (qlen, tlen, band); keys [P, M+N-1] 64-bit scratch (the
// per-diagonal table); wrap: [P, ma_dp_wavefront_round_ints] int32 or null;
// lanes: L, 4 or 2 (ma_dp_wavefront_lanes gives the default).
extern "C" int ma_dp_wavefront(const void* q, const void* t, const void* lens, void* dirs,
                               void* out, void* keys, void* wrap, int P, int M, int N, int match,
                               int mismatch, int go1, int ge1, int go2, int ge2, int zdrop,
                               int is_global, int lanes, void* stream) {
  const int sms = device_sms();
  const int L = lanes;
  if (L != 4 && L != 2) return cudaErrorInvalidValue;
  const int W = team_warps(M, L);
  if ((M + 32 * L - 1) / (32 * L) > W && wrap == nullptr) return cudaErrorInvalidValue;
  // teams per block: up to 256 threads, while at least two blocks per SM remain
  int G = 1;
  while (2 * G * 32 * W <= 256 && P / (2 * G) >= 2 * sms) G *= 2;
  // the target staged in shared memory where it fits (100 KB a block)
  const int tb = (N + 15) / 16 * 16;
  const int staged = static_cast<size_t>(G) * team_smem_bytes(W, tb) <= 100 * 1024 ? 1 : 0;
  const size_t smem = static_cast<size_t>(G) * team_smem_bytes(W, staged ? tb : 0);
  auto kernel = L == 4 ? dp_wavefront_kernel<4> : dp_wavefront_kernel<2>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  kernel<<<(P + G - 1) / G, G * 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const unsigned char*>(t),
      static_cast<const int*>(lens),
      static_cast<unsigned char*>(dirs), static_cast<int*>(out),
      static_cast<unsigned long long*>(keys), static_cast<int4*>(wrap), P, M, N, s, zdrop,
      is_global, W, G, staged);
  return ma_launch_status();
}
