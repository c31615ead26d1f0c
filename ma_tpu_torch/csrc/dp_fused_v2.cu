// Kernel C': banded 2-piece affine-gap DP with z-drop and in-kernel
// traceback, kernel C's contract (runs [P, R], meta [8, P]) for targets of
// any width N.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_fused.py `_kernel_v2` (entry
// `banded_align_runs` under MA_TPU_DP_V2=1); past 4,096 columns it stands
// for `_kernel`, which tiles any N. Recurrences, boundary values, direction
// bytes, tie precedence, max-cell book and traceback are kernel C's
// (csrc/dp_fused.cu), so every output equals C's and the plain version
// ma_tpu_torch/ops/dp_fused.py `banded_align_runs_plain`.
//
// What bounds it on the H100: 46 integer operations per in-band cell (as
// C, chip_smoke.py DP_OPS_PER_CELL), rows dependent one after another, and
// each row's E term a prefix maximum along the row; the in-band direction
// bytes leave the chip for the traceback (a 256 x 4096 problem's rows are
// 1 MB wide, far above shared memory). A row's cells depend on each other
// through the E prefix, so a team is latency-bound row by row, and the
// teams resident on an SM set the throughput. Design:
//  - up to 1,024 columns, static column tiles: a team of T <= 256 threads
//    owns a problem, each thread 4 consecutive columns (a "group") with
//    their H, F1, F2 and target codes in registers from row to row;
//  - wider rows (WIDE) are walked in chunks of 1,024 columns (256 threads x
//    4) that start at the 16-column boundary at or left of the row's band,
//    so a row of a 512 band takes one full chunk and a few columns of a
//    second, whatever N; a chunk's H / F1 / F2 come from and go back to a
//    per-problem buffer [3, ldn] int32 (in L2) by column, and from chunk to
//    chunk the team carries the E prefix maxima after the chunk's last
//    column and that column's H~ and H of the row above through a
//    double-buffered slot in shared memory;
//  - work skipped, by kernel C's rule (csrc/dp_fused.cu header): a group
//    whose columns all lie left of the band or right of it computes nothing
//    for the row, and a WIDE row visits no chunk outside its band. A
//    right-of-band column's F is a closed form of its row-0 boundary, set
//    when its group enters the band; the E terms of skipped columns are
//    dominated by the virtual column's; a value the row reads from a group
//    that was out of the band in the row above is NEG there. Problems whose
//    traceback starts outside the band (global, |m - n| > band) compute
//    every cell; an extension problem stops at the row after its z-drop
//    fires;
//  - DPX instructions in the cell step (dp_common.cuh cell_f / cell_h);
//  - per row (chunk) the team exchanges the warp totals of the E scan and
//    the H / H~ values at warp edges through shared memory, two team
//    barriers a row (a __syncwarp for a one-warp team, a named barrier
//    otherwise); the max-cell, z-drop and last-row book live in the team
//    leader's registers, fed one 64-bit key per warp (h * 2^32 +
//    (INT_MAX - j), so any column fits); registers are capped so that 3
//    teams of 256 threads fit an SM;
//  - direction rows streamed out: each row's (chunk's) bytes are formed in
//    one slot of a double-buffered shared-memory row, and only the span of
//    its in-band groups (16-byte aligned) goes to the global scratch [P, M,
//    ldn] by one bulk asynchronous copy (cp.async.bulk, the TMA bulk path),
//    waited on (.read) one step later; all are drained before the
//    traceback;
//  - the traceback by the team's first warp, 32 cells of the current run a
//    round (dp_common.cuh traceback_warp), over the streamed rows through
//    L2; a cell of a group that was not computed (out of the band) is one
//    the walk reaches only in E mode from the right or F mode from below,
//    and its byte is made, as C stores it: the continuation bits of E (left
//    of the band, not at column 0) or of F (right of it, not at row 0);
//  - several problems per block: 8 one-warp teams per block at N <= 128,
//    256 / T teams otherwise.
#include <cstdint>

#include "dp_common.cuh"

namespace {

using namespace dp;

// Shared memory of one team, in bytes (a multiple of 128, so every team's
// rows stay aligned for the bulk copies): the direction-row double buffer
// (2 x ldr), the global score cell and the stop flag, per warp the E-scan
// totals, the last H~ and H of the warp's last lane and the row-max key,
// and the two chunk-carry slots of a WIDE row (4 ints each).
__host__ __device__ inline int team_smem_bytes(int ldr, int W) {
  return (2 * ldr + 64 + W * 24 + 127) / 128 * 128;
}

// A chunk-carry slot: H(i-1) and H~(i) of the chunk's last column, and the
// E prefix maxima after it.
constexpr int CY_HD = 0, CY_H0 = 1, CY_RUN1 = 2, CY_RUN2 = 3;
constexpr int CPT = 4;       // columns per thread (a group)
constexpr int WIDE_T = 256;  // threads of a WIDE team: chunks of WIDE_T x CPT columns
constexpr long long LANE_SPAN = 4294967296LL;  // 2^32: key = h * 2^32 + (INT_MAX - j)

__device__ __forceinline__ long long max64(long long a, long long b) { return a > b ? a : b; }

// WIDE: rows of more than one chunk of T * CPT columns, walked chunk by
// chunk with the state in `carry` [P, 3, ldn] int32 (F1, F2, H of the row
// above); otherwise the whole row in registers (carry unused).
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? WIDE_T : 256, 3)
    dp_fused_v2_kernel(const int* __restrict__ q, const int* __restrict__ t,
                       const int* __restrict__ meta_in, int* __restrict__ runs,
                       int* __restrict__ meta_out, unsigned char* __restrict__ dirs,
                       int* __restrict__ carry, int P, int M, int N, int ldn, int R, Scores s,
                       int zdrop, int is_global, int T, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = T >> 5;
  const int ldr = T * CPT;
  const int team = threadIdx.x / T;
  const int ti = threadIdx.x - team * T;  // thread in team
  const int lane = ti & 31, wi = ti >> 5;  // lane, warp in team
  unsigned char* base = smem_raw + static_cast<size_t>(team) * team_smem_bytes(ldr, W);
  unsigned char* dbuf = base;                                       // [2][ldr]
  int* s_scr = reinterpret_cast<int*>(base + 2 * ldr);              // [1]
  volatile int* s_stop = s_scr + 1;                                 // [1]
  int* x_tot1 = reinterpret_cast<int*>(base + 2 * ldr + 32);        // [W]
  int* x_tot2 = x_tot1 + W;                                         // [W]
  int* x_h0 = x_tot2 + W;                                           // [W]
  int* x_h = x_h0 + W;                                              // [W]
  long long* x_key = reinterpret_cast<long long*>(x_h + W);         // [W]
  int* cy = reinterpret_cast<int*>(x_key + W);                      // [2][4] (WIDE)

  const int p = blockIdx.x * G + team;
  if (ti == 0) {
    *s_scr = NEG;
    *s_stop = 0;
  }
  __syncthreads();
  if (p >= P) return;

  const int bar_id = 1 + team;
  const int m = meta_in[p * 4 + 0], n = meta_in[p * 4 + 1];
  const int w = meta_in[p * 4 + 2], tb_last = meta_in[p * 4 + 3];
  const bool ext_book = !(is_global && zdrop < 0);
  const int* qp = q + static_cast<size_t>(p) * M;
  const int* tp = t + static_cast<size_t>(p) * N;
  int* rp = runs + static_cast<size_t>(p) * R;
  unsigned char* drows = dirs + static_cast<size_t>(p) * M * ldn;
  for (int k = ti; k < R; k += T) rp[k] = 0;
  const int cl = ti * CPT;  // this thread's first column within a chunk
  int* sf1 = WIDE ? carry + static_cast<size_t>(p) * 3 * ldn : nullptr;
  int* sf2 = sf1 + ldn;
  int* sh = sf2 + ldn;

  // this thread's columns: target codes (one byte each) and F1 / F2 / H state
  // (for WIDE, of the current chunk, loaded from and stored to `carry`)
  int tcw = 0;
  int f1[CPT], f2[CPT], h[CPT], h0[CPT];
  auto load_targets = [&](int c0) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = c0 + k;
      const int c = j < N ? tp[j] : 4;
      if (k == 0) tcw = 0;
      tcw |= (c & 0xff) << (8 * k);
    }
  };
  if (!WIDE) load_targets(cl);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    f1[k] = NEG;
    f2[k] = NEG;
    h[k] = NEG;
  }
  Book book(is_global);  // max-cell book (team leader)
  long long rbest = LLONG_MIN;  // the row's best key over its chunks (leader)
  const int nn = min(n, N);
  // skipping out-of-band groups needs a traceback that starts in the band
  const bool skip_ok = !is_global || abs(m - n) <= w;
  // whether the group of CPT columns from c holds a cell of row r's band
  // (every group does where nothing is skipped)
  auto covers = [&](int r, int c) {
    return !skip_ok || (c + CPT - 1 >= max(0, r - w) && c <= min(nn - 1, r + w));
  };
  team_sync(bar_id, T);  // zero-filled runs and s_scr before any later write

  const int rows = min(m, M);
  int nstep = 0;  // (row, chunk) steps visited: the row slot's parity
  bool stop = false;
  int qnext = rows > 0 ? qp[0] : 0;  // the next row's query code, loaded a row ahead
  for (int i = 0; i < rows && !stop; ++i) {
    const int qc = qnext;
    if (i + 1 < rows) qnext = qp[i + 1];
    const int virt = i > 0 ? gap_cost(i, s) : NEG;
    // the row's chunks: from the 16-column boundary at or left of the band
    // to its last column (WIDE; all of the row where nothing is skipped)
    const int base = WIDE && skip_ok ? max(0, i - w) & ~15 : 0;
    const int last = skip_ok ? min(nn - 1, i + w) : N - 1;
    const int nck = !WIDE ? 1 : last >= base ? (last - base) / ldr + 1 : 0;
    rbest = LLONG_MIN;
    for (int ck = 0; ck < nck && !stop; ++ck) {
      const int cb = base + ck * ldr;  // the chunk's first column
      const int slot = nstep & 1;
      ++nstep;
      const int c0 = cb + cl;  // this thread's first column
      const bool act = covers(i, c0);
      const bool pact = i > 0 && covers(i - 1, c0);  // computed in the row above
      if (WIDE) {
        const bool in = pact && c0 < N;  // then all CPT columns lie within ldn
        if (act) load_targets(c0);
        const int4 z = make_int4(NEG, NEG, NEG, NEG);
        const int4 c = in ? *reinterpret_cast<const int4*>(sh + c0) : z;
        h[0] = c.x, h[1] = c.y, h[2] = c.z, h[3] = c.w;
        if (act) {
          const int4 x = in ? *reinterpret_cast<const int4*>(sf1 + c0) : z;
          const int4 y = in ? *reinterpret_cast<const int4*>(sf2 + c0) : z;
          f1[0] = x.x, f1[1] = x.y, f1[2] = x.z, f1[3] = x.w;
          f2[0] = y.x, f2[1] = y.y, f2[2] = y.z, f2[3] = y.w;
        }
      }
      if (act && !pact && i > 0) {  // F after rows 0 .. i-1 of a column right of the band
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int g = gap_cost(c0 + k, s);
          f1[k] = g - s.go1 - s.ge1 * i;
          f2[k] = g - s.go2 - s.ge2 * i;
        }
      }
      // ---- A: H~ of this thread's columns (F from the row above, diagonal
      // from H(i-1, j-1); the left neighbour's last H comes by shuffle or, at
      // a warp edge, through shared memory written before the last barrier,
      // for WIDE from `carry` or, at a chunk edge, the chunk-carry slot; NEG
      // where that neighbour's group was out of the band in the row above)
      const int hup_last = h[CPT - 1];  // H(i-1) of this thread's last column
      int hleft = __shfl_up_sync(FULL, hup_last, 1);
      if (lane == 0) {
        if (c0 == 0) {
          hleft = gap_cost(i, s);
        } else if (!WIDE) {
          hleft = x_h[wi - 1];
        } else if (wi == 0 && cb > base) {
          hleft = cy[(slot ^ 1) * 4 + CY_HD];
        } else {
          hleft = i > 0 && covers(i - 1, c0 - CPT) && c0 - 1 < N ? sh[c0 - 1] : NEG;
        }
      }
      // the F continuation bits, a bit per column, and a column's band test
      // made again where it is needed: fewer registers, more teams per SM
      uint32_t cfm1 = 0, cfm2 = 0;
      auto in_band = [&](int j) { return j < N && j < n && abs(i - j) <= w; };
      if (act) {
        int prev_old = hleft;  // H(i-1, j-1)
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int j = c0 + k;
          int h_up, diag;
          if (i == 0) {
            h_up = j > 0 ? gap_cost(j, s) : NEG;
            diag = j == 0 ? 0 : gap_cost(j, s);
          } else {
            h_up = h[k];
            diag = j > 0 ? (j < N ? prev_old : NEG) : gap_cost(i, s);
          }
          prev_old = h[k];
          const int tc = (tcw >> (8 * k)) & 0xff;
          int hd;
          bool c1, c2;
          cell_f(h_up, diag, qc, tc, in_band(j), s, f1[k], f2[k], c1, c2, hd, h0[k]);
          cfm1 |= static_cast<uint32_t>(c1) << k;
          cfm2 |= static_cast<uint32_t>(c2) << k;
          h[k] = hd;  // H before the E terms; the final H replaces it in C
        }
      } else {
#pragma unroll
        for (int k = 0; k < CPT; ++k) h0[k] = NEG;
      }
      // ---- B: the E prefix maximum. v_p(j) = H~(i, j-1) + e_p (j-1), and at
      // j = 0 the virtual column's value; a thread contributes its columns'
      // v except, for a warp's lane 0, the warp's first column (which needs
      // the previous warp's last H~ and is added after the barrier); a
      // skipped group's v are dominated by the virtual column's
      const int h0left_w = __shfl_up_sync(FULL, h0[CPT - 1], 1);  // lanes > 0
      int tot1 = INT_MIN, tot2 = INT_MIN;
      if (act) {
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int j = c0 + k;
          if (k == 0 && lane == 0) continue;
          const int hl = k == 0 ? h0left_w : h0[k - 1];
          tot1 = __viaddmax_s32(hl, s.ge1 * (j - 1), tot1);
          tot2 = __viaddmax_s32(hl, s.ge2 * (j - 1), tot2);
        }
      }
      int inc1 = tot1, inc2 = tot2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y1 = __shfl_up_sync(FULL, inc1, o);
        const int y2 = __shfl_up_sync(FULL, inc2, o);
        if (lane >= o) {
          inc1 = max(inc1, y1);
          inc2 = max(inc2, y2);
        }
      }
      int exc1 = __shfl_up_sync(FULL, inc1, 1), exc2 = __shfl_up_sync(FULL, inc2, 1);
      if (lane == 0) exc1 = exc2 = INT_MIN;
      if (lane == 31) {
        x_tot1[wi] = inc1;
        x_tot2[wi] = inc2;
        x_h0[wi] = h0[CPT - 1];
      }
      team_sync(bar_id, T);  // B1: warp totals and edge H~ visible
      if (*s_stop) {  // the leader's book dropped the problem at the row above
        stop = true;
        break;
      }
      // prefix over the chunks and warps before this one; F = a warp's
      // first-column v. The row's first chunk starts from the virtual column
      // (where it starts past column 0, every column left of it is left of
      // the band, so the virtual column's value is the prefix and H~ there
      // is NEG), a later one from the carry of the chunk before it.
      int g1 = INT_MIN, g2 = INT_MIN, open0 = virt;
      if (WIDE && cb > 0) {
        if (cb > base) {
          const int* c = cy + (slot ^ 1) * 4;
          g1 = c[CY_RUN1];
          g2 = c[CY_RUN2];
          open0 = c[CY_H0];
        } else {
          g1 = virt - s.ge1;
          g2 = virt - s.ge2;
          open0 = NEG;
        }
      }
      int fw1 = open0 + s.ge1 * (cb - 1), fw2 = open0 + s.ge2 * (cb - 1);
      for (int k = 0; k < wi; ++k) {
        g1 = max(g1, max(fw1, x_tot1[k]));
        g2 = max(g2, max(fw2, x_tot2[k]));
        const int cw = cb + (k + 1) * 32 * CPT;  // first column of warp k + 1
        fw1 = x_h0[k] + s.ge1 * (cw - 1);
        fw2 = x_h0[k] + s.ge2 * (cw - 1);
      }
      // a(c0 - 1), v(c0) and H~(i, c0 - 1) of this thread's first column
      int run1, run2, v01, v02, open_left;
      if (lane == 0) {
        run1 = g1;
        run2 = g2;
        v01 = fw1;
        v02 = fw2;
        open_left = wi == 0 ? open0 : x_h0[wi - 1];
      } else {
        run1 = max(g1, max(fw1, exc1));
        run2 = max(g2, max(fw2, exc2));
        open_left = h0left_w;
        v01 = h0left_w + s.ge1 * (c0 - 1);
        v02 = h0left_w + s.ge2 * (c0 - 1);
      }
      // ---- C: E terms, H, direction bytes; the row maximum for the book
      int hbest = INT_MIN, jbest = INT_MAX;  // this thread's, at its first column
      if (act) {
        uint32_t dword = 0;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int j = c0 + k;
          const int open_src = k == 0 ? open_left : h0[k - 1];
          const int v1 = k == 0 ? v01 : h0[k - 1] + s.ge1 * (j - 1);
          const int v2 = k == 0 ? v02 : h0[k - 1] + s.ge2 * (j - 1);
          const bool valid = in_band(j);
          uint32_t byte;
          const int hv = cell_h(j, v1, v2, open_src, h[k], f1[k], f2[k], (cfm1 >> k) & 1,
                                (cfm2 >> k) & 1, valid, s, run1, run2, byte);
          h[k] = hv;
          dword |= byte << (8 * k);
          if (valid && i == m - 1 && j == n - 1) *s_scr = hv;  // global score cell
          const int hm = valid ? hv : NEG;
          if (ext_book && j < N && hm > hbest) {
            hbest = hm;
            jbest = j;
          }
        }
        *reinterpret_cast<uint32_t*>(dbuf + slot * ldr + cl) = dword;
      } else {
#pragma unroll
        for (int k = 0; k < CPT; ++k) h[k] = NEG;  // out of the band in this row
      }
      if (ext_book) {  // the warp's key (LLONG_MIN where it holds no column)
        const int wmax = __reduce_max_sync(FULL, hbest);
        const int wj = __reduce_min_sync(FULL, hbest == wmax ? jbest : INT_MAX);
        if (lane == 0) x_key[wi] = static_cast<long long>(wmax) * LANE_SPAN + (INT_MAX - wj);
      }
      if (!WIDE && lane == 31) x_h[wi] = h[CPT - 1];
      if (WIDE) {
        if (act && c0 < N) {
          *reinterpret_cast<int4*>(sf1 + c0) = make_int4(f1[0], f1[1], f1[2], f1[3]);
          *reinterpret_cast<int4*>(sf2 + c0) = make_int4(f2[0], f2[1], f2[2], f2[3]);
          *reinterpret_cast<int4*>(sh + c0) = make_int4(h[0], h[1], h[2], h[3]);
        }
        if (ti == T - 1) {  // the next chunk's carry: the E prefix and the edge column
          int* c = cy + slot * 4;
          c[CY_HD] = hup_last;
          c[CY_H0] = h0[CPT - 1];
          c[CY_RUN1] = run1;
          c[CY_RUN2] = run2;
        }
      }
      fence_async_smem();
      team_sync(bar_id, T);  // B2: the chunk's bytes, keys, edge H and carry complete

      if (ti == 0) {
        // the bytes of the chunk's groups in the band, widened to 16 bytes
        const int end = min(cb + ldr, ldn);
        int a = cb, b = end;
        if (skip_ok) {
          a = max(cb, max(0, i - w) / CPT * CPT) & ~15;
          b = min(end, (min(nn - 1, i + w) / CPT * CPT + CPT + 15) & ~15);
        }
        if (a < b)
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                       ::"l"(drows + static_cast<size_t>(i) * ldn + a),
                       "r"(saddr(dbuf + slot * ldr + (a - cb))), "r"(b - a) : "memory");
        // one group a step, empty where nothing is stored: the slot of step
        // - 1 is written again at step + 1, and its copy must have read it
        // (the copy of this step may stay in flight)
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        bulk_wait_read1();
        if (ext_book) {
          long long best = x_key[0];
          for (int k = 1; k < W; ++k) best = max64(best, x_key[k]);
          rbest = max64(rbest, best);
        }
      }
    }
    if (ti == 0 && !stop && ext_book) {
      book.row(i, static_cast<int>(rbest >> 32),
               INT_MAX - static_cast<int>(rbest & 0xffffffffLL), m, nn, w, zdrop, s.ge1);
      if (!is_global && book.dropped) *s_stop = 1;  // read by the team after its next B1
    }
  }
  if (ti >= 32) return;
  if (ti == 0) bulk_wait_all();  // every direction row is in global memory
  __syncwarp();

  // ---- traceback by the first warp, up to 32 cells a round, over the
  // streamed rows; a cell of a group out of the band in its row is made
  int si, sj;
  tb_start(is_global, tb_last, m, n, book, si, sj);  // the leader's book
  si = __shfl_sync(FULL, si, 0);
  sj = __shfl_sync(FULL, sj, 0);
  Runs out{rp, R, ti == 0};
  traceback_warp(
      [&](int ii, int jk) -> int {
        const int c = jk - jk % CPT;
        if (skip_ok && c + CPT - 1 < max(0, ii - w)) return jk == 0 ? 0 : CONT_E1 | CONT_E2;
        if (skip_ok && c > min(nn - 1, ii + w)) return ii > 0 ? CONT_F1 | CONT_F2 : 0;
        return __ldcg(drows + static_cast<size_t>(ii) * ldn + jk);
      },
      si, sj, out, lane);
  if (ti == 0) write_meta(meta_out, P, p, out, is_global, ext_book, *s_scr, book);
}

}  // namespace

// Launch shape: up to 1,024 columns a team of T = ceil(N / 4) threads
// (rounded up to a warp) holds the row in registers, 4 columns a thread, G
// teams per block; past 1,024 columns a team of WIDE_T threads walks each
// row in chunks from its band's left edge (WIDE). ldn: the row stride
// of `dirs` [P, M, ldn] in bytes (a multiple of 16, >= N); a row's bytes
// outside its band's groups are not written. carry: [P, 3, ldn] int32 where
// N > 1,024 (the wrapper sizes it with ma_dp_fused_v2_carry_ints), else
// unused.
extern "C" long long ma_dp_fused_v2_carry_ints(int N, int ldn) {
  return N > 256 * CPT ? 3LL * ldn : 0;
}

extern "C" int ma_dp_fused_v2(const void* q, const void* t, const void* meta_in, void* runs,
                              void* meta_out, void* dirs, void* carry, int P, int M, int N,
                              int ldn, int R, int match, int mismatch, int go1, int ge1, int go2,
                              int ge2, int zdrop, int is_global, void* stream) {
  const bool wide = N > 256 * CPT;
  const int T = wide ? WIDE_T : ((N + CPT - 1) / CPT + 31) / 32 * 32;
  if (ldn % 16 != 0 || ldn < N || (!wide && ldn > T * CPT) || (wide && carry == nullptr))
    return cudaErrorInvalidValue;
  const int G = T == 32 ? 8 : max(1, 256 / T);
  const size_t smem = static_cast<size_t>(G) * team_smem_bytes(T * CPT, T / 32);
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  const int blocks = (P + G - 1) / G;
  auto args = [&](auto kernel) {
    kernel<<<blocks, G * T, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q), static_cast<const int*>(t),
        static_cast<const int*>(meta_in), static_cast<int*>(runs),
        static_cast<int*>(meta_out), static_cast<unsigned char*>(dirs),
        static_cast<int*>(carry), P, M, N, ldn, R, s, zdrop, is_global, T, G);
  };
  if (wide) {
    args(dp_fused_v2_kernel<true>);
  } else {
    args(dp_fused_v2_kernel<false>);
  }
  return ma_launch_status();
}
