// Kernel C': banded 2-piece affine-gap DP with z-drop and in-kernel
// traceback, kernel C's contract (runs [P, R], meta [8, P]) for targets up
// to N = 4096 columns.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_fused.py `_kernel_v2` (entry
// `banded_align_runs` under MA_TPU_DP_V2=1). Recurrences, boundary values,
// direction bytes, tie precedence, max-cell book and traceback are kernel
// C's (csrc/dp_fused.cu), so every output equals C's and the plain version
// ma_tpu_torch/ops/dp_fused.py `banded_align_runs_plain`.
//
// What bounds it on the H100: rows are dependent one after another, and
// each row's E term is a prefix maximum along the row, so a problem costs
// M rows of (cells / threads) integer work plus a row-wide scan; and each
// row's N direction bytes have to leave the chip for the traceback (a
// 256 x 4096 problem holds 1 MB of them, far above shared memory). The
// design, after _kernel_v2's ideas:
//  - static column tiles, no band-window skipping: a team of T <= 256
//    threads owns a problem, each thread CPT consecutive columns (CPT = 4,
//    8 or 16), and a row is one pass over them;
//  - state and book in registers: a thread keeps its columns' H, F1, F2
//    and target codes in registers from row to row; the max cell, z-drop
//    and last-row book live in the team leader's registers. Per row the
//    team exchanges only warp totals of the E scan and the H / H~ values at
//    warp edges through shared memory: two team barriers per row (a
//    __syncwarp for a one-warp team, a named barrier otherwise);
//  - direction rows streamed out: each row's bytes are formed in one slot
//    of a double-buffered shared-memory row and sent to the global scratch
//    [P, M, ldn] by one bulk asynchronous copy (cp.async.bulk shared ->
//    global, the TMA bulk path), waited on (.read) one row later, before
//    the slot is written again; all copies are drained before the traceback;
//  - traceback with a one-row prefetch: the leader walks the path as kernel
//    C's thread 0 does, with each visited row brought back into the other
//    shared-memory slot by a bulk copy (mbarrier completion) while it walks
//    the current one;
//  - several problems per block: 8 one-warp teams per block at N <= 128,
//    256 / T teams otherwise.
// The cell step (kept without DPX here), the book, the traceback step and
// the bulk stores are kernel C's too (csrc/dp_common.cuh).
#include <cstdint>

#include "dp_common.cuh"

namespace {

using namespace dp;

// Shared memory of one team, in bytes (a multiple of 128, so every team's
// rows stay aligned for the bulk copies): the direction-row double buffer
// (2 x ldr), two mbarriers, the global score cell and, per warp, the E-scan
// totals, the last H~ and H of the warp's last lane, and the row-max key.
__host__ __device__ inline int team_smem_bytes(int ldr, int W) {
  return (2 * ldr + 32 + W * 24 + 127) / 128 * 128;
}

__device__ __forceinline__ long long max64(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* sdst, const void* gsrc, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(saddr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(saddr(sdst)), "l"(gsrc), "r"(bytes), "r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}" ::"r"(saddr(bar)), "r"(parity) : "memory");
}

// The traceback over direction rows in global memory ([M, ldn] of one
// problem, every row written): each visited row is brought into one of two
// shared-memory slots (dbuf, dbuf + ldr) by a bulk copy completing on
// mbar[slot], the row above prefetched into the other slot meanwhile.
__device__ inline void traceback_streamed(const unsigned char* drow_g, int ldn, unsigned char* dbuf,
                                   int ldr, uint64_t* mbar, int si, int sj, Runs& out) {
  int i = si, jj = sj, mode = TB_H;
  bool done = si < 0 || sj < 0;
  uint32_t parity[2] = {0, 0};
  int pending = -1;  // slot of an issued, unwaited row load
  if (!done) {
    bulk_load(dbuf + (si & 1) * ldr, drow_g + static_cast<size_t>(si) * ldn, ldn, &mbar[si & 1]);
    pending = si & 1;
  }
  for (int row = si; row >= 0 && !done; --row) {
    const int sl = row & 1;
    int next = -1;
    if (row >= 1) {  // prefetch the row above into the other slot
      bulk_load(dbuf + (sl ^ 1) * ldr, drow_g + static_cast<size_t>(row - 1) * ldn, ldn,
                &mbar[sl ^ 1]);
      next = sl ^ 1;
    }
    mbar_wait(&mbar[sl], parity[sl]);
    parity[sl] ^= 1;
    pending = next;
    const unsigned char* drow = dbuf + sl * ldr;
    while (!done && i == row) done = tb_step(drow[jj], i, jj, mode, out);
  }
  if (pending >= 0) mbar_wait(&mbar[pending], parity[pending]);  // no copy left in flight
  tb_finish(si, i, jj, out);
}

template <int CPT>
__global__ void __launch_bounds__(256)
    dp_fused_v2_kernel(const int* __restrict__ q, const int* __restrict__ t,
                       const int* __restrict__ meta_in, int* __restrict__ runs,
                       int* __restrict__ meta_out, unsigned char* __restrict__ dirs, int P,
                       int M, int N, int ldn, int R, Scores s, int zdrop, int is_global, int T,
                       int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = T >> 5;
  const int ldr = T * CPT;
  const int team = threadIdx.x / T;
  const int ti = threadIdx.x - team * T;  // thread in team
  const int lane = ti & 31, wi = ti >> 5;  // lane, warp in team
  unsigned char* base = smem_raw + static_cast<size_t>(team) * team_smem_bytes(ldr, W);
  unsigned char* dbuf = base;                                       // [2][ldr]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(base + 2 * ldr);     // [2]
  int* s_scr = reinterpret_cast<int*>(base + 2 * ldr + 16);         // [1]
  int* x_tot1 = reinterpret_cast<int*>(base + 2 * ldr + 32);        // [W]
  int* x_tot2 = x_tot1 + W;                                         // [W]
  int* x_h0 = x_tot2 + W;                                           // [W]
  int* x_h = x_h0 + W;                                              // [W]
  long long* x_key = reinterpret_cast<long long*>(x_h + W);         // [W]

  const int p = blockIdx.x * G + team;
  if (ti == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    *s_scr = NEG;
  }
  __syncthreads();
  if (p >= P) return;

  const int bar_id = 1 + team;
  const int m = meta_in[p * 4 + 0], n = meta_in[p * 4 + 1];
  const int w = meta_in[p * 4 + 2], tb_last = meta_in[p * 4 + 3];
  const bool ext_book = !(is_global && zdrop < 0);
  const int* qp = q + static_cast<size_t>(p) * M;
  int* rp = runs + static_cast<size_t>(p) * R;
  for (int k = ti; k < R; k += T) rp[k] = 0;
  const int c0 = ti * CPT;  // this thread's first column

  // this thread's columns: target codes (packed bytes) and F1 / F2 / H state
  int tcw[CPT / 4];
  int f1[CPT], f2[CPT], h[CPT], h0[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = c0 + k;
    const int c = j < N ? t[static_cast<size_t>(p) * N + j] : 4;
    if (k % 4 == 0) tcw[k / 4] = 0;
    tcw[k / 4] |= (c & 0xff) << (8 * (k % 4));
    f1[k] = NEG;
    f2[k] = NEG;
    h[k] = NEG;
  }
  Book book(is_global);  // max-cell book (team leader)
  const int nn = min(n, N);
  team_sync(bar_id, T);  // zero-filled runs and s_scr before any later write

  const int rows = min(m, M);
  for (int i = 0; i < rows; ++i) {
    const int slot = i & 1;
    const int qc = qp[i];
    // ---- A: H~ of this thread's columns (F from the row above, diagonal
    // from H(i-1, j-1); the left neighbour's last H comes by shuffle or,
    // at a warp edge, through shared memory written before the last barrier)
    int hleft = __shfl_up_sync(FULL, h[CPT - 1], 1);
    if (lane == 0) hleft = wi == 0 ? gap_cost(i, s) : x_h[wi - 1];
    bool valid[CPT], cf1[CPT], cf2[CPT];
    {
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
        const int tc = (tcw[k / 4] >> (8 * (k % 4))) & 0xff;
        valid[k] = j < N && j < n && abs(i - j) <= w;
        int hd;
        cell_f<false>(h_up, diag, qc, tc, valid[k], s, f1[k], f2[k], cf1[k], cf2[k], hd, h0[k]);
        h[k] = hd;  // H before the E terms; the final H replaces it in C
      }
    }
    // ---- B: the E prefix maximum. v_p(j) = H~(i, j-1) + e_p (j-1), and at
    // j = 0 the virtual column's value; a thread contributes its columns'
    // v except, for a warp's lane 0, the warp's first column (which needs
    // the previous warp's last H~ and is added after the barrier)
    const int virt = i > 0 ? gap_cost(i, s) : NEG;
    const int h0left_w = __shfl_up_sync(FULL, h0[CPT - 1], 1);  // lanes > 0
    int tot1 = INT_MIN, tot2 = INT_MIN;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = c0 + k;
      if (k == 0 && lane == 0) continue;
      const int hl = k == 0 ? h0left_w : h0[k - 1];
      tot1 = max(tot1, hl + s.ge1 * (j - 1));
      tot2 = max(tot2, hl + s.ge2 * (j - 1));
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
    // prefix over the warps before this one; F = a warp's first-column v
    int g1 = INT_MIN, g2 = INT_MIN, fw1 = virt - s.ge1, fw2 = virt - s.ge2;
    for (int k = 0; k < wi; ++k) {
      g1 = max(g1, max(fw1, x_tot1[k]));
      g2 = max(g2, max(fw2, x_tot2[k]));
      const int cw = (k + 1) * 32 * CPT;  // first column of warp k + 1
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
      open_left = wi == 0 ? virt : x_h0[wi - 1];
    } else {
      run1 = max(g1, max(fw1, exc1));
      run2 = max(g2, max(fw2, exc2));
      open_left = h0left_w;
      v01 = h0left_w + s.ge1 * (c0 - 1);
      v02 = h0left_w + s.ge2 * (c0 - 1);
    }
    // ---- C: E terms, H, direction bytes; the row-max key for the book
    long long key = LLONG_MIN;
    uint32_t dword = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = c0 + k;
      const int open_src = k == 0 ? open_left : h0[k - 1];
      const int v1 = k == 0 ? v01 : h0[k - 1] + s.ge1 * (j - 1);
      const int v2 = k == 0 ? v02 : h0[k - 1] + s.ge2 * (j - 1);
      uint32_t byte;
      const int hv = cell_h<false>(j, v1, v2, open_src, h[k], f1[k], f2[k], cf1[k], cf2[k], valid[k],
                            s, run1, run2, byte);
      h[k] = hv;
      dword |= byte << (8 * (k % 4));
      if (k % 4 == 3) {
        *reinterpret_cast<uint32_t*>(dbuf + slot * ldr + c0 + k - 3) = dword;
        dword = 0;
      }
      if (valid[k] && i == m - 1 && j == n - 1) *s_scr = hv;  // global score cell
      if (ext_book && j < N) {
        const int hm = valid[k] ? hv : NEG;
        key = max64(key, static_cast<long long>(hm) * 65536 + (65535 - j));
      }
    }
    if (ext_book) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) key = max64(key, __shfl_down_sync(FULL, key, o));
      if (lane == 0) x_key[wi] = key;
    }
    if (lane == 31) x_h[wi] = h[CPT - 1];
    fence_async_smem();
    team_sync(bar_id, T);  // B2: the row's bytes, keys and edge H complete

    if (ti == 0) {
      bulk_store(dirs + (static_cast<size_t>(p) * M + i) * ldn, dbuf + slot * ldr, ldn);
      if (ext_book) {
        long long best = x_key[0];
        for (int k = 1; k < W; ++k) best = max64(best, x_key[k]);
        book.row(i, static_cast<int>(best >> 16), 65535 - static_cast<int>(best & 65535), m, nn,
                 w, zdrop, s.ge1);
      }
      // the slot of row i - 1 is written again at row i + 1: its copy must
      // have read it (the copy of row i may stay in flight)
      bulk_wait_read1();
    }
  }
  if (ti != 0) return;
  bulk_wait_all();  // every direction row is in global memory

  // ---- traceback (team leader), one cell per step, as kernel C's; the
  // path's rows come back into the two shared-memory slots, one row ahead
  int si, sj;
  tb_start(is_global, tb_last, m, n, book, si, sj);
  Runs out{rp, R};
  traceback_streamed(dirs + static_cast<size_t>(p) * M * ldn, ldn, dbuf, ldr, mbar, si, sj, out);
  write_meta(meta_out, P, p, out, is_global, ext_book, *s_scr, book);
}

}  // namespace

// Launch shape: CPT columns per thread (4, 8 or 16, the smallest that keeps
// a team at <= 256 threads), a team of T threads per problem, G teams per
// block. ldn: the row stride of `dirs` [P, M, ldn] in bytes (a multiple of
// 16, >= N).
extern "C" int ma_dp_fused_v2(const void* q, const void* t, const void* meta_in, void* runs,
                              void* meta_out, void* dirs, int P, int M, int N, int ldn, int R,
                              int match, int mismatch, int go1, int ge1, int go2, int ge2,
                              int zdrop, int is_global, void* stream) {
  int cpt = 4;
  auto team_threads = [&](int c) { return ((N + c - 1) / c + 31) / 32 * 32; };
  while (cpt < 16 && team_threads(cpt) > 256) cpt *= 2;
  const int T = team_threads(cpt);
  if (T > 256 || ldn % 16 != 0 || ldn < N || ldn > T * cpt) return cudaErrorInvalidValue;
  const int G = T == 32 ? 8 : (T >= 256 ? 1 : 256 / T);
  const size_t smem = static_cast<size_t>(G) * team_smem_bytes(T * cpt, T / 32);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  const int blocks = (P + G - 1) / G;
  auto args = [&](auto kernel) {
    kernel<<<blocks, G * T, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q), static_cast<const int*>(t),
        static_cast<const int*>(meta_in), static_cast<int*>(runs),
        static_cast<int*>(meta_out), static_cast<unsigned char*>(dirs), P, M, N, ldn, R, s,
        zdrop, is_global, T, G);
  };
  if (cpt == 4) {
    args(dp_fused_v2_kernel<4>);
  } else if (cpt == 8) {
    args(dp_fused_v2_kernel<8>);
  } else {
    args(dp_fused_v2_kernel<16>);
  }
  return ma_launch_status();
}
