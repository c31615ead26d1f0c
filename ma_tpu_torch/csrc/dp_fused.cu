// Kernel C: banded 2-piece affine-gap DP with z-drop, forward sweep and
// traceback fused in one kernel.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_fused.py `_kernel` (entry
// `banded_align_runs`, the kswcpp equivalent). Same recurrences, boundary
// conventions, direction-byte layout and tie precedence as
// ma_tpu/ops/dp_rows.py (the plain version), so CIGARs are identical:
//   F (query gap) carries from row i-1; E (reference gap) is a max-plus
//   prefix over the row: E_p(i,j) = cummax_{k<j}(H~(i,k) + e_p k) - o_p - e_p j
//   with H~ = max(diag, F1, F2); ties prefer diag, E1, F1, E2, F2; the max
//   cell is tracked per row with the anti-diagonal tie order; z-drop per row.
// Output: merged CIGAR runs (op | len << 2, back to front, capacity R with an
// overflow flag) and meta [8, P] (n_runs, score, max_i, max_j, zdropped,
// run_overflow, lastrow_max, lastrow_arg).
//
// What bounds it on the H100: the row recurrence is sequential in i and its
// E term is a prefix maximum along the row, so each row costs a block-wide
// scan (two syncs) on top of ~30 integer ops per cell; problems are small
// (M <= 256 rows, N <= 768 columns), so the kernel is latency-bound per
// block and wants many problems in flight. Design: one block per problem,
// one thread per column of the row; a thread keeps its column's F1/F2 state
// and previous-row H in registers, shares H and H~ through shared memory,
// and resolves the E prefix maximum with a warp-shuffle scan plus a scan of
// the warp totals (the Pallas kernel's lane cummax). The Pallas kernel kept
// the whole [M, PB, N] direction plane in VMEM; one 256 x 768 plane is
// 196 KB, so here directions go to a per-problem global scratch [P, M, N]
// (allocated by the wrapper) and the traceback (thread 0, one cell per
// step, <= M + N steps) reads them back from L2. DPX intrinsics and 16-bit
// lanes are later work.
#include "common.cuh"

namespace {

constexpr int NEG = -(1 << 30);
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
constexpr int TB_H = 0, TB_E1 = 1, TB_E2 = 2, TB_F1 = 3, TB_F2 = 4;
constexpr int CONT_E1 = 0x08, CONT_F1 = 0x10, CONT_E2 = 0x20, CONT_F2 = 0x40;

struct Scores {
  int match, mismatch, go1, ge1, go2, ge2;
};

__device__ __forceinline__ int gap_cost(int k, const Scores& s) {
  return max(-(s.go1 + k * s.ge1), -(s.go2 + k * s.ge2));
}

// Block-wide inclusive prefix maximum of two values per thread (blockDim.x
// is a multiple of 32). wa/wb: shared [32].
__device__ void block_cummax2(int& a, int& b, int* wa, int* wb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, a, o);
    const int yb = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) {
      a = max(a, ya);
      b = max(b, yb);
    }
  }
  if (lane == 31) {
    wa[warp] = a;
    wb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int ta = lane < nw ? wa[lane] : INT_MIN;
    int tb = lane < nw ? wb[lane] : INT_MIN;
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, ta, o);
      const int yb = __shfl_up_sync(0xffffffffu, tb, o);
      if (lane >= o) {
        ta = max(ta, ya);
        tb = max(tb, yb);
      }
    }
    wa[lane] = ta;
    wb[lane] = tb;
  }
  __syncthreads();
  if (warp > 0) {
    a = max(a, wa[warp - 1]);
    b = max(b, wb[warp - 1]);
  }
}

// Block-wide maximum; the result is valid in thread 0. w: shared [32].
__device__ long long block_max64(long long v, long long* w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, v, o);
    v = y > v ? y : v;
  }
  if (lane == 0) w[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) v = w[k] > v ? w[k] : v;
  }
  return v;
}

// Run packer of the traceback: append (or merge into the last) run.
struct Runs {
  int* runs;
  int R;
  int cnt = 0;
  int last = -1;
  bool over = false;
  __device__ void emit(int op, int ln) {
    if (ln <= 0) return;
    if (last == op && cnt > 0) {
      runs[cnt - 1] += ln * 4;
      return;
    }
    if (cnt >= R) {  // no room for a new run: flag, keep `last`
      over = true;
      return;
    }
    runs[cnt++] = ln * 4 + op;
    last = op;
  }
};

__global__ void __launch_bounds__(1024)
    dp_fused_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    const int* __restrict__ meta_in, int* __restrict__ runs,
                    int* __restrict__ meta_out, unsigned char* __restrict__ dirs,
                    int P, int M, int N, int R, Scores s, int zdrop, int is_global) {
  extern __shared__ int smem[];
  int* hp = smem;        // [N] H of the previous row
  int* h0s = hp + N;     // [N] H~ of this row
  int* a1s = h0s + N;    // [N] prefix max of v1
  int* a2s = a1s + N;    // [N] prefix max of v2
  int* wa = a2s + N;     // [32] scan scratch
  int* wb = wa + 32;     // [32]
  long long* wr = reinterpret_cast<long long*>(wb + 32);  // [32] reduce scratch
  __shared__ int s_dropped, s_scr;

  const int p = blockIdx.x;
  const int j = threadIdx.x;
  const bool col = j < N;
  const int m = meta_in[p * 4 + 0], n = meta_in[p * 4 + 1];
  const int w = meta_in[p * 4 + 2], tb_last = meta_in[p * 4 + 3];
  const bool ext_book = !(is_global && zdrop < 0);
  const int* qp = q + static_cast<size_t>(p) * M;
  const int tc = col ? t[static_cast<size_t>(p) * N + j] : 4;
  unsigned char* dp = dirs + static_cast<size_t>(p) * M * N;
  int* rp = runs + static_cast<size_t>(p) * R;
  for (int k = j; k < R; k += blockDim.x) rp[k] = 0;
  if (j == 0) {
    s_dropped = 0;
    s_scr = NEG;
  }
  // max-cell book (thread 0)
  int gmax = is_global ? NEG : 0, gi = -1, gj = -1, gd = 1 << 30;
  int lrmax = NEG, lrarg = -1;
  // this column's state from the previous row
  int h_prev = NEG, f1p = NEG, f2p = NEG;
  const int nn = min(n, N);
  __syncthreads();

  const int rows = min(m, M);
  for (int i = 0; i < rows; ++i) {
    const int qc = qp[i];
    int h_up, diag;
    if (i == 0) {
      h_up = j > 0 ? gap_cost(j, s) : NEG;
      diag = j == 0 ? 0 : gap_cost(j, s);
    } else {
      h_up = h_prev;
      diag = j > 0 ? (col ? hp[j - 1] : NEG) : gap_cost(i, s);
    }
    const int t1 = f1p - s.ge1, t2 = h_up - (s.go1 + s.ge1);
    const int nf1 = max(t1, t2);
    const bool cf1 = t1 >= t2;
    const int t3 = f2p - s.ge2, t4 = h_up - (s.go2 + s.ge2);
    const int nf2 = max(t3, t4);
    const bool cf2 = t3 >= t4;
    const int sc = (qc >= 4 || tc >= 4) ? 0 : (qc == tc ? s.match : -s.mismatch);
    const int hd = diag + sc;
    const bool valid = col && j < n && abs(i - j) <= w;
    const int h0 = valid ? max(hd, max(nf1, nf2)) : NEG;
    if (col) h0s[j] = h0;
    __syncthreads();  // h0s complete; every read of hp (row i-1) done

    const int virt = i > 0 ? gap_cost(i, s) : NEG;
    int open_src = virt, v1 = INT_MIN, v2 = INT_MIN;
    if (col) {
      if (j > 0) open_src = h0s[j - 1];
      v1 = j == 0 ? virt - s.ge1 : h0s[j - 1] + s.ge1 * (j - 1);
      v2 = j == 0 ? virt - s.ge2 : h0s[j - 1] + s.ge2 * (j - 1);
    }
    block_cummax2(v1, v2, wa, wb);
    if (col) {
      a1s[j] = v1;
      a2s[j] = v2;
    }
    __syncthreads();  // prefix maxima complete

    const int e1 = v1 - s.go1 - s.ge1 * j;
    const int e2 = v2 - s.go2 - s.ge2 * j;
    const int e1p = (j == 0 || !col) ? NEG : a1s[j - 1] - s.go1 - s.ge1 * (j - 1);
    const int e2p = (j == 0 || !col) ? NEG : a2s[j - 1] - s.go2 - s.ge2 * (j - 1);
    const bool ce1 = e1p - s.ge1 >= open_src - (s.go1 + s.ge1);
    const bool ce2 = e2p - s.ge2 >= open_src - (s.go2 + s.ge2);
    int h = hd, src = 0;
    if (e1 > h) { h = e1; src = 1; }
    if (nf1 > h) { h = nf1; src = 2; }
    if (e2 > h) { h = e2; src = 3; }
    if (nf2 > h) { h = nf2; src = 4; }
    if (!valid) h = NEG;
    if (col) {
      dp[static_cast<size_t>(i) * N + j] = static_cast<unsigned char>(
          src | (ce1 ? CONT_E1 : 0) | (cf1 ? CONT_F1 : 0) | (ce2 ? CONT_E2 : 0) |
          (cf2 ? CONT_F2 : 0));
      hp[j] = h;
    }
    h_prev = h;
    f1p = nf1;
    f2p = nf2;
    if (valid && i == m - 1 && j == n - 1) s_scr = h;  // global score cell
    __syncthreads();  // hp holds row i; s_dropped stable for this row

    if (ext_book) {
      const int dropped = s_dropped;
      const int hm = (valid && !dropped) ? h : NEG;
      // max value, ties to the smallest column
      long long key = col ? static_cast<long long>(hm) * 2048 + (2047 - j) : LLONG_MIN;
      key = block_max64(key, wr);
      if (j == 0) {
        const int rmax = static_cast<int>(key >> 11);
        const int rarg = 2047 - static_cast<int>(key & 2047);
        if (i == m - 1) {
          lrmax = rmax;
          lrarg = rarg;
        }
        const bool upd = ((rmax > gmax) || (rmax == gmax && gi >= 0 && i + rarg < gd)) &&
                         !dropped && rmax > NEG;
        if (upd) {
          gmax = rmax;
          gi = i;
          gj = rarg;
          gd = i + rarg;
        }
        if (zdrop >= 0) {
          const int diff = abs((i - gi) - (rarg - gj));
          const bool has = nn >= 1 && i - w <= nn - 1 && gi >= 0;
          if (has && gmax - rmax > zdrop + diff * s.ge1) s_dropped = 1;
        }
      }
    }
  }
  __syncthreads();  // every direction byte is written
  if (j != 0) return;

  // ---- traceback (thread 0), one cell per step, as dp_rows' traceback
  int si, sj;
  if (is_global) {
    si = m - 1;
    sj = n - 1;
  } else if (tb_last != 0) {  // from the last row's best cell
    si = lrmax > NEG ? m - 1 : -1;
    sj = lrarg;
  } else {
    si = gi;
    sj = gj;
  }
  Runs out{rp, R};
  int i = si, jj = sj, mode = TB_H;
  bool done = si < 0;
  for (int step = 0; !done && step < M + N; ++step) {
    if (i < 0 || jj < 0) break;
    const int byte = dp[static_cast<size_t>(i) * N + jj];
    const int src = byte & 7;
    int e_mode = mode;
    if (mode == TB_H)
      e_mode = src == 1 ? TB_E1 : src == 3 ? TB_E2 : src == 2 ? TB_F1 : src == 4 ? TB_F2 : TB_H;
    const bool is_m = e_mode == TB_H;
    const bool is_e = e_mode == TB_E1 || e_mode == TB_E2;
    const int cont_bit = e_mode == TB_E1 ? CONT_E1 : e_mode == TB_E2 ? CONT_E2
                         : e_mode == TB_F1 ? CONT_F1 : CONT_F2;
    const bool cont = !is_m && (byte & cont_bit) != 0;
    out.emit(is_m ? OP_M : (is_e ? OP_D : OP_I), 1);
    if (is_m || !is_e) --i;
    if (is_m || is_e) --jj;
    mode = (is_m || !cont) ? TB_H : e_mode;
    done = i < 0 || jj < 0;
  }
  if (si >= 0) {  // leading gaps through the virtual row / column
    if (i >= 0) out.emit(OP_I, i + 1);
    if (jj >= 0) out.emit(OP_D, jj + 1);
  }
  meta_out[0 * P + p] = out.cnt;
  meta_out[1 * P + p] = is_global ? s_scr : gmax;
  meta_out[2 * P + p] = ext_book ? gi : -1;
  meta_out[3 * P + p] = ext_book ? gj : -1;
  meta_out[4 * P + p] = ext_book ? s_dropped : 0;
  meta_out[5 * P + p] = out.over ? 1 : 0;
  meta_out[6 * P + p] = ext_book ? lrmax : NEG;
  meta_out[7 * P + p] = ext_book ? (lrmax > NEG ? lrarg : 0) : -1;
}

}  // namespace

extern "C" int ma_dp_fused(const void* q, const void* t, const void* meta_in, void* runs,
                           void* meta_out, void* dirs, int P, int M, int N, int R,
                           int match, int mismatch, int go1, int ge1, int go2, int ge2,
                           int zdrop, int is_global, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(4 * N + 64) * sizeof(int) + 32 * sizeof(long long);
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  dp_fused_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t),
      static_cast<const int*>(meta_in), static_cast<int*>(runs),
      static_cast<int*>(meta_out), static_cast<unsigned char*>(dirs), P, M, N, R, s,
      zdrop, is_global);
  return ma_launch_status();
}
