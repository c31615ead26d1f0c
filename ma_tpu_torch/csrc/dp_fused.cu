// Kernel C: banded 2-piece affine-gap DP with z-drop, forward sweep and
// traceback fused in one kernel.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_fused.py `_kernel` (entry
// `banded_align_runs`, the kswcpp equivalent). Same recurrences, boundary
// conventions, tie precedence and max-cell book as ma_tpu/ops/dp_rows.py (the
// plain version) and kernel C' (csrc/dp_fused_v2.cu), with which it shares
// the cell step, book and traceback (csrc/dp_common.cuh), so CIGARs are
// identical. Output: merged CIGAR runs (op | len << 2, back to front,
// capacity R with an overflow flag) and meta [8, P] (n_runs, score, max_i,
// max_j, zdropped, run_overflow, lastrow_max, lastrow_arg).
//
// What bounds it on the H100: 46 integer operations per in-band cell (the F
// and E recurrences with their continuation bits, the score, H~, the
// five-way source select, the direction byte and the row maximum; counted
// one by one at chip_smoke.py DP_OPS_PER_CELL), rows one after another
// within a problem. Design:
//  - a team of T = N / 4 threads (rounded up to a warp) per problem, each
//    thread owning 4 consecutive columns with their H, F1, F2 and target
//    codes in registers: one warp at N <= 128 (8 teams per block), up to 8
//    warps at N <= 1024;
//  - at most one barrier per row, and none in a one-warp team: the E prefix
//    maximum is serial within a thread and a shuffle scan across the warp;
//    across warps, each warp publishes its scan total before the barrier and
//    the values that depend on the previous warp (its first column's
//    diagonal H, so its first two E terms) are resolved after it, lane k of
//    every warp finishing warp k's and a shuffle scan over the lanes giving
//    each warp its prefix; state exchanged through shared memory is
//    double-buffered by row parity, and the z-drop book of row i - 1 is read
//    after row i's barrier. Every lane keeps the book, fed the row maximum
//    by warp reductions (__reduce_max_sync / __reduce_min_sync);
//  - DPX instructions for the recurrences (__vibmax_s32 gives a maximum and
//    which side won: the continuation bits and the source of a cell;
//    __vimax3_s32 for H~);
//  - the direction plane in shared memory where it fits (4 KB at 32 x 128,
//    8 KB at 64 x 128, 48 KB at 64 x 768), so the traceback reads shared
//    memory, a warp at a time: 32 cells of the current diagonal, row or
//    column run per round (csrc/dp_common.cuh traceback_plane_warp); larger
//    planes (256 x 128: 32 KB for a one-warp team, which would leave a
//    block 3 teams; 256 x 768: 196 KB) stream row by row to a global
//    scratch by bulk copies from a 3-row ring, and the warp walks them there
//    through L2;
//  - registers capped for 3 blocks of 256 threads per SM (__launch_bounds__);
//  - work skipped: a thread whose 4 columns all lie left of the band (they
//    stay out for every later row) or right of it (not yet in) computes
//    nothing for the row. Its cells are out of the band, so their H is NEG;
//    a right-of-band column's F is a closed form of its row-0 boundary,
//    set when the thread first enters the band; their E terms are dominated
//    by the virtual column's. The traceback can reach such a cell only in E
//    mode from the right (left of the band) or in F mode from below (right
//    of it) and reads only that continuation bit, which the thread writes
//    (always set but at column 0 / row 0). Problems whose traceback starts
//    outside the band (a global problem with |m - n| > band) compute every
//    cell. An extension problem stops at the row after its z-drop fires:
//    the book is frozen then and no later row is read.
#include "dp_common.cuh"

namespace {

using namespace dp;

constexpr int CPT = 4;           // columns per thread
constexpr int XF = 9;            // exchanged words per warp and row parity
// larger direction planes stream to global: a one-warp team's above 16 KB
// (so a block still holds 8 teams), a wider team's above 96 KB
constexpr int STREAM_BYTES_WARP = 16 * 1024, STREAM_BYTES = 96 * 1024;

// Shared memory of one team in bytes (a multiple of 128): the direction plane
// [M, ldn] or, streaming, a 3-row ring; the exchange words
// [2][XF][W]; the global score cell; the query codes [M] (one byte each).
__host__ __device__ inline int dir_bytes(int M, int ldn, bool stream) {
  return stream ? 3 * ldn : M * ldn;
}
__host__ __device__ inline int team_bytes(int M, int ldn, int W, bool stream) {
  return (dir_bytes(M, ldn, stream) + 2 * XF * W * 4 + 16 + M + 127) / 128 * 128;
}

// exchange fields (per warp): written before the row's barrier ...
constexpr int X_TOT1 = 0, X_TOT2 = 1, X_H0 = 2, X_EPF = 3, X_ESC = 4, X_EVALID = 8;
// ... and after it, read after the next row's barrier
constexpr int X_HROW = 5, X_KEYH = 6, X_KEYJ = 7;

template <bool MULTI, bool STREAM>
__global__ void __launch_bounds__(256, 3)
    dp_fused_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    const int* __restrict__ meta_in, int* __restrict__ runs,
                    int* __restrict__ meta_out, unsigned char* __restrict__ dirs, int P, int M,
                    int N, int ldn, int R, Scores s, int zdrop, int is_global, int T, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = T >> 5;
  const int team = threadIdx.x / T;
  const int ti = threadIdx.x - team * T;   // thread in team
  const int lane = ti & 31, wi = ti >> 5;  // lane, warp in team
  unsigned char* base = smem_raw + static_cast<size_t>(team) * team_bytes(M, ldn, W, STREAM);
  unsigned char* plane = base;  // [M][ldn], or streaming the ring [3][ldn]
  int* xch = reinterpret_cast<int*>(base + dir_bytes(M, ldn, STREAM));
  int* s_scr = xch + 2 * XF * W;
  unsigned char* s_q = reinterpret_cast<unsigned char*>(s_scr + 4);  // [M]
  auto X = [&](int par, int f) { return xch + (par * XF + f) * W; };

  const int p = blockIdx.x * G + team;
  if (ti == 0) *s_scr = NEG;
  __syncthreads();
  if (p >= P) return;

  const int bar_id = 1 + team;
  const int m = meta_in[p * 4 + 0], n = meta_in[p * 4 + 1];
  const int w = meta_in[p * 4 + 2], tb_last = meta_in[p * 4 + 3];
  const bool ext_book = !(is_global && zdrop < 0);
  const int* qp = q + static_cast<size_t>(p) * M;
  int* rp = runs + static_cast<size_t>(p) * R;
  for (int k = ti; k < R; k += T) rp[k] = 0;
  // the query's codes stay in shared memory: no global load per row
  for (int k = ti; k < min(m, M); k += T) s_q[k] = static_cast<unsigned char>(qp[k]);
  const int c0 = ti * CPT;  // this thread's first column
  unsigned char* dglobal = dirs + static_cast<size_t>(p) * M * ldn;  // streaming only

  int tcw = 0;  // target codes, one byte per column
  int f1[CPT], f2[CPT], h[CPT], h0[CPT], hd[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = c0 + k;
    const int c = j < N ? t[static_cast<size_t>(p) * N + j] : 4;
    tcw |= (c & 0xff) << (8 * k);
    f1[k] = NEG;
    f2[k] = NEG;
    h[k] = NEG;
  }
  Book book(is_global);  // every thread keeps the book (all read the same row maxima)
  const int nn = min(n, N);
  // skipping out-of-band threads needs a traceback that starts in the band
  const bool skip_ok = !is_global || abs(m - n) <= w;
  bool entered = false;  // this thread's columns have been in the band
  team_sync(bar_id, T);  // zero-filled runs, s_scr and the query before any later use

  const int rows = min(m, M);
  bool stopped = false;
  for (int i = 0; i < rows; ++i) {
    const int par = i & 1;
    const int qc = s_q[i];
    const int virt = i > 0 ? gap_cost(i, s) : NEG;
    const int lo = max(0, i - w), hi = min(nn - 1, i + w);
    const bool left = skip_ok && c0 + CPT - 1 < lo;
    const bool active = !left && !(skip_ok && c0 > hi);
    if (active && !entered) {
      entered = true;
      if (i > 0) {  // F after rows 0 .. i-1 of a column right of the band
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int g = gap_cost(c0 + k, s);
          f1[k] = g - s.go1 - s.ge1 * i;
          f2[k] = g - s.go2 - s.ge2 * i;
        }
      }
    }
    // ---- A: H~ of this thread's columns. The diagonal of the first column
    // is the left lane's last H of row i-1 (shuffled before any H changes);
    // at the first lane of a warp past the first it is the previous warp's,
    // known after the barrier: that column's H~ is finished there.
    const int hleft = __shfl_up_sync(FULL, h[CPT - 1], 1);
    const bool edge = MULTI && lane == 0 && wi > 0;
    bool valid[CPT], cf1[CPT], cf2[CPT];
    int esc = 0;
    if (active) {
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
        valid[k] = j < N && j < n && abs(i - j) <= w;
        cell_f<true>(h_up, diag, qc, tc, valid[k], s, f1[k], f2[k], cf1[k], cf2[k], hd[k], h0[k]);
        if (k == 0 && edge) esc = hd[0] - diag;  // the substitution score
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        h0[k] = NEG;
        if (left) h[k] = NEG;  // out of the band from now on
      }
    }
    // ---- B: this warp's part of the E prefix maximum over
    // v_p(j) = H~(i, j-1) + e_p (j-1) (the virtual column's value at j = 0);
    // a first lane past warp 0 leaves out its first two columns' v
    const int h0left_w = __shfl_up_sync(FULL, h0[CPT - 1], 1);  // lanes > 0
    int tot1 = INT_MIN, tot2 = INT_MIN;
    if (active) {
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int j = c0 + k;
        if (edge && k < 2) continue;
        const int hl = k == 0 ? (lane == 0 ? virt : h0left_w) : h0[k - 1];
        const int o = k == 0 && lane == 0 ? -1 : j - 1;  // j = 0: virt - e_p
        tot1 = __viaddmax_s32(hl, s.ge1 * o, tot1);
        tot2 = __viaddmax_s32(hl, s.ge2 * o, tot2);
      }
    } else if (lane == 0 && wi == 0) {  // the virtual column's value stays in the scan
      tot1 = virt - s.ge1;
      tot2 = virt - s.ge2;
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

    int g1 = INT_MIN, g2 = INT_MIN;  // prefix over the columns of the warps before
    int d1 = INT_MIN, d2 = INT_MIN;  // this warp's first two columns' v (past warp 0)
    if (MULTI || STREAM) {
      if (MULTI) {
        if (lane == 31) {
          X(par, X_TOT1)[wi] = inc1;
          X(par, X_TOT2)[wi] = inc2;
          X(par, X_H0)[wi] = h0[CPT - 1];
        }
        if (edge) {
          X(par, X_EPF)[wi] = max(f1[0], f2[0]);
          X(par, X_ESC)[wi] = esc;
          X(par, X_EVALID)[wi] = active && valid[0];
        }
      }
      team_sync(bar_id, T);  // the row's one barrier
      if (STREAM && ti == 0 && i > 0) {
        // row i-1 is complete: send it, and make sure row i-2's copy has read
        // its slot, which row i+1 writes
        bulk_store(dglobal + static_cast<size_t>(i - 1) * ldn, plane + ((i - 1) % 3) * ldn, ldn);
        bulk_wait_read1();
      }
      if (MULTI) {
        // lane k < W reads warp k's words: the book's row maxima and, for k
        // >= 1, what finishes warp k's first column and its two E terms
        if (ext_book && i > 0) {  // the book of row i-1
          const int kh = lane < W ? X(par ^ 1, X_KEYH)[lane] : INT_MIN;
          const int kj = lane < W ? X(par ^ 1, X_KEYJ)[lane] : INT_MAX;
          const int rmax = __reduce_max_sync(FULL, kh);
          book.row(i - 1, rmax, __reduce_min_sync(FULL, kh == rmax ? kj : INT_MAX), m, nn, w,
                   zdrop, s.ge1);
          if (!is_global && book.dropped) {
            stopped = true;
            break;
          }
        }
        int a1 = INT_MIN, a2 = INT_MIN, c1 = INT_MIN, c2 = INT_MIN, hdk = 0, h0k = NEG;
        if (lane >= 1 && lane < W) {
          const int ck = lane * 32 * CPT;
          const int diag = i == 0 ? gap_cost(ck, s) : X(par ^ 1, X_HROW)[lane - 1];
          hdk = diag + X(par, X_ESC)[lane];
          h0k = X(par, X_EVALID)[lane] ? max(hdk, X(par, X_EPF)[lane]) : NEG;
          const int hl = X(par, X_H0)[lane - 1];  // H~(i, ck-1)
          a1 = max(hl + s.ge1 * (ck - 1), h0k + s.ge1 * ck);
          a2 = max(hl + s.ge2 * (ck - 1), h0k + s.ge2 * ck);
          c1 = max(a1, X(par, X_TOT1)[lane - 1]);
          c2 = max(a2, X(par, X_TOT2)[lane - 1]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {  // prefix over warps 1 .. lane (W <= 8)
          const int y1 = __shfl_up_sync(FULL, c1, o), y2 = __shfl_up_sync(FULL, c2, o);
          if (lane >= o) {
            c1 = max(c1, y1);
            c2 = max(c2, y2);
          }
        }
        if (wi > 0) {  // this warp's prefix, and its own first two columns
          g1 = max(__shfl_sync(FULL, c1, wi - 1), X(par, X_TOT1)[wi - 1]);
          g2 = max(__shfl_sync(FULL, c2, wi - 1), X(par, X_TOT2)[wi - 1]);
          d1 = __shfl_sync(FULL, a1, wi);
          d2 = __shfl_sync(FULL, a2, wi);
          const int hdw = __shfl_sync(FULL, hdk, wi), h0w = __shfl_sync(FULL, h0k, wi);
          if (edge && active) {
            hd[0] = hdw;
            h0[0] = h0w;
          }
        }
      }
    }

    // ---- C: E terms, H, direction bytes, the row maximum
    unsigned char* drow = plane + (STREAM ? (i % 3) : i) * ldn;
    int hbest = INT_MIN, jbest = INT_MAX;
    if (active) {
      int run1, run2, v01, v02, open_left;  // a(c0-1), v(c0), H~(i, c0-1)
      if (lane == 0) {
        run1 = g1;
        run2 = g2;
        open_left = wi == 0 ? virt : X(par, X_H0)[wi - 1];
        v01 = wi == 0 ? virt - s.ge1 : open_left + s.ge1 * (c0 - 1);
        v02 = wi == 0 ? virt - s.ge2 : open_left + s.ge2 * (c0 - 1);
      } else {
        run1 = max(max(g1, d1), exc1);
        run2 = max(max(g2, d2), exc2);
        open_left = h0left_w;
        v01 = h0left_w + s.ge1 * (c0 - 1);
        v02 = h0left_w + s.ge2 * (c0 - 1);
      }
      uint32_t dword = 0;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int j = c0 + k;
        const int open_src = k == 0 ? open_left : h0[k - 1];
        const int v1 = k == 0 ? v01 : h0[k - 1] + s.ge1 * (j - 1);
        const int v2 = k == 0 ? v02 : h0[k - 1] + s.ge2 * (j - 1);
        uint32_t byte;
        const int hv = cell_h<true>(j, v1, v2, open_src, hd[k], f1[k], f2[k], cf1[k], cf2[k],
                              valid[k], s, run1, run2, byte);
        h[k] = hv;
        dword |= byte << (8 * k);
        if (valid[k]) {
          if (i == m - 1 && j == n - 1) *s_scr = hv;  // global score cell
          if (hv > hbest) {
            hbest = hv;
            jbest = j;
          }
        }
      }
      *reinterpret_cast<uint32_t*>(drow + c0) = dword;
    } else {
      // the only bits a traceback reads here: E continuation left of the
      // band (not at column 0), F continuation right of it (not at row 0)
      *reinterpret_cast<uint32_t*>(drow + c0) =
          left ? (c0 == 0 ? 0x28282800u : 0x28282828u) : (i > 0 ? 0x50505050u : 0u);
    }
    if (ext_book) {
      const int wmax = __reduce_max_sync(FULL, hbest);
      const int wj = __reduce_min_sync(FULL, hbest == wmax ? jbest : INT_MAX);
      if (MULTI) {
        if (lane == 0) {
          X(par, X_KEYH)[wi] = wmax;
          X(par, X_KEYJ)[wi] = wj;
        }
      } else {
        book.row(i, wmax, wj, m, nn, w, zdrop, s.ge1);
      }
    }
    if (MULTI && lane == 31) X(par, X_HROW)[wi] = h[CPT - 1];
    if (STREAM) fence_async_smem();
    if (!MULTI && !is_global && book.dropped) {
      stopped = true;
      break;
    }
  }
  if (!stopped && rows > 0 && (MULTI || STREAM)) {
    team_sync(bar_id, T);  // the last row complete
    if (MULTI && ext_book) {
      const int par = (rows - 1) & 1;
      const int kh = lane < W ? X(par, X_KEYH)[lane] : INT_MIN;
      const int kj = lane < W ? X(par, X_KEYJ)[lane] : INT_MAX;
      const int rmax = __reduce_max_sync(FULL, kh);
      book.row(rows - 1, rmax, __reduce_min_sync(FULL, kh == rmax ? kj : INT_MAX), m, nn, w,
               zdrop, s.ge1);
    }
    if (STREAM && ti == 0)
      bulk_store(dglobal + static_cast<size_t>(rows - 1) * ldn, plane + ((rows - 1) % 3) * ldn,
                 ldn);
  }
  if (!MULTI) __syncwarp();  // every byte of the plane written
  if (ti >= 32) return;

  // ---- traceback by the first warp, up to 32 cells a round, over the plane
  // in shared memory or the streamed rows in global memory
  int si, sj;
  tb_start(is_global, tb_last, m, n, book, si, sj);
  Runs out{rp, R, ti == 0};
  if (STREAM) {
    if (ti == 0) bulk_wait_all();  // every direction row is in global memory
    __syncwarp();
    traceback_plane_warp<true>(dglobal, ldn, si, sj, out, lane);
  } else {
    traceback_plane_warp<false>(plane, ldn, si, sj, out, lane);
  }
  if (ti == 0) write_meta(meta_out, P, p, out, is_global, ext_book, *s_scr, book);
}

template <bool MULTI, bool STREAM>
int launch(int blocks, int threads, size_t smem, cudaStream_t st, const void* q, const void* t,
           const void* meta_in, void* runs, void* meta_out, void* dirs, int P, int M, int N,
           int ldn, int R, const Scores& s, int zdrop, int is_global, int T, int G) {
  auto kernel = dp_fused_kernel<MULTI, STREAM>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), static_cast<const int*>(meta_in),
      static_cast<int*>(runs), static_cast<int*>(meta_out), static_cast<unsigned char*>(dirs),
      P, M, N, ldn, R, s, zdrop, is_global, T, G);
  return ma_launch_status();
}

// The team width: ceil(N / 4) threads rounded up to a warp.
inline int team_width(int N) { return ((N + CPT - 1) / CPT + 31) / 32 * 32; }

// Whether a team's [M, 4 T] direction plane streams to global scratch.
inline bool plane_streams(int M, int T) {
  return M * T * CPT > (T == 32 ? STREAM_BYTES_WARP : STREAM_BYTES);
}

}  // namespace

// Bytes of global direction scratch one problem needs at (M, N): M x 4 T
// where the plane streams, else 0; -1 where (M, N) is out of range. The
// caller allocates P times this for ma_dp_fused's `dirs` (ops/dp_fused.py).
extern "C" long long ma_dp_fused_scratch_bytes(int M, int N) {
  const int T = team_width(N);
  if (T > 256 || N < 1 || M < 1) return -1;
  return plane_streams(M, T) ? static_cast<long long>(M) * T * CPT : 0;
}

// Launch shape: a team of T threads (team_width, T <= 256, so N <= 1024)
// per problem, G teams per block (at most 256 threads and about 110 KB of
// shared memory). The plane's row stride is ldn = 4 T bytes; a plane of more
// than 16 KB (one-warp team) or 96 KB streams to `dirs` [P, M, ldn], whose
// size ma_dp_fused_scratch_bytes gives, else `dirs` may be null.
extern "C" int ma_dp_fused(const void* q, const void* t, const void* meta_in, void* runs,
                           void* meta_out, void* dirs, int P, int M, int N, int R, int match,
                           int mismatch, int go1, int ge1, int go2, int ge2, int zdrop,
                           int is_global, void* stream) {
  const int T = team_width(N);
  if (T > 256 || N < 1 || M < 1) return cudaErrorInvalidValue;
  const int ldn = T * CPT;
  const bool streams = plane_streams(M, T);
  if (streams && dirs == nullptr) return cudaErrorInvalidValue;
  const int tb = team_bytes(M, ldn, T / 32, streams);
  const int G = max(1, min(256 / T, (110 * 1024) / tb));
  const size_t smem = static_cast<size_t>(G) * tb;
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  const int blocks = (P + G - 1) / G;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool multi = T > 32;
#define MA_DP_FUSED_LAUNCH(MU, ST)                                                          \
  return launch<MU, ST>(blocks, G * T, smem, st, q, t, meta_in, runs, meta_out, dirs, P, M, \
                        N, ldn, R, s, zdrop, is_global, T, G)
  if (multi) {
    if (streams) MA_DP_FUSED_LAUNCH(true, true);
    MA_DP_FUSED_LAUNCH(true, false);
  }
  if (streams) MA_DP_FUSED_LAUNCH(false, true);
  MA_DP_FUSED_LAUNCH(false, false);
#undef MA_DP_FUSED_LAUNCH
}
