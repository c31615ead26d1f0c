// What kernels C (dp_fused.cu) and C' (dp_fused_v2.cu) share: the
// contract's constants, the cell step of the row recurrence (with Hopper's
// DPX max instructions), the max-cell book, the traceback step and the warp
// walk (which the traceback kernel, dp_traceback.cu, shares too), the run
// packer, the meta record, and the bulk copies that stream direction rows
// out of shared memory.
//
// The recurrences, boundary values, direction bytes and tie precedence are
// ma_tpu_torch/ops/dp_rows.py's (the plain version):
//   F (query gap) carries from row i-1; E (reference gap) is a max-plus
//   prefix over the row: E_p(i,j) = cummax_{k<j}(H~(i,k) + e_p k) - o_p - e_p j
//   with H~ = max(diag, F1, F2); ties prefer diag, E1, F1, E2, F2; a cell's
//   byte holds its source (0-4) and the four continuation bits.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dp {

constexpr int NEG = -(1 << 30);
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
constexpr int TB_H = 0, TB_E1 = 1, TB_E2 = 2, TB_F1 = 3, TB_F2 = 4;
constexpr int CONT_E1 = 0x08, CONT_F1 = 0x10, CONT_E2 = 0x20, CONT_F2 = 0x40;
constexpr unsigned FULL = 0xffffffffu;

struct Scores {
  int match, mismatch, go1, ge1, go2, ge2;
};

__host__ __device__ __forceinline__ int gap_cost(int k, const Scores& s) {
  const int a = -(s.go1 + k * s.ge1), b = -(s.go2 + k * s.ge2);
  return a > b ? a : b;
}

// ---- the cell step, split where the row's E prefix maximum comes between

// A maximum of two and whether the first won (ties to it): one DPX
// instruction.
__device__ __forceinline__ int bmax(int a, int b, bool* first) {
  return __vibmax_s32(a, b, first);
}

// Before the E terms: F1 / F2 from the cell above (h_up) with their
// continuation bits (the F term wins ties), the substitution score and
// H~ = max(diag + score, F1, F2) (NEG outside the band). hd = diag + score.
__device__ __forceinline__ void cell_f(int h_up, int diag, int qc, int tc, bool valid,
                                       const Scores& s, int& f1, int& f2, bool& cf1, bool& cf2,
                                       int& hd, int& h0) {
  f1 = bmax(f1 - s.ge1, h_up - (s.go1 + s.ge1), &cf1);
  f2 = bmax(f2 - s.ge2, h_up - (s.go2 + s.ge2), &cf2);
  const int sc = (qc >= 4 || tc >= 4) ? 0 : (qc == tc ? s.match : -s.mismatch);
  hd = diag + sc;
  h0 = valid ? __vimax3_s32(hd, f1, f2) : NEG;
}

// The E terms and H of column j: run1/run2 hold the prefix maximum of
// v_p(k) = H~(i, k-1) + e_p (k-1) over k < j and advance to include v_p(j);
// open_src is H~(i, j-1). Returns H (NEG outside the band) and the byte.
__device__ __forceinline__ int cell_h(int j, int v1, int v2, int open_src, int hd, int f1, int f2,
                                      bool cf1, bool cf2, bool valid, const Scores& s, int& run1,
                                      int& run2, uint32_t& byte) {
  const int a1 = max(run1, v1), a2 = max(run2, v2);
  const int e1 = a1 - s.go1 - s.ge1 * j;
  const int e2 = a2 - s.go2 - s.ge2 * j;
  const int e1p = j == 0 ? NEG : run1 - s.go1 - s.ge1 * (j - 1);
  const int e2p = j == 0 ? NEG : run2 - s.go2 - s.ge2 * (j - 1);
  const bool ce1 = e1p - s.ge1 >= open_src - (s.go1 + s.ge1);
  const bool ce2 = e2p - s.ge2 >= open_src - (s.go2 + s.ge2);
  run1 = a1;
  run2 = a2;
  bool keep;  // the earlier source wins ties
  int src = 0;
  int h = bmax(hd, e1, &keep);
  src = keep ? src : 1;
  h = bmax(h, f1, &keep);
  src = keep ? src : 2;
  h = bmax(h, e2, &keep);
  src = keep ? src : 3;
  h = bmax(h, f2, &keep);
  src = keep ? src : 4;
  byte = static_cast<uint32_t>(src | (ce1 ? CONT_E1 : 0) | (cf1 ? CONT_F1 : 0) |
                               (ce2 ? CONT_E2 : 0) | (cf2 ? CONT_F2 : 0));
  return valid ? h : NEG;
}

// ---- the max-cell / z-drop / last-row book, advanced one row at a time
struct Book {
  int gmax, gi = -1, gj = -1, gd = 1 << 30;
  int lrmax = NEG, lrarg = -1;
  bool dropped = false;

  __device__ explicit Book(bool is_global) : gmax(is_global ? NEG : 0) {}

  // Row i's maximum rmax at its first column rarg (rmax = NEG: no cell in
  // the band); m, n: the problem's lengths clipped to the bucket.
  __device__ __forceinline__ void row(int i, int rmax, int rarg, int m, int nn, int w, int zdrop,
                                      int ge1) {
    if (dropped || rmax <= NEG) {  // no undropped cell: the first column's key of NEG
      rmax = NEG;
      rarg = 0;
    }
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
      if (has && gmax - rmax > zdrop + diff * ge1) dropped = true;
    }
  }
};

// ---- traceback

// Run packer of the traceback: append (or merge into the last) run. Every
// lane of a warp that walks a path together keeps the same state; only the
// writer stores.
struct Runs {
  int* runs;
  int R;
  bool writer = true;
  int cnt = 0;
  int last = -1;
  bool over = false;
  __device__ void emit(int op, int ln) {
    if (ln <= 0) return;
    if (last == op && cnt > 0) {
      if (writer) runs[cnt - 1] += ln * 4;
      return;
    }
    if (cnt >= R) {  // no room for a new run: flag, keep `last`
      over = true;
      return;
    }
    if (writer) runs[cnt] = ln * 4 + op;
    ++cnt;
    last = op;
  }
};

// The traceback's first cell: (m-1, n-1) for a global problem, the last
// row's best cell with tb_last set, else the max cell (row -1: no path).
__device__ __forceinline__ void tb_start(bool is_global, int tb_last, int m, int n,
                                         const Book& b, int& si, int& sj) {
  if (is_global) {
    si = m - 1;
    sj = n - 1;
  } else if (tb_last != 0) {
    si = b.lrmax > NEG ? m - 1 : -1;
    sj = b.lrarg;
  } else {
    si = b.gi;
    sj = b.gj;
  }
}

// One traceback step on the byte of cell (i, jj); returns whether the walk
// has left the matrix. `out` takes the op (Runs, or any sink with the same
// emit).
template <class Sink>
__device__ __forceinline__ bool tb_step(int byte, int& i, int& jj, int& mode, Sink& out) {
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
  return i < 0 || jj < 0;
}

// Leading gaps through the virtual row / column after the walk.
__device__ __forceinline__ void tb_finish(int si, int i, int jj, Runs& out) {
  if (si >= 0) {
    if (i >= 0) out.emit(OP_I, i + 1);
    if (jj >= 0) out.emit(OP_D, jj + 1);
  }
}

// The traceback walk by a whole warp, from (i, jj) until it leaves the
// matrix (every lane calls it with the same arguments and keeps the same
// state). `cell(i, j)` gives the direction byte of a cell inside the matrix;
// `out.emit(op, len)` takes the ops in order, a run of up to 32 at a time.
// Each round reads the next 32 cells of the current run in parallel: the
// diagonal while the cells' source is the diagonal (M steps), the row while
// E continues (D steps), the column while F continues (I steps); one ballot
// finds where the run ends, and the cell there takes one ordinary step. The
// ops equal the one-cell-a-step walk's. Leaves (i, jj) at the walk's end.
template <class Cell, class Sink>
__device__ inline void walk_warp(const Cell& cell, int& i, int& jj, Sink& out, int lane) {
  int mode = TB_H;
  bool done = i < 0 || jj < 0;
  while (!done) {
    const bool diag = mode == TB_H;
    const bool row = mode == TB_E1 || mode == TB_E2;
    const int ii = row ? i : i - lane, jk = diag || row ? jj - lane : jj;
    const bool inside = ii >= 0 && jk >= 0;
    const int byte = inside ? cell(ii, jk) : 0;
    const int cont_bit = mode == TB_E1 ? CONT_E1 : mode == TB_E2 ? CONT_E2
                         : mode == TB_F1 ? CONT_F1 : CONT_F2;
    // a cell that ends the run: leaves the matrix, leaves the diagonal, or
    // (in a gap) does not continue it
    const bool stop = !inside || (diag ? (byte & 7) != 0 : (byte & cont_bit) == 0);
    const unsigned ballot = __ballot_sync(FULL, stop);
    const int first = ballot ? __ffs(ballot) - 1 : 32;
    if (diag) {
      out.emit(OP_M, first);
      i -= first;
      jj -= first;
      done = i < 0 || jj < 0;
      if (!done && first < 32)  // the cell at the end enters a gap: one ordinary step
        done = tb_step(__shfl_sync(FULL, byte, first), i, jj, mode, out);
    } else {
      // the gap steps through the cell that ends the run (if it is inside)
      const bool in_end = first < 32 && __shfl_sync(FULL, inside, first);
      const int steps = first < 32 ? first + (in_end ? 1 : 0) : 32;
      out.emit(row ? OP_D : OP_I, steps);
      if (row) {
        jj -= steps;
      } else {
        i -= steps;
      }
      if (first < 32) mode = TB_H;
      done = i < 0 || jj < 0;
    }
  }
}

// The fused kernels' traceback by a whole warp (lane 0 stores the runs):
// the walk from (si, sj) over `cell`, then the leading gaps.
template <class Cell>
__device__ inline void traceback_warp(const Cell& cell, int si, int sj, Runs& out, int lane) {
  int i = si, jj = sj;
  walk_warp(cell, i, jj, out, lane);
  tb_finish(si, i, jj, out);
}

// The same over a direction plane [rows, ldn] in shared memory or, GLOBAL,
// in global memory written by bulk copies this kernel has waited for (read
// through L2).
template <bool GLOBAL>
__device__ inline void traceback_plane_warp(const unsigned char* plane, int ldn, int si, int sj,
                                            Runs& out, int lane) {
  traceback_warp(
      [&](int ii, int jk) -> int {
        const unsigned char* c = plane + static_cast<size_t>(ii) * ldn + jk;
        return GLOBAL ? __ldcg(c) : *c;
      },
      si, sj, out, lane);
}

// meta [8, P] of problem p.
__device__ __forceinline__ void write_meta(int* meta_out, int P, int p, const Runs& out,
                                           bool is_global, bool ext_book, int scr,
                                           const Book& b) {
  meta_out[0 * P + p] = out.cnt;
  meta_out[1 * P + p] = is_global ? scr : b.gmax;
  meta_out[2 * P + p] = ext_book ? b.gi : -1;
  meta_out[3 * P + p] = ext_book ? b.gj : -1;
  meta_out[4 * P + p] = ext_book ? (b.dropped ? 1 : 0) : 0;
  meta_out[5 * P + p] = out.over ? 1 : 0;
  meta_out[6 * P + p] = ext_book ? b.lrmax : NEG;
  meta_out[7 * P + p] = ext_book ? (b.lrmax > NEG ? b.lrarg : 0) : -1;
}

// ---- bulk copies (the TMA bulk path) between shared and global memory

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A team barrier: __syncwarp for a one-warp team, a named barrier otherwise.
__device__ __forceinline__ void team_sync(int bar_id, int nthreads) {
  if (nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(nthreads) : "memory");
  }
}

// generic-proxy writes to shared memory -> visible to the bulk copy engine
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(gdst), "r"(saddr(ssrc)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// all but the newest store group have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// every store group has completed (its global writes performed)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

}  // namespace dp
