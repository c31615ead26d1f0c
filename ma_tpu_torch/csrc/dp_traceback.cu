// Traceback over kernel D's direction bytes.
//
// Replaces the XLA scan ma_tpu/ops/dp.py `traceback_device` (not a Pallas
// kernel: its plain form runs M+N sequential steps of small ops, thousands
// of launches per call at the long-read buckets). From the start cell
// (si, sj) it follows dirs [P, M+N-1, M] (byte of cell (i, j) at
// [i + j, i]): in H mode the source bits pick diag / E / F, and a gap mode
// keeps going while the cell's continuation bit for that gap is set. Ops go
// out back to front, one per step, OP_NONE after the path leaves the matrix:
// ops [P, M+N] uint8, and out [3, P] int32 (n_ops, final i, final j; the
// final coordinates give the leading I / D residual). si < 0 skips a problem.
//
// What bounds it on the H100: each step is one dependent byte load from the
// direction tensor (device memory or L2), so a path costs its length times
// the load latency; the problems are independent. Design: one thread per
// problem, the path walked in registers, ops written as they are emitted.
#include "common.cuh"

namespace {

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 255;
constexpr int TB_H = 0, TB_E1 = 1, TB_E2 = 2, TB_F1 = 3, TB_F2 = 4;
constexpr int CONT_E1 = 0x08, CONT_F1 = 0x10, CONT_E2 = 0x20, CONT_F2 = 0x40;

__global__ void dp_traceback_kernel(const unsigned char* __restrict__ dirs,
                                    const int* __restrict__ start,
                                    unsigned char* __restrict__ ops, int* __restrict__ out,
                                    int P, int M, int D) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int S = D + 1;  // M + N
  const unsigned char* dp = dirs + static_cast<size_t>(p) * D * M;
  unsigned char* op = ops + static_cast<size_t>(p) * S;
  int i = start[p], j = start[P + p], mode = TB_H;
  int k = 0;
  if (i >= 0) {
    for (; k < S && i >= 0 && j >= 0; ++k) {
      const int d = min(max(i + j, 0), D - 1);
      const int byte = dp[static_cast<size_t>(d) * M + min(i, M - 1)];
      const int src = byte & 7;
      int e_mode = mode;
      if (mode == TB_H)
        e_mode = src == 1 ? TB_E1 : src == 3 ? TB_E2 : src == 2 ? TB_F1 : src == 4 ? TB_F2 : TB_H;
      const bool is_m = e_mode == TB_H;
      const bool is_e = e_mode == TB_E1 || e_mode == TB_E2;
      const int cont_bit = e_mode == TB_E1 ? CONT_E1 : e_mode == TB_E2 ? CONT_E2
                           : e_mode == TB_F1 ? CONT_F1 : CONT_F2;
      const bool cont = !is_m && (byte & cont_bit) != 0;
      op[k] = static_cast<unsigned char>(is_m ? OP_M : (is_e ? OP_D : OP_I));
      if (is_m || !is_e) --i;
      if (is_m || is_e) --j;
      mode = (is_m || !cont) ? TB_H : e_mode;
    }
  }
  out[p] = k;
  out[P + p] = i;
  out[2 * P + p] = j;
  for (; k < S; ++k) op[k] = OP_NONE;
}

}  // namespace

// start [2, P] int32 (si, sj); ops [P, D + 1] uint8; out [3, P] int32.
extern "C" int ma_dp_traceback(const void* dirs, const void* start, void* ops, void* out, int P,
                               int M, int D, void* stream) {
  const int threads = 128;
  dp_traceback_kernel<<<(P + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(dirs), static_cast<const int*>(start),
      static_cast<unsigned char*>(ops), static_cast<int*>(out), P, M, D);
  return ma_launch_status();
}
