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
// What bounds it on the H100: the chain of dependent byte loads along each
// path (device memory or L2, several hundred cycles each); the bytes are
// few (one per step, plus the outputs). Design:
//  - a warp per problem walks a run per round (csrc/dp_common.cuh
//    walk_warp, kernels C's and C''s walk): lane k reads the cell k steps
//    ahead along the current run (stride -(2M + 1) bytes on a diagonal,
//    -(M + 1) up a column in F mode, -M along a row in E mode), one ballot
//    ends the run at the first cell that leaves the diagonal, does not
//    continue its gap or lies outside the matrix, and that cell takes one
//    ordinary step: one dependent round trip per run of up to 32 steps,
//    not per step;
//  - the lanes store a run's op bytes together, and the OP_NONE tail is a
//    warp-wide fill in 16-byte stores;
//  - blocks of 1 to 4 warps, as few as leave every SM a block where P
//    allows (P = 32 spreads over 32 SMs);
//  - a start outside the matrix (si >= M or sj >= N, outside the contract)
//    takes the plain version's clamped one-cell-a-step walk, so the outputs
//    equal traceback_dirs_plain's on any input.
#include "dp_common.cuh"

namespace {

using namespace dp;

constexpr int OP_NONE = 255;

// The walk's ops, stored by the lanes together at the next positions.
struct OpsOut {
  unsigned char* ops;
  int lane;
  int k = 0;
  __device__ void emit(int op, int ln) {
    for (int x = lane; x < ln; x += 32) ops[k + x] = static_cast<unsigned char>(op);
    k += ln;
  }
};

__global__ void dp_traceback_kernel(const unsigned char* __restrict__ dirs,
                                    const int* __restrict__ start,
                                    unsigned char* __restrict__ ops, int* __restrict__ out,
                                    int P, int M, int D) {
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const int S = D + 1;  // M + N
  const unsigned char* dp = dirs + static_cast<size_t>(p) * D * M;
  unsigned char* row = ops + static_cast<size_t>(p) * S;
  int i = start[p], j = start[P + p];
  OpsOut sink{row, lane};
  if (i >= 0) {
    if (i < M && j < S - M) {
      walk_warp([&](int ii, int jk) -> int { return dp[static_cast<size_t>(ii + jk) * M + ii]; },
                i, j, sink, lane);
    } else {
      int mode = TB_H;
      for (bool done = j < 0; !done && sink.k < S;) {
        const int d = min(max(i + j, 0), D - 1);
        done = tb_step(dp[static_cast<size_t>(d) * M + min(i, M - 1)], i, j, mode, sink);
      }
    }
  }
  // the OP_NONE tail: bytes up to a 16-byte boundary, then 16-byte stores
  const int k = sink.k;
  const int a = min(S, k + static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row + k) & 15)) & 15));
  for (int x = k + lane; x < a; x += 32) row[x] = OP_NONE;
  const int nv = (S - a) >> 4;
  uint4* v = reinterpret_cast<uint4*>(row + a);
  for (int x = lane; x < nv; x += 32) v[x] = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int x = a + nv * 16 + lane; x < S; x += 32) row[x] = OP_NONE;
  if (lane == 0) {
    out[p] = k;
    out[P + p] = i;
    out[2 * P + p] = j;
  }
}

}  // namespace

// start [2, P] int32 (si, sj); ops [P, D + 1] uint8; out [3, P] int32.
extern "C" int ma_dp_traceback(const void* dirs, const void* start, void* ops, void* out, int P,
                               int M, int D, void* stream) {
  const int warps = max(1, min(4, P / 132));  // warps (problems) per block
  dp_traceback_kernel<<<(P + warps - 1) / warps, warps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(dirs), static_cast<const int*>(start),
      static_cast<unsigned char*>(ops), static_cast<int*>(out), P, M, D);
  return ma_launch_status();
}
