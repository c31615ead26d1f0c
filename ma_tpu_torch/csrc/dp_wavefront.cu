// Kernel D: banded 2-piece affine-gap DP with z-drop as an anti-diagonal
// wavefront, emitting the direction byte of every cell.
//
// Replaces the Pallas kernel ma_tpu/ops/dp_pallas.py `_dp_kernel` (entry
// `banded_align_pallas`), which computes cell for cell what the XLA scan
// ma_tpu/ops/dp.py `banded_align` computes. Cell (i, j) lies on diagonal
// d = i + j, lane i; it reads the lane's own H, E1, E2 from diagonal d-1,
// lane i-1's H, F1, F2 from d-1 and lane i-1's H from d-2, so every lane of
// a diagonal is independent. Recurrence, virtual row / column (gap_cost),
// tie order (diag, E1, F1, E2, F2) and direction-byte layout follow
// ops/dp.py; the max cell is the first maximal lane of the first diagonal
// that reaches the maximum; z-drop is checked once per diagonal against the
// updated max cell. Extension mode starts the max at 0 with cell (-1, -1).
// Output: dirs [P, M+N-1, M] uint8 (every cell, masked ones included) and
// out [4, P] int32 (score, max_i, max_j, zdropped).
//
// What bounds it on the H100: one problem's diagonals are a sequential chain
// of D = M+N-1 steps, each M lanes of ~40 integer ops, and every cell's byte
// goes to device memory (P * D * M bytes: 1.34 GB at P = 256, M = 1024,
// N = 4096, ~0.4 ms of write bandwidth), so the kernel is bound by the
// per-diagonal barrier chain and the integer work. Design: one block per
// problem, threads striding over the lanes; the state of diagonals d-1 and
// d-2 lives in shared memory (H in three rotating buffers, F1/F2 in two, E1/E2
// in place, since only the owning thread reads them: 36 * M bytes), or in a
// per-problem global scratch where that exceeds the shared memory limit;
// direction bytes are stored coalesced along i; one barrier per diagonal
// (__syncthreads_or, which also gives any(valid)), with the per-diagonal
// argmax reduced by warp shuffles into a double-buffered table that thread 0
// reads after the barrier. The target is read as t[d - i] directly. Every
// cell of the direction tensor is written; skipping dead diagonals and
// out-of-band lanes is later work.
#include "common.cuh"

namespace {

constexpr int NEG = -(1 << 30);
constexpr int CONT_E1 = 0x08, CONT_F1 = 0x10, CONT_E2 = 0x20, CONT_F2 = 0x40;
constexpr long long LANE_SPAN = 4294967296LL;  // 2^32: key = h * 2^32 + (INT_MAX - i)

struct Scores {
  int match, mismatch, go1, ge1, go2, ge2;
};

__device__ __forceinline__ int gap_cost(int k, const Scores& s) {
  return max(-(s.go1 + k * s.ge1), -(s.go2 + k * s.ge2));
}

__global__ void __launch_bounds__(1024)
    dp_wavefront_kernel(const int* __restrict__ q, const int* __restrict__ t,
                        const int* __restrict__ lens, unsigned char* __restrict__ dirs,
                        int* __restrict__ out, int* __restrict__ scratch, int P, int M,
                        int N, Scores s, int zdrop, int is_global) {
  extern __shared__ int smem[];
  __shared__ long long s_key[2][32];
  __shared__ int s_scr;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int D = M + N - 1;
  const int m = lens[p * 3 + 0], n = lens[p * 3 + 1], w = lens[p * 3 + 2];
  const int* qp = q + static_cast<size_t>(p) * M;
  const int* tp = t + static_cast<size_t>(p) * N;
  unsigned char* dp = dirs + static_cast<size_t>(p) * D * M;
  // state: H[3][M] | F1[2][M] | F2[2][M] | E1[M] | E2[M]
  int* st = scratch != nullptr ? scratch + static_cast<size_t>(p) * 9 * M : smem;
  for (int k = tid; k < 9 * M; k += blockDim.x) st[k] = NEG;
  if (tid == 0) s_scr = NEG;
  int* e1 = st + 7 * M;
  int* e2 = st + 8 * M;
  // max-cell book (thread 0)
  int gmax = is_global ? NEG : 0, gi = -1, gj = -1;
  bool dropped = false;
  __syncthreads();

  for (int d = 0; d < D; ++d) {
    int* hc = st + (d % 3) * M;
    const int* h1 = st + ((d + 2) % 3) * M;
    const int* h2 = st + ((d + 1) % 3) * M;
    int* f1c = st + 3 * M + (d & 1) * M;
    const int* f1p = st + 3 * M + ((d + 1) & 1) * M;
    int* f2c = st + 5 * M + (d & 1) * M;
    const int* f2p = st + 5 * M + ((d + 1) & 1) * M;
    unsigned char* drow = dp + static_cast<size_t>(d) * M;
    long long best = LLONG_MIN;
    int any_valid = 0;
    for (int i = tid; i < M; i += blockDim.x) {
      const int jv = d - i;
      const bool valid = i < m && jv >= 0 && jv < n && abs(i - jv) <= w;
      // E (reference gap) from (i, j-1) on diagonal d-1
      const int h_left = jv > 0 ? h1[i] : (i > 0 ? gap_cost(i, s) : NEG);
      const int e1x = jv > 0 ? e1[i] - s.ge1 : NEG;
      const int e2x = jv > 0 ? e2[i] - s.ge2 : NEG;
      const int o1 = h_left - (s.go1 + s.ge1), o2 = h_left - (s.go2 + s.ge2);
      const int ne1 = max(o1, e1x), ne2 = max(o2, e2x);
      const bool ce1 = e1x >= o1, ce2 = e2x >= o2;
      // F (query gap) from (i-1, j) on d-1; diagonal from (i-1, j-1) on d-2
      int h_up, f1x, f2x, diag;
      if (i > 0) {
        h_up = h1[i - 1];
        f1x = f1p[i - 1] - s.ge1;
        f2x = f2p[i - 1] - s.ge2;
        diag = jv > 0 ? h2[i - 1] : gap_cost(i, s);
      } else {
        h_up = jv > 0 ? gap_cost(jv, s) : NEG;
        f1x = NEG;
        f2x = NEG;
        diag = jv == 0 ? 0 : gap_cost(jv, s);
      }
      const int u1 = h_up - (s.go1 + s.ge1), u2 = h_up - (s.go2 + s.ge2);
      const int nf1 = max(u1, f1x), nf2 = max(u2, f2x);
      const bool cf1 = f1x >= u1, cf2 = f2x >= u2;
      const int qc = qp[i];
      const int tc = (jv >= 0 && jv < N) ? tp[jv] : 4;
      const int sc = (qc >= 4 || tc >= 4) ? 0 : (qc == tc ? s.match : -s.mismatch);
      // combine, ties to diag, E1, F1, E2, F2
      int h = diag + sc, src = 0;
      if (ne1 > h) { h = ne1; src = 1; }
      if (nf1 > h) { h = nf1; src = 2; }
      if (ne2 > h) { h = ne2; src = 3; }
      if (nf2 > h) { h = nf2; src = 4; }
      if (!valid) h = NEG;
      drow[i] = static_cast<unsigned char>(src | (ce1 ? CONT_E1 : 0) | (cf1 ? CONT_F1 : 0) |
                                           (ce2 ? CONT_E2 : 0) | (cf2 ? CONT_F2 : 0));
      hc[i] = h;
      e1[i] = ne1;
      e2[i] = ne2;
      f1c[i] = nf1;
      f2c[i] = nf2;
      if (valid && i == m - 1 && jv == n - 1) s_scr = h;  // global end cell
      any_valid |= valid ? 1 : 0;
      // max over all M lanes (invalid ones hold NEG), ties to the smaller i
      const long long key = static_cast<long long>(h) * LANE_SPAN + (INT_MAX - i);
      best = key > best ? key : best;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long y = __shfl_down_sync(0xffffffffu, best, o);
      best = y > best ? y : best;
    }
    if (lane == 0) s_key[d & 1][warp] = best;
    // the diagonal's state, bytes and keys are complete
    any_valid = __syncthreads_or(any_valid);
    if (tid == 0 && !dropped) {
      long long k = s_key[d & 1][0];
      for (int x = 1; x < nwarps; ++x) k = s_key[d & 1][x] > k ? s_key[d & 1][x] : k;
      const int low = static_cast<int>(k & 0xffffffffLL);
      const int dmax = static_cast<int>((k - low) / LANE_SPAN);
      const int darg = INT_MAX - low;
      if (dmax > gmax) {
        gmax = dmax;
        gi = darg;
        gj = d - darg;
      }
      if (zdrop >= 0) {
        const int diff = abs((darg - gi) - ((d - darg) - gj));
        if (any_valid && gi >= 0 && gmax - dmax > zdrop + diff * s.ge1) dropped = true;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    out[0 * P + p] = is_global ? s_scr : gmax;
    out[1 * P + p] = gi;
    out[2 * P + p] = gj;
    out[3 * P + p] = dropped ? 1 : 0;
  }
}

}  // namespace

// lens [P, 3] int32 (qlen, tlen, band); scratch: null to keep the state in
// shared memory (36 * M bytes), else [P, 9 * M] int32.
extern "C" int ma_dp_wavefront(const void* q, const void* t, const void* lens, void* dirs,
                               void* out, void* scratch, int P, int M, int N, int match,
                               int mismatch, int go1, int ge1, int go2, int ge2, int zdrop,
                               int is_global, void* stream) {
  const int threads = M >= 1024 ? 1024 : ((M + 31) / 32) * 32;
  const size_t smem = scratch != nullptr ? 0 : static_cast<size_t>(9) * M * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dp_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const Scores s{match, mismatch, go1, ge1, go2, ge2};
  dp_wavefront_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), static_cast<const int*>(lens),
      static_cast<unsigned char*>(dirs), static_cast<int*>(out), static_cast<int*>(scratch), P,
      M, N, s, zdrop, is_global);
  return ma_launch_status();
}
