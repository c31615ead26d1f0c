// Kernel A: the Strip-of-Consideration overlap-vacuum sweep.
//
// Replaces the Pallas kernel ma_tpu/ops/soc_pallas.py `_soc_sweep_kernel`
// (entry `soc_sweep_pallas`). Per read, candidate strips are walked in delta
// order with a monotonic stack (push_back_no_overlap, soc.h:362-404):
// overlapping strips resolve by SoCOrder (length, tie -> higher ambiguity is
// less), the lower strip shrinks through the carried prefix sums, strips
// under min_score drop, and the inner vacuum loop is bounded by K + 2 steps
// (that bound decides `overflow`, so it is kept exactly).
//
// What bounds it on the H100: one short sequential walk per read, i.e.
// latency of dependent loads, not bandwidth or arithmetic (4096 reads x up
// to 256 candidates). The TPU version blocked reads onto lanes and stepped
// all of them in lockstep through VMEM; here each read is one thread that
// advances at its own pace (no lockstep over the batch maximum), its
// [K, 8] stack is its own slice of the output (L1-resident), and candidates
// are read from the [S, B, 7] table as the read reaches them.
#include "common.cuh"

__global__ void soc_sweep_kernel(const int* __restrict__ cand,
                                 const int* __restrict__ n_arr,
                                 const int* __restrict__ min_arr,
                                 int* __restrict__ stack, int* __restrict__ sp_out,
                                 unsigned char* __restrict__ over_out, int S, int B,
                                 int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int* st = stack + static_cast<size_t>(b) * K * 8;
  for (int k = 0; k < K * 8; ++k) st[k] = 0;
  const int n = n_arr[b];
  const int min_score = min_arr[b];
  int sp = 0;
  bool over = false;
  for (int i = 0; i < n && i < S; ++i) {
    const int* c = cand + (static_cast<size_t>(i) * B + b) * 7;
    const int sl = c[0], sa = c[1], we = c[2], pexs = c[3], aexs = c[4];
    const int pend = c[5], aend = c[6];
    // candidates below min score are skipped (stripOfConsideration.cpp:137-141)
    if (!(sl >= min_score && sl > 0)) continue;
    int c_start = i, c_len = sl, c_amb = sa, c_pexs = pexs, c_aexs = aexs;
    for (int it = 0; it < K + 2; ++it) {
      const int sp1 = sp > 0 ? sp - 1 : 0;
      int* top = st + sp1 * 8;
      const int top_end = top[1], top_len = top[2], top_amb = top[3];
      const int top_pexs = top[4], top_pend = top[5];
      const int top_aexs = top[6], top_aend = top[7];
      const bool overlap = sp > 0 && top_end > c_start;
      const bool back_lower =
          (top_len == c_len) ? (top_amb > c_amb) : (top_len < c_len);
      // case A: the back strip is lower -> shrink it to [back_start, c_start)
      const bool case_a = overlap && back_lower;
      const int a_len = c_pexs - top_pexs, a_amb = c_aexs - top_aexs;
      const bool drop_back = case_a && (a_len < min_score || a_len <= 0);
      const bool shrink_back = case_a && !drop_back;
      // case B: the candidate is lower -> shrink it to [back_end, c_end)
      const bool case_b = overlap && !back_lower;
      const int b_len = pend - top_pend, b_amb = aend - top_aend;
      const bool keep_b = case_b && !(b_len < min_score || b_len <= 0);
      if (shrink_back) {
        top[1] = c_start;
        top[2] = a_len;
        top[3] = a_amb;
        top[5] = c_pexs;
        top[7] = c_aexs;
      }
      const int p_start = keep_b ? top_end : c_start;
      const int p_len = keep_b ? b_len : c_len;
      const int p_amb = keep_b ? b_amb : c_amb;
      const int p_pexs = keep_b ? top_pend : c_pexs;
      const int p_aexs = keep_b ? top_aend : c_aexs;
      const bool push = !overlap || shrink_back || keep_b;
      const bool can_push = push && sp < K;
      if (can_push) {
        int* d = st + sp * 8;
        d[0] = p_start;
        d[1] = we;
        d[2] = p_len;
        d[3] = p_amb;
        d[4] = p_pexs;
        d[5] = pend;
        d[6] = p_aexs;
        d[7] = aend;
      }
      sp += static_cast<int>(can_push) - static_cast<int>(drop_back);
      over = over || (push && !can_push);
      c_start = p_start;
      c_len = p_len;
      c_amb = p_amb;
      c_pexs = p_pexs;
      c_aexs = p_aexs;
      if (!drop_back) break;  // resolved: pushed, shrunk-and-pushed, or dropped
    }
  }
  sp_out[b] = sp;
  over_out[b] = over ? 1 : 0;
}

extern "C" int ma_soc_sweep(const void* cand, const void* n, const void* min_score,
                            void* stack, void* sp, void* over, int S, int B, int K,
                            void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  soc_sweep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(n),
      static_cast<const int*>(min_score), static_cast<int*>(stack),
      static_cast<int*>(sp), static_cast<unsigned char*>(over), S, B, K);
  return ma_launch_status();
}
