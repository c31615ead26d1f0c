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
// What bounds it on the H100: the walk of one read is a chain of dependent
// steps (each step reads the stack top the previous one may have written),
// so its time is the longest read's step count times one step's latency;
// the bytes (28 per candidate a read holds, 1 KB of stack per read at
// K = 32) are small. The design puts every step's operands on chip:
// - a warp per read, WARPS reads per block, so 4,096 reads spread over
//   every SM and 256 reads over 64 blocks;
// - the warp stages the read's candidates 32 at a time: each lane loads
//   one 28-byte record, `__ballot_sync` finds the active ones (sl >=
//   min_score and sl > 0) and they are compacted into shared memory, so the
//   walk visits only active candidates. The next chunk's loads are issued
//   before the walk of the current one, and land while it runs;
// - one lane walks the staged chunk; the stack [K, 8] lives in shared
//   memory (zeroed by the warp, so slots past sp hold exactly what the
//   plain version leaves there), its top in registers: a step touches
//   shared memory only to write through a change or to reload the top
//   after a drop;
// - the warp writes the read's [K, 8] stack once at the end, coalesced.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;     // reads per block
constexpr int FIELDS = 8;    // staged per candidate: index, sl, sa, we, pexs, aexs, pend, aend
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

// shared ints per warp: the stack [K, 8], then the staged chunk [8, 32]
__host__ __device__ inline int warp_ints(int K) { return K * 8 + FIELDS * 32; }

__global__ void __launch_bounds__(WARPS * 32)
soc_sweep_kernel(const int* __restrict__ cand, const int* __restrict__ n_arr,
                 const int* __restrict__ min_arr, int* __restrict__ stack,
                 int* __restrict__ sp_out, unsigned char* __restrict__ over_out, int S,
                 int B, int K) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps leave; only warp syncs follow
  int* st = smem + warp * warp_ints(K);
  int* buf = st + K * 8;  // field f of staged slot s at buf[f * 32 + s]
  for (int k = lane; k < K * 8; k += 32) st[k] = 0;
  const int nn = min(n_arr[b], S);
  const int min_score = min_arr[b];
  const unsigned below = (1u << lane) - 1u;

  // the chunk's records, loaded one chunk ahead of the walk
  int r[7];
  auto load = [&](int base) {
    const int i = base + lane;
    if (i < nn) {
      const int* c = cand + (static_cast<size_t>(i) * B + b) * 7;
#pragma unroll
      for (int f = 0; f < 7; ++f) r[f] = __ldg(c + f);
    } else {
      r[0] = 0;  // sl = 0: inactive
    }
  };

  // the walking lane's state: stack pointer, overflow, the top's fields
  int sp = 0;
  bool over = false;
  int t_end = 0, t_len = 0, t_amb = 0, t_pexs = 0, t_pend = 0, t_aexs = 0, t_aend = 0;

  load(0);
  for (int base = 0; base < nn; base += 32) {
    const bool act = base + lane < nn && r[0] >= min_score && r[0] > 0;
    const unsigned mask = __ballot_sync(0xffffffffu, act);
    __syncwarp();  // the walk of the previous chunk has read buf
    if (act) {
      const int s = __popc(mask & below);
      buf[s] = base + lane;
#pragma unroll
      for (int f = 0; f < 7; ++f) buf[(f + 1) * 32 + s] = r[f];
    }
    __syncwarp();
    load(base + 32);
    if (lane == 0) {
      const int na = __popc(mask);
      for (int s = 0; s < na; ++s) {
        int c_start = buf[s], c_len = buf[32 + s], c_amb = buf[64 + s];
        const int we = buf[96 + s];
        int c_pexs = buf[128 + s], c_aexs = buf[160 + s];
        const int pend = buf[192 + s], aend = buf[224 + s];
        for (int it = 0; it < K + 2; ++it) {
          // at sp == 0 the top's fields are never read: overlap is false
          const bool overlap = sp > 0 && t_end > c_start;
          const bool back_lower = (t_len == c_len) ? (t_amb > c_amb) : (t_len < c_len);
          // case A: the back strip is lower -> shrink it to [back_start, c_start)
          const bool case_a = overlap && back_lower;
          const int a_len = c_pexs - t_pexs, a_amb = c_aexs - t_aexs;
          const bool drop_back = case_a && (a_len < min_score || a_len <= 0);
          const bool shrink_back = case_a && !drop_back;
          // case B: the candidate is lower -> shrink it to [back_end, c_end)
          const bool case_b = overlap && !back_lower;
          const int b_len = pend - t_pend, b_amb = aend - t_aend;
          const bool keep_b = case_b && !(b_len < min_score || b_len <= 0);
          const int p_start = keep_b ? t_end : c_start;
          const int p_len = keep_b ? b_len : c_len;
          const int p_amb = keep_b ? b_amb : c_amb;
          const int p_pexs = keep_b ? t_pend : c_pexs;
          const int p_aexs = keep_b ? t_aend : c_aexs;
          if (shrink_back) {
            int* top = st + (sp - 1) * 8;
            top[1] = t_end = c_start;
            top[2] = t_len = a_len;
            top[3] = t_amb = a_amb;
            top[5] = t_pend = c_pexs;
            top[7] = t_aend = c_aexs;
          }
          const bool push = !overlap || shrink_back || keep_b;
          if (push && sp < K) {
            int* d = st + sp * 8;
            d[0] = p_start;
            d[1] = t_end = we;
            d[2] = t_len = p_len;
            d[3] = t_amb = p_amb;
            d[4] = t_pexs = p_pexs;
            d[5] = t_pend = pend;
            d[6] = t_aexs = p_aexs;
            d[7] = t_aend = aend;
            ++sp;
          } else if (push) {
            over = true;
          }
          c_start = p_start;
          c_len = p_len;
          c_amb = p_amb;
          c_pexs = p_pexs;
          c_aexs = p_aexs;
          if (!drop_back) break;  // resolved: pushed, shrunk-and-pushed, or dropped
          if (--sp > 0) {
            const int* top = st + (sp - 1) * 8;
            t_end = top[1];
            t_len = top[2];
            t_amb = top[3];
            t_pexs = top[4];
            t_pend = top[5];
            t_aexs = top[6];
            t_aend = top[7];
          }
        }
      }
    }
  }
  __syncwarp();
  int* out = stack + static_cast<size_t>(b) * K * 8;
  for (int k = lane; k < K * 8; k += 32) out[k] = st[k];
  if (lane == 0) {
    sp_out[b] = sp;
    over_out[b] = over ? 1 : 0;
  }
}

}  // namespace

// Shared memory a block needs for K stack slots, or -1 where K does not fit.
extern "C" long long ma_soc_sweep_smem_bytes(int K) {
  if (K < 1) return -1;
  const long long bytes = static_cast<long long>(WARPS) * warp_ints(K) * 4;
  return bytes <= SMEM_MAX ? bytes : -1;
}

extern "C" int ma_soc_sweep(const void* cand, const void* n, const void* min_score,
                            void* stack, void* sp, void* over, int S, int B, int K,
                            void* stream) {
  const long long smem = ma_soc_sweep_smem_bytes(K);
  if (smem < 0 || B < 1 || S < 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        soc_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int blocks = (B + WARPS - 1) / WARPS;
  soc_sweep_kernel<<<blocks, WARPS * 32, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(n),
      static_cast<const int*>(min_score), static_cast<int*>(stack),
      static_cast<int*>(sp), static_cast<unsigned char*>(over), S, B, K);
  return ma_launch_status();
}
