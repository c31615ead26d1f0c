// The FM-walk kernel: maximally-spanning seeding of a batch of reads.
//
// Replaces the XLA while_loop of ma_tpu/ops/seeding.py:102
// `max_spanning_seeding` (the port's plain version: the eager step loop of
// ma_tpu_torch/ops/seeding.py). Each thread runs one read's state machine
// from its first step to P_DONE or to iter_cap, in one launch; the loop
// `for (it = 0; it < iter_cap && phase != P_DONE; ++it)` is the plain
// loop's step for that read, and since a read in P_DONE changes no output
// of a step, stopping a read there gives the plain loop's output exactly.
//
// What bounds it on the H100: not bytes. A b4096 batch makes about 4,096 x
// 310 live steps x 2 occ lookups of 48 bytes (120 MB, about 40 us at HBM
// speed) from an index of a few MB that stays in the 50 MB L2. A step's two
// lookups depend on the interval the previous step made, so a read is a
// chain of dependent L2 round trips, and the batch takes as long as its
// longest read's chain (about 400 steps). Hence a thread per read: the
// reads' chains run side by side, a warp per block so that 4,096 reads
// spread over 128 SMs, and each step keeps the chain short:
// - the state (phase, area, center, cursor, interval, segment bounds,
//   covered area, stack pointer) lives in registers; the interval stack in
//   shared memory, a column per thread;
// - `occ_blocks` packs a 128-row block into one 64-byte line (4 int32
//   checkpoints, 8 uint32 BWT words): a lookup is 3 independent 16-byte
//   loads, and a step's two lookups are issued together;
// - the count in a block is three popcounts a word (low bits, high bits,
//   both) under the row's mask; the count of A is what is left.
#include "common.cuh"

namespace {

constexpr int THREADS = 32;  // reads per block
constexpr int SMEM_MAX = 48 * 1024;  // dynamic shared memory a block gets without opting in

constexpr int P_NEW_CENTER = 0;
constexpr int P_RIGHT1 = 1;
constexpr int P_LEFT1 = 2;  // (3, P_INIT2 of the plain version, is never entered)
constexpr int P_LEFT2 = 4;
constexpr int P_RIGHT2 = 5;
constexpr int P_SPLIT = 6;
constexpr int P_DONE = 7;

struct Sai {
  int start, start_rc, size;
};

__device__ __forceinline__ Sai rev_comp(Sai a) { return {a.start_rc, a.start, a.size}; }

__device__ __forceinline__ int comp(int c) { return c < 4 ? 3 - c : c; }

__device__ __forceinline__ int pick4(int a0, int a1, int a2, int a3, int i) {
  return i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
}

// counts of A, C, G, T in BWT rows [0..k]; k < 0 gives zeros
__device__ __forceinline__ void occ4(const int4* __restrict__ blocks, int primary, int k,
                                     int& n0, int& n1, int& n2, int& n3) {
  const int kk = max(k - (k >= primary ? 1 : 0), 0);
  const int4* p = blocks + static_cast<size_t>(kk >> 7) * 4;
  const int4 cp = __ldg(p);
  const int4 wa = __ldg(p + 1);
  const int4 wb = __ldg(p + 2);
  const unsigned w[8] = {static_cast<unsigned>(wa.x), static_cast<unsigned>(wa.y),
                         static_cast<unsigned>(wa.z), static_cast<unsigned>(wa.w),
                         static_cast<unsigned>(wb.x), static_cast<unsigned>(wb.y),
                         static_cast<unsigned>(wb.z), static_cast<unsigned>(wb.w)};
  const int off = kk & 127;
  int nlo = 0, nhi = 0, nboth = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int keep = off + 1 - 16 * j;  // crumbs of word j in rows [0..off]
    const unsigned m = keep >= 16 ? 0x55555555u
                       : keep <= 0 ? 0u
                                   : 0x55555555u & ((1u << (2 * keep)) - 1u);
    const unsigned lo = w[j] & m, hi = (w[j] >> 1) & m;
    nlo += __popc(lo);
    nhi += __popc(hi);
    nboth += __popc(lo & hi);
  }
  const bool z = k < 0;
  n0 = z ? 0 : cp.x + off + 1 - nlo - nhi + nboth;
  n1 = z ? 0 : cp.y + nlo - nboth;
  n2 = z ? 0 : cp.z + nhi - nboth;
  n3 = z ? 0 : cp.w + nboth;
}

// l2: the first-column offsets L2[0..4], in registers (indexed by selects)
__device__ __forceinline__ Sai init_interval(const int (&l2)[5], int c) {
  if (c >= 4) return {0, 0, 0};
  const int cc = max(c, 0);
  const int at = pick4(l2[0], l2[1], l2[2], l2[3], cc);
  return {at + 1, pick4(l2[3], l2[2], l2[1], l2[0], cc) + 1,
          pick4(l2[1], l2[2], l2[3], l2[4], cc) - at};
}

// backward extension by c with the reverse-complement interval
__device__ __forceinline__ Sai extend_backward(const int4* __restrict__ blocks, const int (&l2)[5],
                                               int primary, Sai ik, int c) {
  if (!(c < 4 && ik.size > 0)) return {0, 0, 0};
  int k0, k1, k2, k3, l0, l1, l2_, l3;
  occ4(blocks, primary, ik.start - 1, k0, k1, k2, k3);
  occ4(blocks, primary, ik.start + ik.size - 1, l0, l1, l2_, l3);
  const int s0 = l0 - k0, s1 = l1 - k1, s2 = l2_ - k2, s3 = l3 - k3;
  const bool straddles = ik.start <= primary && ik.start + ik.size > primary;
  const int cc = max(c, 0);
  // start_rc: the base plus the counts of the chars above c
  const int rc = ik.start_rc + (straddles ? 1 : 0) + (cc < 3 ? s3 : 0) + (cc < 2 ? s2 : 0) +
                 (cc < 1 ? s1 : 0);
  return {pick4(l2[0], l2[1], l2[2], l2[3], cc) + pick4(k0, k1, k2, k3, cc) + 1, rc,
          pick4(s0, s1, s2, s3, cc)};
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fmd_seed_kernel(const int4* __restrict__ blocks, const int* __restrict__ l2_g,
                const T* __restrict__ seqs, const int* __restrict__ lens,
                int* __restrict__ q_start, int* __restrict__ q_size, int* __restrict__ sai_start,
                int* __restrict__ sai_rc, int* __restrict__ sai_size, int* __restrict__ n_segs_out,
                unsigned char* __restrict__ over_out, int* __restrict__ steps_out, int B, int L,
                int S, int K, int min_amb, int max_amb, int iter_cap, int primary) {
  extern __shared__ int smem[];  // stack slot j of thread t: s at [2j][t], e at [2j + 1][t]
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int l2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) l2[c] = __ldg(l2_g + c);
  const T* q = seqs + static_cast<size_t>(b) * L;
  auto q_at = [&](int idx) { return static_cast<int>(q[min(max(idx, 0), L - 1)]); };
  int* stk = smem + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * S;

  const int len = lens[b];
  int phase = len > 0 ? P_NEW_CENTER : P_DONE;
  int s = 0, e = len, center = 0, i = 0;
  Sai ik = {0, 0, 0};
  int st1 = 0, en1 = 0, st2 = 0, en2 = 0, cov_s = 0, cov_e = 0, sp = 0, nseg = 0;
  bool over = false;

  auto emplace = [&](int qs, int qsize, Sai a) {
    if (nseg < S) {
      q_start[row + nseg] = qs;
      q_size[row + nseg] = qsize;
      sai_start[row + nseg] = a.start;
      sai_rc[row + nseg] = a.start_rc;
      sai_size[row + nseg] = a.size;
      ++nseg;
    } else {
      over = true;
    }
  };

  int it = 0;
  for (; it < iter_cap && phase != P_DONE; ++it) {
    if (phase == P_RIGHT1 || phase == P_LEFT1 || phase == P_LEFT2 || phase == P_RIGHT2) {
      // right loops extend by complement(q[i]), left loops by q[i]
      const bool right = phase == P_RIGHT1 || phase == P_RIGHT2;
      const bool in_bounds = right ? i < len : i >= 0;
      bool step_ok = false;
      Sai ok = {0, 0, 0};
      if (in_bounds) {  // out of bounds the plain version's extension is not read
        const int qi = q_at(i);
        ok = extend_backward(blocks, l2, primary, ik, right ? comp(qi) : qi);
        step_ok = !(ok.size <= 0 || (ok.size <= min_amb && ik.size <= max_amb));
      }
      if (step_ok) {
        ik = ok;
        if (phase == P_RIGHT1) en1 = i;
        else if (phase == P_LEFT1) st1 = i;
        else if (phase == P_LEFT2) st2 = i;
        else en2 = i;
        i += right ? 1 : -1;
      } else if (phase == P_RIGHT1) {  // swap to revcomp, go left from center - 1
        phase = P_LEFT1;
        ik = rev_comp(ik);
        i = center - 1;
        st1 = center;
      } else if (phase == P_LEFT1) {  // emplace segment 1, init the second block
        emplace(st1, en1 - st1, ik);
        ik = init_interval(l2, q_at(center));
        phase = P_LEFT2;
        i = center - 1;
        st2 = center;
      } else if (phase == P_LEFT2) {  // swap to revcomp, go right from center + 1
        phase = P_RIGHT2;
        ik = rev_comp(ik);
        i = center + 1;
        en2 = center;
      } else {  // P_RIGHT2: maybe emplace segment 2 (its revcomp), covered area
        if (!(st1 == st2 && en1 == en2)) emplace(st2, en2 - st2, rev_comp(ik));
        cov_s = min(st1, st2);
        cov_e = max(en1, en2);
        phase = P_SPLIT;
      }
    } else if (phase == P_NEW_CENTER) {  // pick the center, init the first interval
      const int ctr = s + ((e - s) >> 1);  // floor, as the plain version's //
      const int qc = q_at(ctr);
      ik = init_interval(l2, comp(qc));
      center = ctr;
      i = ctr + 1;
      en1 = ctr;
      if (qc >= 4 || ik.size == 0) {  // N / absent char: covered = [center, center + 1)
        cov_s = ctr;
        cov_e = ctr + 1;
        phase = P_SPLIT;
      } else {
        phase = P_RIGHT1;
      }
    } else {  // P_SPLIT: push [s, cov_s), continue right from cov_e or pop
      if (cov_s != 0 && s + 1 < cov_s) {
        if (sp < K) {
          stk[(2 * sp) * THREADS] = s;
          stk[(2 * sp + 1) * THREADS] = cov_s;
          ++sp;
        } else {
          over = true;
        }
      }
      if (e > cov_e + 1) {
        s = cov_e;
        phase = P_NEW_CENTER;
      } else if (sp > 0) {
        --sp;
        s = stk[(2 * sp) * THREADS];
        e = stk[(2 * sp + 1) * THREADS];
        phase = P_NEW_CENTER;
      } else {
        phase = P_DONE;
      }
    }
  }
  // reads still live at the iteration cap are overflowed
  over = over || phase != P_DONE;
  for (int j = nseg; j < S; ++j) {
    q_start[row + j] = 0;
    q_size[row + j] = 0;
    sai_start[row + j] = 0;
    sai_rc[row + j] = 0;
    sai_size[row + j] = 0;
  }
  n_segs_out[b] = nseg;
  over_out[b] = over ? 1 : 0;
  if (steps_out != nullptr) steps_out[b] = it;
}

inline long long smem_bytes(int K) {
  return static_cast<long long>(K) * 2 * THREADS * static_cast<long long>(sizeof(int));
}

template <typename T>
int launch(const void* blocks, const void* l2, const void* seqs, const void* lens, void* q_start,
           void* q_size, void* sai_start, void* sai_rc, void* sai_size, void* n_segs, void* over,
           void* steps, int B, int L, int S, int K, int min_amb, int max_amb, int iter_cap,
           int primary, cudaStream_t stream) {
  fmd_seed_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, static_cast<size_t>(smem_bytes(K)),
                       stream>>>(
      static_cast<const int4*>(blocks), static_cast<const int*>(l2), static_cast<const T*>(seqs),
      static_cast<const int*>(lens), static_cast<int*>(q_start), static_cast<int*>(q_size),
      static_cast<int*>(sai_start), static_cast<int*>(sai_rc), static_cast<int*>(sai_size),
      static_cast<int*>(n_segs), static_cast<unsigned char*>(over), static_cast<int*>(steps), B,
      L, S, K, min_amb, max_amb, iter_cap, primary);
  return ma_launch_status();
}

}  // namespace

// Dynamic shared memory of a block for K stack slots a read, or -1 where it
// does not fit.
extern "C" long long ma_fmd_seed_smem_bytes(int K) {
  const long long bytes = smem_bytes(K);
  return K < 1 || bytes > SMEM_MAX ? -1 : bytes;
}

// seqs: [B, L] codes, uint8 (code_bytes 1, the aligner's) or int32
// (code_bytes 4). The outputs are [B, S] int32 planes, n_segs [B] int32,
// overflow [B] bytes and, unless steps is null, each read's step count [B]
// int32; every element is written.
extern "C" int ma_fmd_seed(const void* blocks, const void* l2, const void* seqs,
                           const void* lens, void* q_start, void* q_size, void* sai_start,
                           void* sai_rc, void* sai_size, void* n_segs, void* over, void* steps,
                           int B, int L, int code_bytes, int S, int K, int min_amb, int max_amb,
                           int iter_cap, int primary, cudaStream_t stream) {
  if (code_bytes == 1)
    return launch<unsigned char>(blocks, l2, seqs, lens, q_start, q_size, sai_start, sai_rc,
                                 sai_size, n_segs, over, steps, B, L, S, K, min_amb, max_amb,
                                 iter_cap, primary, stream);
  if (code_bytes == 4)
    return launch<int>(blocks, l2, seqs, lens, q_start, q_size, sai_start, sai_rc, sai_size,
                       n_segs, over, steps, B, L, S, K, min_amb, max_amb, iter_cap, primary,
                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
