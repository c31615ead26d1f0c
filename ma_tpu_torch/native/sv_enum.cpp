// MSV jump-enumeration front end: feasible-SoC extraction -> rectangle
// reseeding -> maximal seed extension -> per-read seed union, in C++.
//
// Native port of the repo's OWN host modules (the Python implementations
// remain the test oracles and must stay bit-identical):
//   ma_tpu_torch/msv/pipeline.py   feasible_socs
//   ma_tpu_torch/ops/hash_seeding.py reseed_gaps / reseed_rectangle /
//                              hash_map_seeding / lump_diagonal /
//                              kmer_size_for_rectangle
//   ma_tpu_torch/ops/extend_host.py  extend_seeds
// Reference roles: GetAllFeasibleSoCsAsSet (stripOfConsideration.h:234-285),
// SvJumpsFromSeeds reseeding (svJumpsFromSeeds.cpp:230-330, .h:605-691),
// SeedExtender (seedFilters.h:70-160). The reference runs this front end in
// C++ threads; our per-SoC Python loop was the 97-reads/s wall (VERDICT r4
// item 4) — this module replaces it at unchanged output.
//
// Plain C ABI (no pybind11 in this environment); driven via ctypes from
// ma_tpu_torch/native/sv_enum.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Seed {
  int64_t q, l, r;
  uint8_t fw;
  int64_t nt;
  bool operator<(const Seed& o) const {
    if (q != o.q) return q < o.q;
    if (l != o.l) return l < o.l;
    if (r != o.r) return r < o.r;
    if (fw != o.fw) return fw < o.fw;
    return nt < o.nt;
  }
  bool operator==(const Seed& o) const {
    return q == o.q && l == o.l && r == o.r && fw == o.fw && nt == o.nt;
  }
};

inline int64_t ref_end(const Seed& s) { return s.fw ? s.r + s.l : s.r - s.l; }

// kmer_size_for_rectangle: smallest k with w*h/4^k <= t (same double math
// as math.log(area/t, 4)).
inline int kmer_size_for_rectangle(int64_t w, int64_t h, double t) {
  double area = (double)std::max<int64_t>(w, 1) * (double)std::max<int64_t>(h, 1);
  int k = (int)std::ceil(std::log(area / t) / std::log(4.0));
  return std::max(3, k);
}

struct Match {
  int64_t a, l, b;
};

// hash_map_seeding + lump_diagonal, for tiny windows (<= max_size bases a
// side). Emits matches ordered by (diagonal, a) with same-diagonal
// overlapping matches merged — identical to the numpy path's output order.
void window_matches(const uint8_t* qa, int64_t na, const uint8_t* qb,
                    int64_t nb, int k, std::vector<Match>& out) {
  out.clear();
  int64_t ma = na - k + 1, mb = nb - k + 1;
  if (ma <= 0 || mb <= 0) return;
  const int64_t BAD = (int64_t)2 << 60;
  auto pack = [&](const uint8_t* s, int64_t n, std::vector<int64_t>& v) {
    v.assign(n, 0);
    for (int64_t i = 0; i < n; i++) {
      int64_t val = 0;
      bool bad = false;
      for (int j = 0; j < k; j++) {
        uint8_t c = s[i + j];
        val = (val << 2) | (c < 4 ? c : 0);
        bad |= c >= 4;
      }
      v[i] = bad ? BAD : val;
    }
  };
  std::vector<int64_t> ka, kb;
  pack(qa, ma, ka);
  pack(qb, mb, kb);
  // sort B positions by (value, position)
  std::vector<int64_t> order(mb);
  for (int64_t j = 0; j < mb; j++) order[j] = j;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) { return kb[x] < kb[y]; });
  std::vector<int64_t> sorted_b(mb);
  for (int64_t j = 0; j < mb; j++) sorted_b[j] = kb[order[j]];
  std::vector<Match> raw;
  for (int64_t i = 0; i < ma; i++) {
    if (ka[i] >= BAD) continue;
    auto lo = std::lower_bound(sorted_b.begin(), sorted_b.end(), ka[i]) -
              sorted_b.begin();
    auto hi = std::upper_bound(sorted_b.begin(), sorted_b.end(), ka[i]) -
              sorted_b.begin();
    for (int64_t p = lo; p < hi; p++) raw.push_back({i, k, order[p]});
  }
  // lump_diagonal: sort by (diag, a), merge same-diagonal overlaps
  std::sort(raw.begin(), raw.end(), [](const Match& x, const Match& y) {
    int64_t dx = x.b - x.a, dy = y.b - y.a;
    if (dx != dy) return dx < dy;
    return x.a < y.a;
  });
  for (const Match& m : raw) {
    if (!out.empty() && out.back().b - out.back().a == m.b - m.a &&
        out.back().a + out.back().l >= m.a) {
      Match& p = out.back();
      p.l = std::max(p.l, m.a + m.l - p.a);
    } else {
      out.push_back(m);
    }
  }
}

struct PackView {
  const uint8_t* ref;
  int64_t L;  // unpacked_size_forward_strand
  const int64_t* cstarts;
  const int64_t* clens;
  int64_t ncontig;
  int64_t contig_of(int64_t pos) const {
    // searchsorted(starts, pos, 'right') - 1 for forward coords
    int64_t lo = 0, hi = ncontig;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cstarts[mid] <= pos)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo - 1;
  }
};

// reseed_rectangle (hash_seeding.py:89-117)
void reseed_rectangle(const uint8_t* query, int64_t qlen, const PackView& pk,
                      int64_t q_lo, int64_t q_hi, int64_t r_lo, int64_t r_hi,
                      double t, int64_t max_size, int64_t nt,
                      std::vector<Seed>& out, std::vector<Match>& scratch) {
  int64_t w = r_hi - r_lo, h = q_hi - q_lo;
  if (w <= 0 || h <= 0 || w > max_size || h > max_size) return;
  int k = kmer_size_for_rectangle(w, h, t);
  if (k > w || k > h) return;
  const uint8_t* qseg = query + q_lo;
  const uint8_t* rseg = pk.ref + r_lo;
  window_matches(qseg, h, rseg, w, k, scratch);
  for (const Match& m : scratch)
    out.push_back({q_lo + m.a, m.l, r_lo + m.b, 1, nt});
  // reverse strand: revcomp of the window (N stays N)
  std::vector<uint8_t> rrev(w);
  for (int64_t i = 0; i < w; i++) {
    uint8_t c = rseg[w - 1 - i];
    rrev[i] = c < 4 ? (uint8_t)(3 - c) : c;
  }
  window_matches(qseg, h, rrev.data(), w, k, scratch);
  for (const Match& m : scratch)
    out.push_back({q_lo + m.a, m.l, r_hi - 1 - m.b, 0, nt});
}

// reseed_gaps (hash_seeding.py:119-165). `piece` must be sorted by q
// (feasible-SoC pieces are). Appends originals first, then recovered.
void reseed_gaps(const std::vector<Seed>& piece, const uint8_t* query,
                 int64_t qlen, const PackView& pk, double t, int64_t max_size,
                 int64_t padding, std::vector<Seed>& out,
                 std::vector<Match>& scratch) {
  out.clear();
  for (const Seed& s : piece)
    if (s.l > 0) out.push_back(s);
  if (out.empty()) return;
  size_t n_orig = out.size();
  // copy by value: reseed_rectangle push_backs into `out`, which can
  // reallocate and would invalidate references into it
  const Seed first = out[0];
  const Seed last = out[n_orig - 1];
  int64_t fa = first.fw ? first.r : ref_end(first);
  reseed_rectangle(query, qlen, pk, 0, first.q, std::max<int64_t>(fa - padding, 0),
                   fa, t, max_size, first.nt, out, scratch);
  int64_t lb = last.fw ? ref_end(last) : last.r;
  reseed_rectangle(query, qlen, pk, last.q + last.l, qlen, lb,
                   std::min(lb + padding, pk.L), t, max_size, last.nt, out,
                   scratch);
  for (size_t i = 0; i + 1 < n_orig; i++) {
    const Seed a = out[i];
    const Seed b = out[i + 1];
    int64_t q_lo = a.q + a.l, q_hi = b.q;
    int64_t ra = ref_end(a), rb = b.r;
    int64_t r_lo = std::min(ra, rb), r_hi = std::max(ra, rb);
    reseed_rectangle(query, qlen, pk, q_lo, q_hi, std::max<int64_t>(r_lo, 0),
                     std::min(r_hi, pk.L), t, max_size, std::min(a.nt, b.nt),
                     out, scratch);
  }
}

// extend_seeds (extend_host.py): maximal exact-match extension, contig
// clamped; reverse seeds compare query vs (uint8)(3 - ref) with mirrored
// coordinates (matches the numpy uint8 underflow semantics for N).
void extend_seeds(std::vector<Seed>& seeds, const uint8_t* query, int64_t qlen,
                  const PackView& pk) {
  for (Seed& s : seeds) {
    int64_t cid = pk.contig_of(std::min(s.r, pk.L - 1));
    int64_t c_lo = pk.cstarts[cid];
    int64_t c_hi = c_lo + pk.clens[cid];
    if (s.fw) {
      int64_t lim = std::min(s.q, s.r - c_lo);
      int64_t n = 0;
      while (n < lim && query[s.q - 1 - n] == pk.ref[s.r - 1 - n]) n++;
      s.q -= n;
      s.l += n;
      s.r -= n;
      int64_t end_q = s.q + s.l, end_r = s.r + s.l;
      lim = std::min(qlen - end_q, c_hi - end_r);
      n = 0;
      while (n < lim && query[end_q + n] == pk.ref[end_r + n]) n++;
      s.l += n;
    } else {
      int64_t lim = std::min(s.q, c_hi - 1 - s.r);
      int64_t n = 0;
      while (n < lim &&
             query[s.q - 1 - n] == (uint8_t)(3 - pk.ref[s.r + 1 + n]))
        n++;
      s.q -= n;
      s.l += n;
      s.r += n;
      int64_t end_q = s.q + s.l, end_r = s.r - s.l;
      lim = std::min(qlen - end_q, end_r - c_lo + 1);
      n = 0;
      while (n < lim &&
             query[end_q + n] == (uint8_t)(3 - pk.ref[end_r - n]))
        n++;
      s.l += n;
    }
  }
}

}  // namespace

extern "C" {

// Per-batch enumeration. Returns total seeds written, or -(needed) when
// `cap` is too small (caller grows and retries). out_cnt[b] = union size of
// read b (0 for reads with no feasible SoC).
int64_t sv_enum(
    // SoC batch (host arrays): seeds [B,S], soc windows [B,C]
    const int32_t* q, const int32_t* l, const int32_t* r, const uint8_t* fw,
    const uint8_t* va, const int32_t* soc_start, const int32_t* soc_end,
    const int32_t* soc_score, const int32_t* n_socs, int64_t B, int64_t S,
    int64_t C,
    // reads
    const uint8_t* seqs, const int32_t* lens, int64_t Lpad,
    // pack
    const uint8_t* ref, int64_t reflen, const int64_t* cstarts,
    const int64_t* clens, int64_t ncontig,
    // params
    int64_t min_nt, int64_t soc_height, int32_t do_reseed, double t,
    int64_t max_size, int64_t padding,
    // outputs
    int64_t cap, int64_t* out_q, int64_t* out_l, int64_t* out_r,
    uint8_t* out_fw, int64_t* out_nt, int64_t* out_cnt) {
  PackView pk{ref, reflen, cstarts, clens, ncontig};
  int64_t total = 0;
  std::vector<Seed> piece, work, uni;
  std::vector<Match> scratch;
  for (int64_t b = 0; b < B; b++) {
    uni.clear();
    const uint8_t* query = seqs + b * Lpad;
    int64_t qlen = lens[b];
    int64_t ns = n_socs[b];
    for (int64_t si = 0; si < ns; si++) {
      int64_t nt = soc_score[b * C + si];
      if (nt < min_nt) continue;
      piece.clear();
      for (int64_t m = soc_start[b * C + si]; m < soc_end[b * C + si]; m++) {
        if (!va[b * S + m]) continue;
        piece.push_back({q[b * S + m], l[b * S + m], r[b * S + m],
                         fw[b * S + m], nt});
      }
      // python: sorted(key=lambda t: t[0]) — stable by q only, slot order
      // preserved for equal q
      std::stable_sort(piece.begin(), piece.end(),
                       [](const Seed& x, const Seed& y) { return x.q < y.q; });
      if (piece.empty()) continue;
      // split on query gaps > soc_height; keep pieces with >= min_nt
      size_t start = 0;
      int64_t cur_nt = 0;
      int64_t max_q = piece[0].q + piece[0].l;
      std::vector<std::pair<size_t, size_t>> ranges;
      for (size_t i = 0; i < piece.size(); i++) {
        if (piece[i].q > max_q + soc_height) {
          if (cur_nt >= min_nt) ranges.push_back({start, i});
          start = i;
          cur_nt = 0;
        }
        cur_nt += piece[i].l;
        max_q = std::max(max_q, piece[i].q + piece[i].l);
      }
      if (cur_nt >= min_nt) ranges.push_back({start, piece.size()});
      for (auto [lo, hi] : ranges) {
        std::vector<Seed> sub(piece.begin() + lo, piece.begin() + hi);
        if (do_reseed) {
          reseed_gaps(sub, query, qlen, pk, t, max_size, padding, work,
                      scratch);
        } else {
          work = sub;
        }
        extend_seeds(work, query, qlen, pk);
        uni.insert(uni.end(), work.begin(), work.end());
      }
    }
    std::sort(uni.begin(), uni.end());
    uni.erase(std::unique(uni.begin(), uni.end()), uni.end());
    out_cnt[b] = (int64_t)uni.size();
    if (total + (int64_t)uni.size() > cap) return -(total + (int64_t)uni.size());
    for (const Seed& s : uni) {
      out_q[total] = s.q;
      out_l[total] = s.l;
      out_r[total] = s.r;
      out_fw[total] = s.fw;
      out_nt[total] = s.nt;
      total++;
    }
  }
  return total;
}

}  // extern "C"
