// Native SAM tail: mapping quality + record formatting over the assembled
// alignment arrays from finish.cpp, emitting final SAM text in one pass.
//
// Ports (and must stay byte-identical to) the Python implementations,
// which remain the test oracle:
//   * ma_tpu_torch/pipeline/quality.py  mapping_quality        (reference:
//     libs/ma/src/module/mappingQuality.cpp:11-135)
//   * ma_tpu_torch/containers/alignment.py  sam_flag/sam_position/cigar/
//     overlap/larger                 (reference: libs/ma/inc/ma/container/
//     alignment.h:593-843)
//   * ma_tpu_torch/io/sam.py  sam_record                       (reference:
//     libs/ma/inc/ma/module/fileWriter.h:366-470)
//
// Scope: the plain record path (no NGMLR tag emulation, no CG-tag-length
// cigars, no SmallInversions rescues) — anything else returns rc=2 and the
// caller falls back to the Python writer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// op codes as written by finish.cpp: 0=s(seed) 1='=' 2=X 3=I 4=D
constexpr int OP_SEED = 0, OP_MATCH = 1, OP_MISMATCH = 2, OP_INS = 3,
              OP_DEL = 4;

struct Aln {
  int64_t begin_ref, end_ref, begin_q, end_q, score;
  int64_t run_lo, run_hi;  // into out_op/out_len
  int32_t soc;
  bool secondary = false, supplementary = false;
  double mapq = 0.0;
};

struct Ctx {
  const uint8_t* op;
  const int32_t* len;
};

int64_t num_seeds(const Ctx& c, const Aln& a) {
  int64_t n = 0;
  for (int64_t k = a.run_lo; k < a.run_hi; ++k)
    if (c.op[k] == OP_SEED) ++n;
  return n;
}

// query-interval overlap fraction (alignment.py overlap): intervals of
// non-I, non-D runs clipped to the shared [s, e) window
double overlap_frac(const Ctx& c, const Aln& a, const Aln& b) {
  int64_t s = std::max(a.begin_q, b.begin_q);
  int64_t e = std::min(a.end_q, b.end_q);
  if (s >= e) return 0.0;
  auto runs = [&](const Aln& x, std::vector<std::pair<int64_t, int64_t>>& out) {
    int64_t q = x.begin_q;
    for (int64_t k = x.run_lo; k < x.run_hi; ++k) {
      int opk = c.op[k];
      int64_t sz = c.len[k];
      if (opk == OP_DEL) continue;
      if (opk != OP_INS) out.emplace_back(q, q + sz);
      q += sz;
    }
  };
  std::vector<std::pair<int64_t, int64_t>> ra, rb;
  runs(a, ra);
  runs(b, rb);
  int64_t ov = 0;
  for (auto& [a0, a1] : ra)
    for (auto& [b0, b1] : rb) {
      int64_t lo = std::max({a0, b0, s});
      int64_t hi = std::min({a1, b1, e});
      if (lo < hi) ov += hi - lo;
    }
  int64_t denom =
      std::max(a.end_q, b.end_q) - std::min(a.begin_q, b.begin_q);
  return denom ? double(ov) / double(denom) : 0.0;
}

// output ordering (alignment.h larger:819-843)
bool larger(const Aln& a, const Aln& b) {
  int ua = a.secondary ? 2 : (a.supplementary ? 1 : 0);
  int ub = b.secondary ? 2 : (b.supplementary ? 1 : 0);
  if (ua != ub) return ua < ub;
  if (a.score == b.score) return a.soc < b.soc;
  return a.score > b.score;
}

struct Writer {
  uint8_t* buf;
  int64_t cap;
  int64_t n = 0;
  bool over = false;
  inline void put(char ch) {
    if (n < cap)
      buf[n] = (uint8_t)ch;
    else
      over = true;
    ++n;
  }
  inline void bytes(const uint8_t* p, int64_t m) {
    if (n + m <= cap)
      memcpy(buf + n, p, m);
    else
      over = true;
    n += m;
  }
  inline void str(const char* s) { bytes((const uint8_t*)s, (int64_t)strlen(s)); }
  inline void num(int64_t v) {
    char tmp[24];
    int m = snprintf(tmp, sizeof tmp, "%lld", (long long)v);
    bytes((const uint8_t*)tmp, m);
  }
};

const char BASE[] = "ACGTN";

}  // namespace

extern "C" int sam_emit(
    const uint8_t* out_op, const int32_t* out_len, const int64_t* out_off,
    const int64_t* out_meta,  // [n_sets][6]
    const int32_t* set_read, const int32_t* set_soc, int64_t n_sets,
    int64_t n_reads, const uint8_t* seqs, int64_t seq_stride,
    const int32_t* qlen, const uint8_t* names, const int64_t* name_off,
    const uint8_t* quals, const int64_t* qual_off, const int64_t* ctg_starts,
    int64_t n_ctg, int64_t L_fwd, const uint8_t* ctg_names,
    const int64_t* ctg_name_off, int64_t match, int64_t max_supplementary,
    double max_overlap, int64_t report_n, int64_t min_score,
    int64_t soft_clip, int64_t use_m, int64_t omit_sec, int64_t omit_sup,
    uint8_t* buf, int64_t buf_cap, int64_t* out_n_bytes, int64_t* out_n_recs) {
  Ctx ctx{out_op, out_len};
  Writer w{buf, buf_cap};
  int64_t n_recs = 0;

  std::vector<Aln> alns;
  std::vector<uint8_t> rc_seq;  // scratch for reverse-complement
  int64_t si = 0;  // sets are in ascending set_read order (CSR over reads)
  for (int64_t b = 0; b < n_reads; ++b) {
    alns.clear();
    for (; si < n_sets && set_read[si] == b; ++si) {
      const int64_t* m = out_meta + 6 * si;
      if (!m[5]) continue;
      Aln a;
      a.begin_ref = m[0];
      a.end_ref = m[1];
      a.begin_q = m[2];
      a.end_q = m[3];
      a.score = m[4];
      a.run_lo = out_off[si];
      a.run_hi = out_off[si + 1];
      a.soc = set_soc[si];
      if (a.run_hi - a.run_lo >= 0x10000) return 2;  // CG-tag territory
      alns.push_back(a);
    }
    if (alns.empty()) continue;
    int64_t L = qlen[b];

    // ---- mapping quality (quality.py, byte-for-byte semantics)
    std::stable_sort(alns.begin(), alns.end(),
                     [](const Aln& a, const Aln& b) { return a.score > b.score; });
    Aln& first = alns[0];
    int64_t n_supp = 0;
    for (size_t i = 1; i < alns.size(); ++i) {
      Aln& a = alns[i];
      a.mapq = 0.0;
      if (n_supp < max_supplementary &&
          overlap_frac(ctx, a, first) < max_overlap) {
        a.supplementary = true;
        ++n_supp;
      } else {
        a.secondary = true;
      }
    }
    if ((int64_t)alns.size() - n_supp >= 2) {
      const Aln* second = nullptr;
      for (size_t i = 1; i < alns.size(); ++i)
        if (!alns[i].supplementary) {
          second = &alns[i];
          break;
        }
      first.mapq = first.score == 0
                       ? 0.0
                       : double(first.score - second->score) / double(first.score);
    } else {
      first.mapq = double(first.score) / double(match * L);
    }
    if (num_seeds(ctx, first) <= 1) first.mapq /= 2;
    if (first.score >= match * L * 0.8 && alns.size() >= 3) first.mapq *= 2;
    first.mapq = std::min(first.mapq, 1.0);
    if (n_supp > 0) {
      for (size_t i = 1; i < alns.size(); ++i)
        if (alns[i].supplementary) alns[i].mapq = first.mapq;
      std::stable_sort(alns.begin(), alns.end(), larger);
    }
    int64_t keep = (int64_t)alns.size();
    if (report_n != 0 && keep > report_n + n_supp) keep = report_n + n_supp;

    // ---- records
    const uint8_t* name = names + name_off[b];
    int64_t name_len = name_off[b + 1] - name_off[b];
    const uint8_t* qual = quals + qual_off[b];
    int64_t qual_len = qual_off[b + 1] - qual_off[b];
    const uint8_t* codes = seqs + b * seq_stride;
    for (int64_t i = 0; i < keep; ++i) {
      const Aln& a = alns[i];
      if (a.score < min_score) continue;
      if (omit_sec && a.secondary) continue;
      if (omit_sup && a.supplementary) continue;
      bool rev = a.begin_ref >= L_fwd;
      int64_t flag = (rev ? 0x10 : 0) | (a.secondary ? 0x100 : 0) |
                     (a.supplementary ? 0x800 : 0);
      // abs position + contig (alignment.h getSamPosition:593-601)
      int64_t abs_pos =
          a.end_ref >= L_fwd ? 2 * L_fwd - (a.end_ref + 1) : a.begin_ref;
      int64_t ctg =
          std::upper_bound(ctg_starts, ctg_starts + n_ctg, abs_pos) -
          ctg_starts - 1;
      int64_t pos = abs_pos - ctg_starts[ctg] + (rev ? 1 : 0) + 1;
      int64_t mapq255 =
          std::isnan(a.mapq) ? 255 : (int64_t)std::ceil(a.mapq * 254.0);

      if (name_len)
        w.bytes(name, name_len);
      else
        w.put('*');
      w.put('\t');
      w.num(flag);
      w.put('\t');
      w.bytes(ctg_names + ctg_name_off[ctg],
              ctg_name_off[ctg + 1] - ctg_name_off[ctg]);
      w.put('\t');
      w.num(pos);
      w.put('\t');
      w.num(mapq255);
      w.put('\t');
      // ---- CIGAR (alignment.py cigar)
      char clip = soft_clip ? 'S' : 'H';
      int64_t front = a.begin_q, back = L - a.end_q;
      int64_t cfirst = rev ? back : front, clast = rev ? front : back;
      bool any = false;
      if (cfirst > 0) {
        w.num(cfirst);
        w.put(clip);
        any = true;
      }
      const char SYM[] = {'=', '=', 'X', 'I', 'D'};
      int64_t run_m = 0;
      auto emit_run = [&](int opk, int64_t sz) {
        if (use_m) {
          if (opk == OP_SEED || opk == OP_MATCH || opk == OP_MISMATCH) {
            run_m += sz;
            return;
          }
          if (run_m) {
            w.num(run_m);
            w.put('M');
            any = true;
            run_m = 0;
          }
        }
        w.num(sz);
        w.put(use_m ? (opk == OP_INS ? 'I' : 'D') : SYM[opk]);
        any = true;
      };
      if (rev) {
        for (int64_t k = a.run_hi - 1; k >= a.run_lo; --k)
          emit_run(out_op[k], out_len[k]);
      } else {
        for (int64_t k = a.run_lo; k < a.run_hi; ++k)
          emit_run(out_op[k], out_len[k]);
      }
      if (use_m && run_m) {
        w.num(run_m);
        w.put('M');
        any = true;
      }
      if (clast > 0) {
        w.num(clast);
        w.put(clip);
        any = true;
      }
      if (!any) w.put('*');
      w.str("\t*\t0\t0\t");
      // ---- SEQ + QUAL (strand-matched; hard clip slices)
      int64_t s0 = soft_clip ? 0 : a.begin_q;
      int64_t s1 = soft_clip ? L : a.end_q;
      if (s1 <= s0) {
        w.str("*\t*");
      } else if (!rev) {
        for (int64_t j = s0; j < s1; ++j) w.put(BASE[codes[j] > 4 ? 4 : codes[j]]);
        w.put('\t');
        if (qual_len)
          w.bytes(qual + s0, s1 - s0);
        else
          w.put('*');
      } else {
        for (int64_t j = s1 - 1; j >= s0; --j) {
          uint8_t c = codes[j];
          w.put(c < 4 ? BASE[3 - c] : 'N');
        }
        w.put('\t');
        if (qual_len) {
          for (int64_t j = s1 - 1; j >= s0; --j) w.put((char)qual[j]);
        } else {
          w.put('*');
        }
      }
      w.put('\n');
      ++n_recs;
    }
  }
  *out_n_bytes = w.n;
  *out_n_recs = n_recs;
  return w.over ? 1 : 0;
}
