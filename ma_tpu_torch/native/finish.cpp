// Native finish stage: DP planning + CIGAR assembly for harmonized seed
// sets.
//
// The reference runs its whole per-read tail (NeedlemanWunsch chaining,
// CIGAR assembly) in C++ worker threads (libs/ma/src/module/
// needlemanWunsch.cpp execute_one:625-905, dynPrg:499-623,
// ksw_dual_ext:239-498; scoring semantics Alignment::append,
// libs/ma/src/container/alignment.cpp:25-65). Our TPU pipeline keeps the
// DP itself on the chip (ops/dp_fused.py) but the per-set planning and
// run assembly were Python loops costing ~450 ms per 4096-read batch —
// this module is the same logic as ma_tpu_torch/pipeline/nw.py plan_set /
// _plan_dyn_prg / assemble / _assemble_dual / Alignment.append, ported
// 1:1 (the Python implementations remain the reference and the test
// oracle).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o _finish.so finish.cpp
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <array>
#include <vector>

namespace {

// token types
enum { TOK_OP = 0, TOK_GLOBAL = 1, TOK_EXT = 2, TOK_DUAL = 3 };
// op codes in tokens / output runs
enum { OP_SEED = 0, OP_MATCH = 1, OP_MISMATCH = 2, OP_INS = 3, OP_DEL = 4 };
// problem cigar ops (from the DP kernel)
enum { POP_M = 0, POP_I = 1, POP_D = 2 };

struct PlanCtx {
    const int64_t* ctg_starts;
    const int64_t* ctg_lens;
    int64_t n_ctg;
    int64_t L;
    int64_t padding, band_ext, min_band_gap, max_gap_area;
    // outputs
    int32_t* desc;  // [n, 9] row-major per problem
    int64_t n_prob = 0, max_prob;
    int32_t* toks;  // [n, 8] row-major: set, type, a..f
    int64_t n_tok = 0, max_tok;
    bool overflow = false;

    void emit_tok(int64_t set, int32_t type, int32_t a = 0, int32_t b = 0,
                  int32_t c = 0, int32_t d = 0, int32_t e = 0, int32_t f = 0) {
        if (n_tok >= max_tok) { overflow = true; return; }
        int32_t* t = toks + 8 * n_tok++;
        t[0] = (int32_t)set; t[1] = type; t[2] = a; t[3] = b; t[4] = c;
        t[5] = d; t[6] = e; t[7] = f;
    }
    int32_t new_problem(int32_t read_idx, int64_t q_off, int64_t q_len,
                        int32_t q_rev, int64_t t_start, int64_t t_len,
                        int32_t t_rev, int64_t band, int32_t is_global) {
        if (n_prob >= max_prob) { overflow = true; return 0; }
        int32_t* d = desc + 9 * n_prob;
        d[0] = read_idx; d[1] = (int32_t)q_off; d[2] = (int32_t)q_len;
        d[3] = q_rev; d[4] = (int32_t)t_start; d[5] = (int32_t)t_len;
        d[6] = t_rev; d[7] = (int32_t)band; d[8] = is_global;
        return (int32_t)n_prob++;
    }
};

int64_t seq_id_for(const PlanCtx& c, int64_t pos) {
    int64_t abs_pos = pos >= c.L ? 2 * c.L - pos - 1 : pos;
    // upper_bound(starts, abs_pos) - 1
    int64_t lo = 0, hi = c.n_ctg;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (c.ctg_starts[mid] <= abs_pos) lo = mid + 1; else hi = mid;
    }
    return lo - 1;
}

bool bridging(const PlanCtx& c, int64_t begin, int64_t end) {
    if (end <= begin) return false;
    if (end > 2 * c.L) return true;
    if ((begin >= c.L) != (end - 1 >= c.L)) return true;
    return seq_id_for(c, begin) != seq_id_for(c, end - 1);
}

void contig_segment(const PlanCtx& c, int64_t pos, int64_t* lo, int64_t* hi) {
    int64_t ci = seq_id_for(c, pos);
    int64_t l = c.ctg_starts[ci];
    int64_t h = l + c.ctg_lens[ci];
    if (pos >= c.L) { int64_t nl = 2 * c.L - h, nh = 2 * c.L - l; l = nl; h = nh; }
    *lo = l; *hi = h;
}

// mirror of nw.py _plan_dyn_prg (descriptor mode)
void plan_dyn_prg(PlanCtx& c, int64_t set, int32_t read_idx, int64_t fq,
                  int64_t tq, int64_t fr, int64_t tr, bool local_begin,
                  bool local_end, int64_t begin_ref) {
    if (tr <= fr && tq <= fq) return;
    if (tq <= fq) { c.emit_tok(set, TOK_OP, OP_DEL, (int32_t)(tr - fr)); return; }
    if (tr <= fr) { c.emit_tok(set, TOK_OP, OP_INS, (int32_t)(tq - fq)); return; }
    if (!local_begin && !local_end) {
        if (tq - fq > c.max_gap_area || tr - fr > c.max_gap_area) {
            int64_t cap = (tq - fq) + c.band_ext + 1;
            int64_t trl = std::min(tr, fr + cap);
            int32_t pl = c.new_problem(read_idx, fq, tq - fq, 0,
                                       begin_ref + fr, trl - fr, 0,
                                       c.band_ext, 0);
            int64_t frr = std::max(fr, tr - cap);
            int32_t pr = c.new_problem(read_idx, fq, tq - fq, 1,
                                       begin_ref + frr, tr - frr, 1,
                                       c.band_ext, 0);
            c.emit_tok(set, TOK_DUAL, pl, pr, (int32_t)fq, (int32_t)tq,
                       (int32_t)fr, (int32_t)tr);
        } else {
            int64_t w = c.min_band_gap;
            int64_t diff = (tr - fr) - (tq - fq);
            if (diff < 0) diff = -diff;
            if (diff + 10 > w) w = diff + 10;
            int32_t p = c.new_problem(read_idx, fq, tq - fq, 0,
                                      begin_ref + fr, tr - fr, 0, w, 1);
            c.emit_tok(set, TOK_GLOBAL, p, (int32_t)fq, (int32_t)tq,
                       (int32_t)fr, (int32_t)tr);
        }
        return;
    }
    bool rev = local_begin;
    int64_t cap = (tq - fq) + c.band_ext + 1;
    int32_t p;
    if (rev) {
        int64_t fr2 = std::max(fr, tr - cap);
        p = c.new_problem(read_idx, fq, tq - fq, 1, begin_ref + fr2,
                          tr - fr2, 1, c.band_ext, 0);
    } else {
        int64_t tr2 = std::min(tr, fr + cap);
        p = c.new_problem(read_idx, fq, tq - fq, 0, begin_ref + fr,
                          tr2 - fr, 0, c.band_ext, 0);
    }
    c.emit_tok(set, TOK_EXT, p, rev ? 1 : 0, (int32_t)fq, (int32_t)tq,
               (int32_t)fr, (int32_t)tr);
}

}  // namespace

extern "C" {

// Plan all sets. Returns 0 ok, 1 on output overflow (caller re-runs the
// Python path). Outputs: desc [max_prob, 9], toks [max_tok, 8],
// set_begin_ref [n_sets] (-1 = invalid set), counters.
int finish_plan(const int32_t* sq, const int32_t* sl, const int32_t* sr,
                const int64_t* set_off, int64_t n_sets,
                const int32_t* set_read, const int32_t* qlen_per_read,
                const int64_t* ctg_starts, const int64_t* ctg_lens,
                int64_t n_ctg, int64_t L, int64_t padding, int64_t band_ext,
                int64_t min_band_gap, int64_t max_gap_area, int32_t* desc,
                int64_t max_prob, int32_t* toks, int64_t max_tok,
                int64_t* set_begin_ref, int64_t* n_prob_out,
                int64_t* n_tok_out) {
    PlanCtx c{ctg_starts, ctg_lens, n_ctg, L, padding, band_ext,
              min_band_gap, max_gap_area, desc, 0, max_prob, toks, 0,
              max_tok};
    std::vector<std::array<int64_t, 3>> seeds;  // (r, q, l) sorted
    for (int64_t s = 0; s < n_sets; s++) {
        set_begin_ref[s] = -1;
        int32_t read_idx = set_read[s];
        int64_t qlen = qlen_per_read[read_idx];
        seeds.clear();
        for (int64_t i = set_off[s]; i < set_off[s + 1]; i++)
            if (sl[i] > 0) seeds.push_back({(int64_t)sr[i], (int64_t)sq[i],
                                            (int64_t)sl[i]});
        if (seeds.empty()) continue;
        std::sort(seeds.begin(), seeds.end());
        int64_t begin_ref = INT64_MAX, end_ref = INT64_MIN;
        for (auto& sd : seeds) {
            begin_ref = std::min(begin_ref, sd[0]);
            end_ref = std::max(end_ref, sd[0] + sd[2]);
        }
        if (begin_ref >= end_ref || bridging(c, begin_ref, end_ref + 1))
            continue;
        int64_t old_lo, old_hi;
        contig_segment(c, begin_ref, &old_lo, &old_hi);
        begin_ref = std::max(begin_ref - padding, (int64_t)0);
        end_ref = std::min(end_ref + padding, 2 * L - 1);
        begin_ref = std::max(begin_ref, old_lo);
        if (end_ref > old_hi - 1) end_ref = old_hi - 1;
        set_begin_ref[s] = begin_ref;

        int64_t tok_mark = c.n_tok, prob_mark = c.n_prob;
        auto& front = seeds[0];
        plan_dyn_prg(c, s, read_idx, 0, front[1], 0, front[0] - begin_ref,
                     true, false, begin_ref);
        c.emit_tok(s, TOK_OP, OP_SEED, (int32_t)front[2]);
        int64_t last_q = front[1] + front[2];
        int64_t last_r = front[0] + front[2] - begin_ref;
        for (size_t k = 1; k < seeds.size(); k++) {
            int64_t r0 = seeds[k][0], q0 = seeds[k][1], l0 = seeds[k][2];
            if (l0 == 0) continue;
            int64_t ov_q = q0 <= last_q ? last_q - q0 : 0;
            int64_t ov_r = r0 - begin_ref <= last_r ? last_r - (r0 - begin_ref) : 0;
            int64_t overlap = std::max(ov_q, ov_r);
            if (l0 > overlap) {
                plan_dyn_prg(c, s, read_idx, last_q, q0, last_r,
                             r0 - begin_ref, false, false, begin_ref);
                if (ov_q > ov_r)
                    c.emit_tok(s, TOK_OP, OP_DEL, (int32_t)(ov_q - ov_r));
                if (ov_r > ov_q)
                    c.emit_tok(s, TOK_OP, OP_INS, (int32_t)(ov_r - ov_q));
                c.emit_tok(s, TOK_OP, OP_SEED, (int32_t)(l0 - overlap));
                if (q0 + l0 > last_q) last_q = q0 + l0;
                if (r0 + l0 - begin_ref > last_r) last_r = r0 + l0 - begin_ref;
            }
        }
        plan_dyn_prg(c, s, read_idx, last_q, qlen - 1, last_r,
                     end_ref - begin_ref - 1, false, true, begin_ref);
        if (c.overflow) return 1;
        (void)tok_mark; (void)prob_mark;
    }
    *n_prob_out = c.n_prob;
    *n_tok_out = c.n_tok;
    return 0;
}

namespace {

// ---- assembly: Alignment::append semantics (alignment.cpp:25-65) ----
struct Aln {
    std::vector<uint8_t> op;
    std::vector<int64_t> len;
    int64_t begin_ref, end_ref, begin_q, end_q;
    int64_t score = 0;
    int64_t m, mm, g, e, svp;

    int64_t gap_pen(int64_t size) const {
        int64_t p = g + e * size;
        return p < svp ? p : svp;
    }
    void append(uint8_t o, int64_t size) {
        if (size <= 0) return;
        if (o == OP_SEED || o == OP_MATCH) {
            score += m * size;
            end_ref += size; end_q += size;
        } else if (o == OP_MISMATCH) {
            score -= mm * size;
            end_ref += size; end_q += size;
        } else {
            if (o == OP_INS) end_q += size; else end_ref += size;
            if (!op.empty() && op.back() == o) {
                size += len.back();
                score += gap_pen(len.back());
                op.pop_back(); len.pop_back();
            }
            score -= gap_pen(size);
        }
        if (!op.empty() && op.back() == o) len.back() += size;
        else { op.push_back(o); len.push_back(size); }
    }
    void remove_dangeling() {
        size_t s = 0;
        while (s < op.size() && (op[s] == OP_INS || op[s] == OP_DEL)) {
            if (op[s] == OP_DEL) begin_ref += len[s]; else begin_q += len[s];
            score += gap_pen(len[s]);
            s++;
        }
        if (s) { op.erase(op.begin(), op.begin() + s);
                 len.erase(len.begin(), len.begin() + s); }
        while (!op.empty() && (op.back() == OP_INS || op.back() == OP_DEL)) {
            if (op.back() == OP_DEL) end_ref -= len.back();
            else end_q -= len.back();
            score += gap_pen(len.back());
            op.pop_back(); len.pop_back();
        }
    }
};

struct ProbView {
    const int32_t* runs;   // [n_runs, 2] forward order (op, len)
    int64_t n_runs;
    int64_t max_i, max_j;  // extension end (inclusive), -1 = nothing
};

// _append_cigar: split M runs into =/X against text/query
void append_cigar(Aln& a, const ProbView& p, const uint8_t* query,
                  const uint8_t* ref, int64_t qpos, int64_t rpos) {
    for (int64_t k = 0; k < p.n_runs; k++) {
        int32_t o = p.runs[2 * k], ln = p.runs[2 * k + 1];
        if (o == POP_M) {
            int64_t run_start = 0;
            bool cur = false;
            for (int64_t i = 0; i < ln; i++) {
                uint8_t qc = query[qpos + i], tc = ref[rpos + i];
                bool eq = qc == tc && qc < 4;
                if (i == 0) { cur = eq; continue; }
                if (eq != cur) {
                    a.append(cur ? OP_MATCH : OP_MISMATCH, i - run_start);
                    run_start = i; cur = eq;
                }
            }
            if (ln > 0) a.append(cur ? OP_MATCH : OP_MISMATCH, ln - run_start);
            qpos += ln; rpos += ln;
        } else if (o == POP_I) {
            a.append(OP_INS, ln); qpos += ln;
        } else {
            a.append(OP_DEL, ln); rpos += ln;
        }
    }
}

}  // namespace

// Assemble all sets into run-length alignments.
//  toks       [n_tok, 8] from finish_plan
//  prob_runs  [n_runs_total, 2] (op, len) FORWARD order per problem
//  prob_off   [n_prob + 1] runs CSR offsets
//  prob_meta  [n_prob, 2]: max_i, max_j (extension; -1 = aligned nothing)
//  text       folded genome codes [2L]; reads [B, Lpad] row-major
//  outputs: out_op/out_len CSR (cap max_out), out_off [n_sets+1],
//           out_meta [n_sets, 6]: begin_ref, end_ref, begin_q, end_q,
//           score, valid
int finish_assemble(const int32_t* toks, int64_t n_tok,
                    const int64_t* set_begin_ref, const int32_t* set_read,
                    int64_t n_sets, const int32_t* prob_runs,
                    const int64_t* prob_off, const int64_t* prob_meta,
                    const uint8_t* text, int64_t text_len,
                    const uint8_t* reads, int64_t Lpad, int64_t m, int64_t mm,
                    int64_t g, int64_t e, int64_t svp, uint8_t* out_op,
                    int32_t* out_len, int64_t* out_off, int64_t* out_meta,
                    int64_t max_out) {
    int64_t w = 0;
    int64_t t = 0;
    out_off[0] = 0;
    for (int64_t s = 0; s < n_sets; s++) {
        int64_t begin_ref = set_begin_ref[s];
        int64_t* meta = out_meta + 6 * s;
        // collect this set's tokens (they are contiguous by construction)
        int64_t t0 = t;
        while (t < n_tok && toks[8 * t] == s) t++;
        if (begin_ref < 0 || t == t0) {
            meta[5] = 0;
            out_off[s + 1] = w;
            continue;
        }
        const uint8_t* query = reads + (int64_t)set_read[s] * Lpad;
        const uint8_t* ref = text + begin_ref;  // window view

        Aln a{{}, {}, begin_ref, begin_ref, 0, 0, 0, m, mm, g, e, svp};
        auto prob = [&](int64_t pi) {
            ProbView v;
            v.runs = prob_runs + 2 * prob_off[pi];
            v.n_runs = prob_off[pi + 1] - prob_off[pi];
            v.max_i = prob_meta[2 * pi];
            v.max_j = prob_meta[2 * pi + 1];
            return v;
        };
        for (int64_t k = t0; k < t; k++) {
            const int32_t* tk = toks + 8 * k;
            int32_t type = tk[1];
            if (type == TOK_OP) {
                a.append((uint8_t)tk[2], tk[3]);
            } else if (type == TOK_GLOBAL) {
                ProbView p = prob(tk[2]);
                int64_t fq = tk[3], tq = tk[4], fr = tk[5], tr = tk[6];
                int64_t qpos = fq, rpos = fr;
                // track consumed lengths to pad the remainder
                for (int64_t r = 0; r < p.n_runs; r++) {
                    int32_t o = p.runs[2 * r], ln = p.runs[2 * r + 1];
                    if (o != POP_D) qpos += ln;
                    if (o != POP_I) rpos += ln;
                }
                int64_t cq = qpos, cr = rpos;
                append_cigar(a, p, query, ref, fq, fr);
                a.append(OP_DEL, tq - cq);  // note: reference swaps these
                a.append(OP_INS, tr - cr);  // names; lengths are 0 normally
            } else if (type == TOK_EXT) {
                ProbView p = prob(tk[2]);
                bool rev = tk[3] != 0;
                int64_t fq = tk[4], tq = tk[5], fr = tk[6], tr = tk[7];
                if (rev) {
                    if (p.max_i >= 0) {
                        int64_t q0 = tq - p.max_i - 1;
                        int64_t r0 = tr - p.max_j - 1;
                        a.begin_q = q0; a.end_q = q0;
                        a.begin_ref = begin_ref + r0;
                        a.end_ref = begin_ref + r0;
                        // reversed cigar, forward emission
                        std::vector<int32_t> rruns(2 * p.n_runs);
                        for (int64_t r = 0; r < p.n_runs; r++) {
                            rruns[2 * r] = p.runs[2 * (p.n_runs - 1 - r)];
                            rruns[2 * r + 1] = p.runs[2 * (p.n_runs - 1 - r) + 1];
                        }
                        ProbView rp{rruns.data(), p.n_runs, p.max_i, p.max_j};
                        append_cigar(a, rp, query, ref, q0, r0);
                    } else {
                        a.begin_q = tq; a.end_q = tq;
                        a.begin_ref = begin_ref + tr;
                        a.end_ref = begin_ref + tr;
                    }
                } else if (p.max_i >= 0) {
                    append_cigar(a, p, query, ref, fq, fr);
                }
            } else {  // TOK_DUAL — mirror of nw.py _assemble_dual
                ProbView Lp = prob(tk[2]);
                ProbView Rp = prob(tk[3]);
                int64_t fq = tk[4], tq = tk[5], fr = tk[6], tr = tk[7];
                int64_t li = Lp.max_i, lj = Lp.max_j;
                int64_t ri = Rp.max_i, rj = Rp.max_j;
                int64_t q_center = (fq + li + (tq - ri - 1)) / 2;
                q_center = std::max(fq, std::min(tq, q_center));
                int64_t r_center = (fr + lj + (tr - rj - 1)) / 2;
                r_center = std::max(fr, std::min(tr, r_center));
                int64_t qpos = fq, rpos = fr;
                if (rpos != r_center && qpos != q_center) {
                    for (int64_t r = 0; r < Lp.n_runs; r++) {
                        int32_t o = Lp.runs[2 * r];
                        int64_t ln = Lp.runs[2 * r + 1];
                        if (o == POP_M) {
                            ln = std::min({ln, q_center - qpos, r_center - rpos});
                            ProbView one{nullptr, 0, 0, 0};
                            int32_t tmp[2] = {POP_M, (int32_t)ln};
                            one.runs = tmp; one.n_runs = 1;
                            append_cigar(a, one, query, ref, qpos, rpos);
                            qpos += ln; rpos += ln;
                        } else if (o == POP_I) {
                            ln = std::min(ln, q_center - qpos);
                            a.append(OP_INS, ln); qpos += ln;
                        } else {
                            ln = std::min(ln, r_center - rpos);
                            a.append(OP_DEL, ln); rpos += ln;
                        }
                        if (rpos == r_center || qpos == q_center) break;
                    }
                }
                int64_t rq = tq - ri - 1, rr = tr - rj - 1;
                // forward-order right cigar
                std::vector<int32_t> rc(2 * Rp.n_runs);
                for (int64_t r = 0; r < Rp.n_runs; r++) {
                    rc[2 * r] = Rp.runs[2 * (Rp.n_runs - 1 - r)];
                    rc[2 * r + 1] = Rp.runs[2 * (Rp.n_runs - 1 - r) + 1];
                }
                int64_t i = 0;
                int64_t pend_op = -1, pend_len = 0;
                while (i < (int64_t)Rp.n_runs) {
                    if (rr >= r_center && rq >= q_center) break;
                    int32_t o = rc[2 * i];
                    int64_t ln = rc[2 * i + 1];
                    if (o == POP_M) {
                        if (rr + ln >= r_center && rq + ln >= q_center) {
                            int64_t cut;
                            if (rr < r_center &&
                                (rq >= q_center || r_center - rr > q_center - rq))
                                cut = r_center - rr;
                            else
                                cut = q_center - rq;
                            pend_op = o; pend_len = ln - cut;
                            rq += cut; rr += cut; i++;
                            break;
                        }
                        rq += ln; rr += ln;
                    } else if (o == POP_I) {
                        if (rq + ln > q_center && rr >= r_center) {
                            int64_t cut = q_center - rq;
                            pend_op = o; pend_len = ln - cut;
                            rq += cut; i++;
                            break;
                        }
                        rq += ln;
                    } else {
                        if (rr + ln > r_center && rq >= q_center) {
                            int64_t cut = r_center - rr;
                            pend_op = o; pend_len = ln - cut;
                            rr += cut; i++;
                            break;
                        }
                        rr += ln;
                    }
                    i++;
                }
                if (rr > rpos) a.append(OP_DEL, rr - rpos);
                if (rq > qpos) a.append(OP_INS, rq - qpos);
                if (pend_op >= 0 && pend_len > 0) {
                    if (pend_op == POP_M) {
                        int32_t tmp[2] = {POP_M, (int32_t)pend_len};
                        ProbView one{tmp, 1, 0, 0};
                        append_cigar(a, one, query, ref, rq, rr);
                        rq += pend_len; rr += pend_len;
                    } else if (pend_op == POP_I) {
                        a.append(OP_INS, pend_len); rq += pend_len;
                    } else {
                        a.append(OP_DEL, pend_len); rr += pend_len;
                    }
                }
                for (; i < (int64_t)Rp.n_runs; i++) {
                    int32_t o = rc[2 * i];
                    int64_t ln = rc[2 * i + 1];
                    if (o == POP_M) {
                        int32_t tmp[2] = {POP_M, (int32_t)ln};
                        ProbView one{tmp, 1, 0, 0};
                        append_cigar(a, one, query, ref, rq, rr);
                        rq += ln; rr += ln;
                    } else if (o == POP_I) {
                        a.append(OP_INS, ln); rq += ln;
                    } else {
                        a.append(OP_DEL, ln); rr += ln;
                    }
                }
            }
        }
        a.remove_dangeling();
        if (w + (int64_t)a.op.size() > max_out) return 1;
        for (size_t k = 0; k < a.op.size(); k++) {
            out_op[w] = a.op[k];
            out_len[w] = (int32_t)a.len[k];
            w++;
        }
        out_off[s + 1] = w;
        meta[0] = a.begin_ref; meta[1] = a.end_ref;
        meta[2] = a.begin_q; meta[3] = a.end_q;
        meta[4] = a.score; meta[5] = 1;
    }
    return 0;
}

}  // extern "C"
