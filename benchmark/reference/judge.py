"""The comparison that decides `correct`.

For a sample of the reads a run processed, the reference works out from the
genome and the reads alone:

* `field_faults`: records whose fields are not those of the read they name
  (SEQ against the read under the CIGAR's clips and strand, the CIGAR's
  lengths, the flags, the contig, the position inside it, MAPQ's range;
  one primary a read; secondary records at MAPQ 0; supplementary ones at
  the primary's MAPQ or, for an inversion, 0). Exact: limit 0.
* `dp_gap_max`: the widest gap by which a record's score (counted again
  from its CIGAR against the genome) lies below the best score of its
  query stretch within `slack` columns of its own path: the DP's CIGAR and
  score. `dp_gap_per_kb_max`: the same gap per 1,000 bases of the stretch.
* `locus_gap_max`: over reads from a unique origin, the widest gap by
  which the primary record's score lies below the best local score at the
  read's true origin (each side of a planted inversion apart; a read with
  no record counts that whole score): the locus and strand chosen by
  seeding, SoC and harmonization. `locus_gap_per_kb_max`: per 1,000 bases
  of the read.
* `mapq_faults`: primaries whose MAPQ is not one that the aligner's rule
  (MappingQuality) gives for the scores of the read's records, with each
  factor the records cannot show (a single seed halves, three near-perfect
  alignments double, a runner-up below the output limit) allowed. Exact.
* `ambiguous_mapq_max`: the highest MAPQ among reads that lie inside a
  planted repeat copy and score at least as well at another copy of it:
  mapping quality where the placement is ambiguous.
* `inv_missed_pct`: of the written reads with a planted inversion, the
  share with no inversion record (supplementary, MAPQ 0, on the opposite
  strand) over the inverted stretch.
* `low_score_records`: records whose score, counted again, lies under the
  aligner's Minimal Alignment Score (an inversion's: over twice its Minimal
  Harmonization Score). Exact.
* `unwritten_reads`: genome reads the run processed that got no record.

The fields, scores, MAPQs and inversions are checked on every written
read; the DPs on a sample of them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import dp
from .sam import FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY, cigar_ops, encode

COMPLEMENT = np.array([3, 2, 1, 0, 4], np.uint8)
INV_TOL = 200  # bp around the inverted stretch where its record may lie


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


@dataclasses.dataclass
class ReadTruth:
    name: str
    seq: np.ndarray  # codes as the aligner got them
    fwd: np.ndarray  # codes on the forward strand
    tpos: np.ndarray  # genome position of each forward base
    strand: int
    random: bool
    inv: int  # start of the inverted stretch in fwd, or -1
    inv_len: int
    copy: int  # planted copy holding the whole read, or -1
    touches_copy: bool


@dataclasses.dataclass
class Scoring:
    match: int = 2
    min_score: int = 75
    inversion_min: int = 37


def record_view(rec, read: ReadTruth, contig: str, G: int):
    """(fault or None, forward codes of the aligned stretch, genome start,
    ops without clips)."""
    if rec.contig != contig:
        return "contig", None, 0, None
    if rec.flag & ~(FLAG_REVERSE | FLAG_SECONDARY | FLAG_SUPPLEMENTARY) or (
            rec.flag & FLAG_SECONDARY and rec.flag & FLAG_SUPPLEMENTARY):
        return "flag", None, 0, None
    try:
        ops = cigar_ops(rec.cigar)
    except ValueError:
        return "cigar", None, 0, None
    lead = ops[0][1] if ops[0][0] == "H" else 0
    trail = ops[-1][1] if ops[-1][0] == "H" and len(ops) > 1 else 0
    inner = ops[(1 if lead else 0): len(ops) - (1 if trail else 0)]
    if not inner or any(op not in "MID" or n <= 0 for op, n in inner):
        return "cigar", None, 0, None
    if inner[0][0] != "M" or inner[-1][0] != "M":
        return "cigar", None, 0, None
    qspan = sum(n for op, n in inner if op in "MI")
    rspan = sum(n for op, n in inner if op in "MD")
    if lead + qspan + trail != len(read.seq) or len(rec.seq) != qspan:
        return "lengths", None, 0, None
    fo = revcomp(read.seq) if rec.reverse else read.seq
    if not np.array_equal(encode(rec.seq), fo[lead : lead + qspan]):
        return "seq", None, 0, None
    if rec.pos < 1 or rec.pos - 1 + rspan > G or not 0 <= rec.mapq <= 254:
        return "pos_or_mapq", None, 0, None
    return None, fo[lead : lead + qspan], rec.pos - 1, inner


def score_and_path(q: np.ndarray, r0: int, ops, genome: np.ndarray):
    """The record's score counted from its CIGAR against the genome, and
    the lowest and highest genome column its path takes in each query row."""
    L = len(q)
    rmin = np.full(L, np.iinfo(np.int64).max, np.int64)
    rmax = np.full(L, np.iinfo(np.int64).min, np.int64)
    score, i, j = 0, 0, r0  # next query row, next genome column
    for op, n in ops:
        if op == "M":
            eq = genome[j : j + n] == q[i : i + n]
            m = int(eq.sum())
            score += dp.MATCH * m - dp.MISMATCH * (n - m)
            rmin[i : i + n] = np.arange(j, j + n)
            rmax[i : i + n] = np.arange(j, j + n)
            i, j = i + n, j + n
        elif op == "I":
            score -= dp.gap_cost(n)
            rmin[i : i + n] = j - 1
            rmax[i : i + n] = j - 1
            i += n
        else:
            score -= dp.gap_cost(n)
            rmax[i - 1] = max(rmax[i - 1], j + n - 1)
            j += n
    return score, rmin, rmax


def truth_rows(tpos: np.ndarray):
    """Per row of a stretch of a read: its genome column, widened to the
    next row's where the read skips genome bases."""
    nxt = np.concatenate((tpos[1:] - 1, tpos[-1:]))
    return np.minimum(tpos, nxt), np.maximum(tpos, nxt)


def mapq_admissible(mapq: int, s1: int, others: list, qlen: int, sc: Scoring) -> bool:
    """Whether MappingQuality can give `mapq` to a primary of score s1 whose
    read's non-supplementary other records score `others`."""
    q0s, floor = [], None
    if s1 <= 0:
        return mapq == 0
    if others:
        q0s.append((s1 - max(others)) / s1)
    else:
        q0s.append(s1 / float(sc.match * qlen))
        # a runner-up below the output limit was not written
        floor = (s1 - (sc.min_score - 1)) / s1
    got = set()
    for q0 in q0s:
        for half in (False, True):
            for double in (False, True):
                q = q0
                if half:
                    q /= 2
                if double:
                    q *= 2
                got.add(int(math.ceil(min(q, 1.0) * 254)))
    if mapq in got:
        return True
    return floor is not None and mapq >= int(math.ceil(min(floor / 2, 1.0) * 254))


def alt_loci(read: ReadTruth, copies: np.ndarray):
    """The read as it would lie at each other copy of its planted family:
    [(forward codes, genome position of each)]."""
    f, start, length, strand = (int(x) for x in copies[read.copy])
    out = []
    u = read.tpos - start if strand == 0 else length - 1 - (read.tpos - start)
    for k in np.flatnonzero(copies[:, 0] == f):
        if k == read.copy:
            continue
        s2, l2, st2 = int(copies[k, 1]), int(copies[k, 2]), int(copies[k, 3])
        if l2 != length:
            continue
        t2 = s2 + u if st2 == 0 else s2 + l2 - 1 - u
        if st2 == strand:
            out.append((read.fwd, t2))
        else:
            out.append((revcomp(read.fwd), t2[::-1].copy()))
    return out


def segments(read: ReadTruth):
    """The stretches of the forward read that lie on the forward strand."""
    if read.inv < 0:
        return [(0, len(read.fwd))]
    return [(0, read.inv), (read.inv + read.inv_len, len(read.fwd))]


def inversions(reads: list, records: dict, contig: str, out: dict) -> None:
    """`inv_missed_pct` and `inversion_reads` over every read with a planted
    inversion that lies outside the planted copies: a record on the other
    strand over the inverted stretch."""
    inv = [rd for rd in reads if rd.inv >= 0 and not rd.touches_copy]
    if not inv:
        return
    missed = 0
    for rd in inv:
        t = rd.tpos[rd.inv : rd.inv + rd.inv_len]
        lo, hi = int(t.min()) - INV_TOL, int(t.max()) + INV_TOL
        hit = False
        for rec in records.get(rd.name, []):
            if (rec.reverse == bool(rd.strand) or rec.contig != contig or rec.mapq != 0
                    or not rec.flag & FLAG_SUPPLEMENTARY):
                continue
            try:
                rspan = sum(n for op, n in cigar_ops(rec.cigar) if op in "MD")
            except ValueError:
                continue
            if rec.pos - 1 < hi and rec.pos - 1 + rspan > lo:
                hit = True
        missed += not hit
    out["inv_missed_pct"] = 100.0 * missed / len(inv)
    out["inversion_reads"] = len(inv)


def judge(reads: list, records: dict, genome: np.ndarray, contig: str, copies: np.ndarray,
          sc: Scoring, slack: int = 16, unwritten: int = 0, sampled=None) -> dict:
    """The compared numbers over `reads` (ReadTruth) and their records
    (`records[name]`: a list of sam.Record). The fields, scores and MAPQs
    of every read's records are checked; the DPs run over the reads named
    in `sampled` (all where it is None)."""
    G = len(genome)
    faults = low = 0
    mapq_faults = 0
    rec_q, rec_min, rec_max, rec_score = [], [], [], []
    primary = {}  # name -> (score, mapq)
    for rd in reads:
        recs = records.get(rd.name, [])
        in_dp = sampled is None or rd.name in sampled
        scored = []
        for rec in recs:
            fault, q, r0, ops = record_view(rec, rd, contig, G)
            if fault:
                faults += 1
                continue
            s, mn, mx = score_and_path(q, r0, ops, genome)
            if in_dp:
                rec_q.append(q)
                rec_min.append(mn)
                rec_max.append(mx)
                rec_score.append(s)
            scored.append((rec, s))
        prim = [x for x in scored if x[0].primary]
        if recs and len([r for r in recs if r.primary]) != 1:
            faults += 1
        if len(prim) == 1:
            p, s1 = prim[0]
            primary[rd.name] = (s1, p.mapq)
            for rec, s in scored:
                if rec.flag & FLAG_SECONDARY and rec.mapq != 0:
                    faults += 1
                if rec.flag & FLAG_SUPPLEMENTARY and rec.mapq not in (p.mapq, 0):
                    faults += 1
            others = [s for rec, s in scored if rec.flag & FLAG_SECONDARY]
            if not mapq_admissible(p.mapq, s1, others, len(rd.seq), sc):
                mapq_faults += 1
            # the aligner writes no alignment under its minimal score (an
            # inversion's, opposite the primary at MAPQ 0: over twice the
            # minimal harmonization score)
            for rec, s in scored:
                inversion = (rec.flag & FLAG_SUPPLEMENTARY and rec.mapq == 0
                             and rec.reverse != p.reverse)
                low += s < (sc.inversion_min if inversion else sc.min_score)
    out = {"field_faults": faults, "mapq_faults": mapq_faults, "low_score_records": low,
           "unwritten_reads": unwritten}
    inversions(reads, records, contig, out)
    reads = [rd for rd in reads if sampled is None or rd.name in sampled]

    # every DP in one pass: each record's stretch within `slack` of its own
    # path (end to end); each read's forward stretches at the true origin
    # and at the other copies of a planted repeat (local)
    origin_p, alt_p, origin_of, alt_of = [], [], [], []
    for k, rd in enumerate(reads):
        if rd.random:
            continue
        for a, b in segments(rd):
            origin_p.append((rd.fwd[a:b], *truth_rows(rd.tpos[a:b])))
            origin_of.append(k)
        if rd.copy >= 0:
            for q, t in alt_loci(rd, copies):
                alt_p.append((q, *truth_rows(t)))
                alt_of.append(k)
    qs = rec_q + [p[0] for p in origin_p + alt_p]
    mins = rec_min + [p[1] for p in origin_p + alt_p]
    maxs = rec_max + [p[2] for p in origin_p + alt_p]
    local = np.arange(len(qs)) >= len(rec_q)
    best = dp.banded(qs, mins, maxs, genome, local, slack) if qs else []
    n_rec, n_org = len(rec_q), len(origin_of)
    if rec_q:
        gap = best[:n_rec] - np.asarray(rec_score)
        out["dp_gap_max"] = int(gap.max())
        out["dp_gap_per_kb_max"] = float((1e3 * gap / np.asarray([len(q) for q in rec_q])).max())
    origin = np.full(len(reads), dp.NEG, np.int64)
    np.maximum.at(origin, np.asarray(origin_of, np.int64), best[n_rec : n_rec + n_org])
    gaps = []
    for k, rd in enumerate(reads):
        if rd.random or rd.touches_copy:
            continue
        s1 = primary.get(rd.name, (0,))[0]
        gaps.append((max(0, int(origin[k]) - s1), len(rd.seq)))
    if gaps:
        out["locus_gap_max"] = max(g for g, _ in gaps)
        out["locus_gap_per_kb_max"] = max(1e3 * g / n for g, n in gaps)

    # ambiguous placements: another copy scores at least as well
    if alt_of:
        alt = np.full(len(reads), dp.NEG, np.int64)
        np.maximum.at(alt, np.asarray(alt_of, np.int64), best[n_rec + n_org :])
        amb = [k for k in set(alt_of) if alt[k] >= origin[k]]
        if amb:
            out["ambiguous_mapq_max"] = max(primary.get(reads[k].name, (0, 255))[1]
                                            for k in amb)
        out["ambiguous_reads"] = len(amb)

    out["judged_reads"] = len(reads)
    out["judged_records"] = sum(len(records.get(rd.name, [])) for rd in reads)
    return out


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number measured and
    within its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        rows.append((name, v, limit))
        if v is None or v > limit:
            ok = False
    return ok, rows
