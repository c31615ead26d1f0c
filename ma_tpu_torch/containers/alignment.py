"""Alignment container: run-length CIGAR + scoring + SAM field computation.

Host-side re-design of the reference Alignment
(reference: libs/ma/inc/ma/container/alignment.h:55-860,
libs/ma/src/container/alignment.cpp):

* run-length ops: seed / match / mismatch / insertion / deletion
  (seed == match for scoring, kept distinct for diagnostics)
* score maintained on append (alignment.cpp:25-65): match/seed +match*len,
  mismatch -penalty*len, indels -(gap + extend*len) CAPPED at the SV
  penalty (uiSVPenalty=100); merging two adjacent same-type indel runs
  first refunds the old run's penalty
* removeDangeling / makeLocal (alignment.cpp:240-290, :150-238)
* SAM fields: flag, contig, 1-based position with reverse-strand
  fold (alignment.h getSamFlag/getSamPosition:576-601), CIGAR with
  strand-dependent clip placement and run reversal
  (alignment.h cigarString:367-470), MAPQ = ceil(f*254)
  (fileWriter.h:302-306)
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.utils import profile

# op codes (SEED is stored distinctly but rendered as '=' in CIGARs)
SEED, MATCH, MISMATCH, INSERTION, DELETION = "s", "=", "X", "I", "D"

MULTIPLE_SEGMENTS_IN_TEMPLATE = 0x001
SEGMENT_PROPERLY_ALIGNED = 0x002
REVERSE_COMPLEMENTED = 0x10
NEXT_REVERSE_COMPLEMENTED = 0x020
FIRST_IN_TEMPLATE = 0x040
LAST_IN_TEMPLATE = 0x080
SECONDARY_ALIGNMENT = 0x100
SUPPLEMENTARY_ALIGNMENT = 0x800


@dataclasses.dataclass
class AlnStats:
    name: str = ""
    index_of_strip: int = 0
    seed_coverage: int = 0
    num_seeds: int = 0
    set_mapping_quality_to_zero: bool = False
    # paired-read bookkeeping (reference AlignmentStatistics bFirst/pOther)
    first: bool = True
    other: Optional["Alignment"] = None


def _query_runs(a: "Alignment") -> List[Tuple[int, int]]:
    """Query intervals [q0, q1) of `a`'s runs that consume query and
    reference, in query order: a deletion takes no query, an insertion
    advances it without a run."""
    runs = []
    q = a.begin_on_query
    for op, size in a.data:
        if op == DELETION:
            continue
        if op != INSERTION:
            runs.append((q, q + size))
        q += size
    return runs


class Alignment:
    def __init__(
        self,
        begin_on_ref: int = 0,
        begin_on_query: int = 0,
        match: int = 2,
        mismatch: int = 4,
        gap: int = 4,
        extend: int = 2,
        sv_penalty: int = 100,
    ):
        self.data: List[Tuple[str, int]] = []
        self.begin_on_ref = begin_on_ref
        self.end_on_ref = begin_on_ref
        self.begin_on_query = begin_on_query
        self.end_on_query = begin_on_query
        self.iscore = 0
        self.mapping_quality: float = float("nan")
        self.secondary = False
        self.supplementary = False
        self.stats = AlnStats()
        self._m, self._mm, self._g, self._e, self._sv = match, mismatch, gap, extend, sv_penalty

    # ------------------------------------------------------------- building
    def _gap_pen(self, size: int) -> int:
        p = self._g + self._e * size
        return p if p < self._sv else self._sv

    def append(self, op: str, size: int = 1) -> None:
        if size <= 0:
            return
        if op in (SEED, MATCH):
            self.iscore += self._m * size
            self.end_on_ref += size
            self.end_on_query += size
        elif op == MISMATCH:
            self.iscore -= self._mm * size
            self.end_on_ref += size
            self.end_on_query += size
        else:  # indel
            if op == INSERTION:
                self.end_on_query += size
            else:
                self.end_on_ref += size
            if self.data and self.data[-1][0] == op:
                size += self.data[-1][1]
                self.iscore += self._gap_pen(self.data[-1][1])
                self.data.pop()
            self.iscore -= self._gap_pen(size)
        if self.data and self.data[-1][0] == op:
            self.data[-1] = (op, self.data[-1][1] + size)
        else:
            self.data.append((op, size))

    def append_mm_runs(self, first_is_match: bool, lens) -> None:
        """Append alternating MATCH/MISMATCH runs in one call — the
        vectorized form of the per-run append loop in NWAligner's
        _append_cigar (a 20 kb read at 5% error produces ~4k runs; one
        Python append each was 35% of the long-read batch wall)."""
        import numpy as _np

        lens_i = _np.asarray(lens, _np.int64)
        n = len(lens_i)
        if n == 0:
            return
        total = int(lens_i.sum())
        m_total = int(lens_i[0 if first_is_match else 1 :: 2].sum())
        self.iscore += self._m * m_total - self._mm * (total - m_total)
        self.end_on_ref += total
        self.end_on_query += total
        ops = [
            MATCH if ((i % 2 == 0) == first_is_match) else MISMATCH
            for i in range(n)
        ]
        i0 = 0
        if self.data and self.data[-1][0] == ops[0]:
            self.data[-1] = (ops[0], self.data[-1][1] + int(lens_i[0]))
            i0 = 1
        self.data.extend(zip(ops[i0:], lens_i[i0:].tolist()))

    def score(self) -> int:
        return self.iscore

    def __len__(self) -> int:
        return sum(l for _, l in self.data)

    def num_seeds(self) -> int:
        return sum(1 for op, _ in self.data if op == SEED)

    def seed_coverage(self) -> int:
        return sum(l for op, l in self.data if op == SEED)

    def remove_dangeling(self) -> None:
        """Strip leading/trailing indel runs (alignment.cpp:240-290)."""
        while self.data and self.data[0][0] in (INSERTION, DELETION):
            op, size = self.data.pop(0)
            if op == DELETION:
                self.begin_on_ref += size
            else:
                self.begin_on_query += size
            self.iscore += self._gap_pen(size)
        while self.data and self.data[-1][0] in (INSERTION, DELETION):
            op, size = self.data.pop()
            if op == DELETION:
                self.end_on_ref -= size
            else:
                self.end_on_query -= size
            self.iscore += self._gap_pen(size)

    def make_local(self) -> None:
        """Trim to the maximally scored local stretch (alignment.cpp:150-238)."""
        best_s, best_e, best_score = 0, 0, 0
        run = 0
        run_start = 0
        for i, (op, size) in enumerate(self.data):
            if op in (SEED, MATCH):
                run += self._m * size
            elif op == MISMATCH:
                run -= self._mm * size
            else:
                run -= self._gap_pen(size)
            if run > best_score:
                best_score = run
                best_s, best_e = run_start, i + 1
            if run < 0:
                run = 0
                run_start = i + 1
        # trim front
        for op, size in self.data[:best_s]:
            if op != DELETION:
                self.begin_on_query += size
            if op != INSERTION:
                self.begin_on_ref += size
        for op, size in self.data[best_e:]:
            if op != DELETION:
                self.end_on_query -= size
            if op != INSERTION:
                self.end_on_ref -= size
        self.data = self.data[best_s:best_e]
        self.iscore = best_score
        self.remove_dangeling()

    # ----------------------------------------------------------- comparison
    def overlap(self, other: "Alignment") -> float:
        """Query-interval overlap fraction counting only ref-consuming ops
        (alignment.h overlap:659-740, simplified to query intervals of
        M/X/= runs), summed by one merge of the two run lists."""
        s = max(self.begin_on_query, other.begin_on_query)
        e = min(self.end_on_query, other.end_on_query)
        if s >= e:
            return 0.0

        self_runs = _query_runs(self)
        other_runs = _query_runs(other)
        na, nb = len(self_runs), len(other_runs)
        profile.count("mapq run pairs", na * nb)
        profile.count("mapq runs swept", na + nb)
        # Each list is sorted and disjoint on the query (q only grows), so a
        # run can meet no run of the other list past the one that ends
        # first: advancing that one meets every intersecting pair once.
        ov = 0
        i = j = 0
        while i < na and j < nb:
            a0, a1 = self_runs[i]
            b0, b1 = other_runs[j]
            if a0 >= e or b0 >= e:
                break
            lo, hi = max(a0, b0, s), min(a1, b1, e)
            if lo < hi:
                ov += hi - lo
            if a1 < b1:
                i += 1
            else:
                j += 1
        denom = max(self.end_on_query, other.end_on_query) - min(
            self.begin_on_query, other.begin_on_query
        )
        return ov / denom if denom else 0.0

    def larger(self, other: "Alignment") -> bool:
        """Output ordering (alignment.h larger:819-843)."""
        ua = 2 if self.secondary else (1 if self.supplementary else 0)
        ub = 2 if other.secondary else (1 if other.supplementary else 0)
        if ua != ub:
            return ua < ub
        s1, s2 = self.score(), other.score()
        if s1 == s2:
            return self.stats.index_of_strip < other.stats.index_of_strip
        return s1 > s2

    # ------------------------------------------------------------------ SAM
    def sam_flag(self, pack: Pack) -> int:
        flag = 0
        if int(self.begin_on_ref) >= pack.unpacked_size_forward_strand:
            flag |= REVERSE_COMPLEMENTED
        if self.secondary:
            flag |= SECONDARY_ALIGNMENT
        if self.supplementary:
            flag |= SUPPLEMENTARY_ALIGNMENT
        return flag

    def contig(self, pack: Pack) -> str:
        return pack.names[pack.seq_id_py(int(self.begin_on_ref))]

    def sam_position(self, pack: Pack) -> int:
        """1-based leftmost position (alignment.h getSamPosition:593-601)."""
        # iAbsolutePosition(begin, end): fold by end-1 when on reverse strand
        L, starts, _ = pack._py
        if int(self.end_on_ref) >= L:
            abs_pos = 2 * L - (int(self.end_on_ref) + 1)
        else:
            abs_pos = int(self.begin_on_ref)
        pos = abs_pos - starts[pack.seq_id_py(abs_pos)]
        if int(self.begin_on_ref) >= L:
            pos += 1
        return int(pos) + 1

    def cigar(self, pack: Pack, query_size: int, soft_clip: bool = False,
              use_m: bool = True) -> str:
        """CIGAR string with clips; reversed for reverse-strand alignments
        (alignment.h cigarString / cigarStringWithMInsteadOfXandEqual)."""
        rev = int(self.begin_on_ref) >= pack.unpacked_size_forward_strand
        clip = "S" if soft_clip else "H"
        parts: List[str] = []
        front_clip = self.begin_on_query
        back_clip = query_size - self.end_on_query
        first = back_clip if rev else front_clip
        last = front_clip if rev else back_clip
        if first > 0:
            parts.append(f"{first}{clip}")
        data = list(reversed(self.data)) if rev else list(self.data)
        if use_m:
            run_m = 0
            for op, size in data:
                if op in (SEED, MATCH, MISMATCH):
                    run_m += size
                else:
                    if run_m:
                        parts.append(f"{run_m}M")
                        run_m = 0
                    parts.append(f"{size}{op}")
            if run_m:
                parts.append(f"{run_m}M")
        else:
            for op, size in data:
                sym = "=" if op in (SEED, MATCH) else op
                parts.append(f"{size}{sym}")
        if last > 0:
            parts.append(f"{last}{clip}")
        return "".join(parts) if parts else "*"

    def sam_mapq(self) -> int:
        if math.isnan(self.mapping_quality):
            return 255
        return int(math.ceil(self.mapping_quality * 254))

    def __repr__(self) -> str:
        runs = "".join(f"{l}{'=' if op == SEED else op}" for op, l in self.data)
        return (
            f"Alignment(ref[{self.begin_on_ref},{self.end_on_ref}) "
            f"q[{self.begin_on_query},{self.end_on_query}) score={self.iscore} {runs})"
        )


# module-level helpers shared by the SAM tag generator
def _aln_num_matches(aln: "Alignment") -> int:
    return sum(l for op, l in aln.data if op in (SEED, MATCH))


def _aln_num_differences(aln: "Alignment", count_indels: bool = True) -> int:
    """getNumDifferences: mismatched nt plus (optionally) indel nt."""
    n = 0
    for op, l in aln.data:
        if op == MISMATCH:
            n += l
        elif op in (INSERTION, DELETION) and count_indels:
            n += l
    return n


Alignment.num_matches = _aln_num_matches
Alignment.num_differences = _aln_num_differences
