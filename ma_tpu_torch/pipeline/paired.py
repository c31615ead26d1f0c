"""Paired-read pairing + paired SAM emission (a copy of
ma_tpu/pipeline/paired.py over the port's Aligner).

Re-design of the reference PairedReads module and PairedFileWriter
(reference: libs/ma/src/module/pairedReads.cpp PairedReads::execute:16-121,
libs/ma/src/module/fileWriter.cpp PairedFileWriter::execute:159-330):

* all (alignment1, alignment2) combinations are scored; pairs on opposite
  strands whose reference distance d lies within mean +- 3*std get the
  paired bonus factor (score * u) and the paired flag
* ties sort paired-first; the winning pair is forced primary, cross-linked,
  and (when paired and a runner-up exists) given the BWA-style pair MAPQ
* SAM: both mates emit MULTIPLE_SEGMENTS | SEGMENT_PROPERLY_ALIGNED,
  FIRST/LAST_IN_TEMPLATE, NEXT_REVERSE_COMPLEMENTED, RNEXT ('=' when equal),
  PNEXT, signed TLEN (positive on the first mate)
"""
from __future__ import annotations

from typing import IO, Iterable, List, Optional, Tuple

from ma_tpu_torch.containers.alignment import (
    Alignment,
    FIRST_IN_TEMPLATE,
    LAST_IN_TEMPLATE,
    MULTIPLE_SEGMENTS_IN_TEMPLATE,
    NEXT_REVERSE_COMPLEMENTED,
    SEGMENT_PROPERLY_ALIGNED,
)
from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.io.sam import sam_header


def pick_paired(
    alns1: List[Alignment],
    alns2: List[Alignment],
    pack: Pack,
    q1len: int,
    q2len: int,
    mean: float = 400.0,
    std: float = 150.0,
    score_factor: float = 1.25,
    match: int = 2,
) -> List[Alignment]:
    """PairedReads::execute (pairedReads.cpp:16-121)."""
    for a in alns1:
        a.stats.first = True
    for a in alns2:
        a.stats.first = False
    if not alns1:
        return alns2
    if not alns2:
        return alns1

    scored: List[Tuple[int, bool, int, int]] = []
    for i, a1 in enumerate(alns1):
        if len(a1) == 0:
            continue
        for j, a2 in enumerate(alns2):
            if len(a2) == 0:
                continue
            score = a1.score() + a2.score()
            paired = False
            if bool(pack.is_reverse_strand(a1.begin_on_ref)) != bool(
                pack.is_reverse_strand(a2.begin_on_ref)
            ):
                p1 = a1.begin_on_ref
                p2 = int(pack.pos_to_reverse_strand(a2.begin_on_ref))
                d = abs(p1 - p2)
                if mean - std * 3 <= d <= mean + std * 3:
                    score = int(score * score_factor)
                    paired = True
            scored.append((score, paired, i, j))
    if not scored:
        return alns1 + alns2
    scored.sort(key=lambda t: (-t[0], not t[1]))
    _, best_paired, i1, i2 = scored[0]
    a1, a2 = alns1[i1], alns2[i2]
    a1.secondary = a2.secondary = False
    a1.supplementary = a2.supplementary = False
    a1.stats.other = a2
    a2.stats.other = a1
    if best_paired and len(scored) > 1:
        mapq = (scored[0][0] - scored[1][0]) / scored[0][0]
        if a1.num_seeds() <= 1 and a2.num_seeds() <= 1:
            mapq /= 2
        if a1.score() >= match * q1len * 0.8 and len(alns1) >= 3:
            mapq *= 2
        elif a2.score() >= match * q2len * 0.8 and len(alns2) >= 3:
            mapq *= 2
        mapq = min(mapq, 1.0)
        a1.mapping_quality = mapq
        a2.mapping_quality = mapq
    return [a1, a2]


def paired_sam_record(
    aln: Alignment,
    q1: NucSeq,
    q2: NucSeq,
    pack: Pack,
    soft_clip: bool = False,
    use_m_cigar: bool = True,
) -> str:
    """One SAM line of a paired template (PairedFileWriter::execute)."""
    query = q1 if aln.stats.first else q2
    rev = bool(pack.is_reverse_strand(aln.begin_on_ref))
    flag = aln.sam_flag(pack)
    flag |= MULTIPLE_SEGMENTS_IN_TEMPLATE | SEGMENT_PROPERLY_ALIGNED
    flag |= FIRST_IN_TEMPLATE if aln.stats.first else LAST_IN_TEMPLATE
    rname = aln.contig(pack)
    rnext, pnext, tlen = "*", "0", "0"
    other = aln.stats.other
    if other is not None:
        # spec-conformant TLEN: distance between the template's outermost
        # forward-projected coordinates, positive on the leftmost mate.
        # (The reference computes a mirror-fold distance and its observed
        # output carries TLEN=0; this is a deliberate divergence.)
        b1 = aln.sam_position(pack) - 1
        e1 = b1 + (aln.end_on_ref - aln.begin_on_ref)
        b2 = other.sam_position(pack) - 1
        e2 = b2 + (other.end_on_ref - other.begin_on_ref)
        d = max(e1, e2) - min(b1, b2)
        leftmost = b1 < b2 or (b1 == b2 and aln.stats.first)
        tlen = ("" if leftmost else "-") + str(d)
        if pack.is_reverse_strand(other.begin_on_ref):
            flag |= NEXT_REVERSE_COMPLEMENTED
        rnext = other.contig(pack)
        if rnext == rname:
            rnext = "="
        pnext = str(other.sam_position(pack))
    cig = aln.cigar(pack, len(query), soft_clip=soft_clip, use_m=use_m_cigar)
    if soft_clip:
        codes = query.codes
        qual = query.qual or "*"
    else:
        codes = query.codes[aln.begin_on_query : aln.end_on_query]
        qual = query.qual[aln.begin_on_query : aln.end_on_query] if query.qual else "*"
    if rev:
        codes = revcomp_codes(codes)
        if qual != "*":
            qual = qual[::-1]
    return "\t".join(
        [
            query.name or "*",
            str(flag),
            rname,
            str(aln.sam_position(pack)),
            str(aln.sam_mapq()),
            cig,
            rnext,
            pnext,
            tlen,
            decode_seq(codes) or "*",
            qual if qual else "*",
        ]
    )


class PairedAligner:
    """Paired-end front end over a single-end Aligner."""

    def __init__(self, aligner):
        self.aligner = aligner
        p = aligner.pset
        self.mean = float(p.get("Mean Distance of Paired Reads"))
        self.std = float(p.get("Standard Deviation of Paired Reads"))
        self.factor = float(p.get("Score Factor for Paired Reads"))
        self.match = int(p.get("Match Score"))
        self.soft_clip = bool(p.get("Soft clip"))
        self.use_m = bool(p.get("Use M in CIGAR"))
        self.omit_sec = bool(p.get("Omit Secondary Alignments"))
        self.omit_sup = bool(p.get("Omit Supplementary Alignments"))
        # the reference's PairedFileReader reverse-complements every mate
        # before alignment when this is set (default; fileReader.h:610-613,
        # parameter.h xRevCompPairedReadMates) — all downstream pairing and
        # SAM emission then sees the transformed mate, so we transform at
        # the same point for record-exact parity
        self.revcomp_mate = bool(p.get("Paired Mate - Mate Pair"))

    def _mate(self, q: NucSeq) -> NucSeq:
        return q.revcomp() if self.revcomp_mate else q

    def align_pairs(
        self, pairs: List[Tuple[NucSeq, NucSeq]]
    ) -> List[List[Alignment]]:
        """Align both mates and pick the jointly optimal combination."""
        firsts = [p[0] for p in pairs]
        seconds = [self._mate(p[1]) for p in pairs]
        res1 = self.aligner.align_batch(firsts)
        res2 = self.aligner.align_batch(seconds)
        out = []
        for (r1, r2, (q1, q2)) in zip(res1, res2, pairs):
            out.append(
                pick_paired(
                    r1, r2, self.aligner.pack, len(q1), len(q2),
                    mean=self.mean, std=self.std,
                    score_factor=self.factor, match=self.match,
                )
            )
        return out

    def align_to_sam(
        self,
        pairs: Iterable[Tuple[NucSeq, NucSeq]],
        out: IO[str],
        batch_size: int = 256,
        cmd: str = "ma_tpu_torch",
    ) -> int:
        out.write(sam_header(self.aligner.pack, cmd))
        n = 0
        buf: List[Tuple[NucSeq, NucSeq]] = []

        def flush():
            nonlocal n
            if not buf:
                return
            for (q1, q2), alns in zip(buf, self.align_pairs(buf)):
                for a in alns:
                    if (self.omit_sec and a.secondary) or (
                        self.omit_sup and a.supplementary
                    ):
                        continue
                    out.write(
                        paired_sam_record(
                            a, q1, self._mate(q2), self.aligner.pack,
                            soft_clip=self.soft_clip, use_m_cigar=self.use_m,
                        )
                        + "\n"
                    )
                n += 2
            buf.clear()

        for pair in pairs:
            buf.append(pair)
            if len(buf) >= batch_size:
                flush()
        flush()
        return n
