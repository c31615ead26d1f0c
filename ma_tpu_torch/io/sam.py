"""SAM output (a copy of ma_tpu/io/sam.py; the port writes the same bytes).

Host re-design of the reference FileWriter
(reference: libs/ma/inc/ma/module/fileWriter.h:366-470):

* @SQ headers from the pack's contigs, @PG line (fileWriter.h:394-399)
* per alignment: name, flag, contig, 1-based pos, MAPQ=ceil(f*254)
  (255 for NaN), CIGAR (M or =/X mode, soft/hard clips), SEQ strand-matched
  (reverse complement for reverse-strand alignments), QUAL
* unaligned output omitted (the reference emits no record for unaligned
  reads either)
"""
from __future__ import annotations

from typing import IO, Iterable, List

from ma_tpu_torch.containers.alignment import Alignment
from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes
from ma_tpu_torch.containers.pack import Pack

# The @PG line names the reference aligner, so the port's SAM is byte for
# byte the reference package's.
PG_ID, PG_NAME, PG_VERSION = "ma_tpu", "ma_tpu", "0.1.0"


def sam_header(pack: Pack, cmd: str = "ma_tpu") -> str:
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    for name, length in zip(pack.names, pack.lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(length)}")
    lines.append(f"@PG\tID:{PG_ID}\tPN:{PG_NAME}\tVN:{PG_VERSION}\tCL:{cmd}")
    return "\n".join(lines) + "\n"


MAX_CIGAR_OPS = 0x10000  # fileWriter.h uiMaxCigarLen:93


def needs_cg_tag(aln: Alignment, cg_tag: bool) -> bool:
    """BAM caps CIGARs at 65,535 ops; the reference moves longer ones into
    the CG:B:I tag (fileWriter.cpp:34-36, fileWriter.h computeTag:327-355)."""
    return cg_tag and len(aln.data) >= MAX_CIGAR_OPS


def cg_tag_value(aln: Alignment) -> str:
    """CG:B:I payload: one BAM-encoded op (size << 4 | op) per data entry
    (fileWriter.h:329-355; seed/match -> '=' (7), mismatch -> 'X' (8),
    insertion -> 'I' (1), deletion -> 'D' (2))."""
    from ma_tpu_torch.containers.alignment import DELETION, INSERTION, MATCH, MISMATCH, SEED

    op_code = {SEED: 7, MATCH: 7, MISMATCH: 8, INSERTION: 1, DELETION: 2}
    return "\tCG:B:I" + "".join(
        f",{(size << 4) | op_code.get(op, 7)}" for op, size in aln.data
    )


def sam_record(
    aln: Alignment,
    query: NucSeq,
    pack: Pack,
    soft_clip: bool = False,
    use_m_cigar: bool = True,
    cg_tag: bool = False,
) -> str:
    rev = int(aln.begin_on_ref) >= pack.unpacked_size_forward_strand
    flag = aln.sam_flag(pack)
    pos = aln.sam_position(pack)
    if needs_cg_tag(aln, cg_tag):
        # CIGAR column becomes "<query span>S"; ops go to CG (fileWriter.cpp:34-36)
        cig = f"{aln.end_on_query - aln.begin_on_query}S"
    else:
        cig = aln.cigar(pack, len(query), soft_clip=soft_clip, use_m=use_m_cigar)
    if soft_clip:
        codes = query.codes
        qual = query.qual or "*"
    else:
        codes = query.codes[aln.begin_on_query : aln.end_on_query]
        qual = (
            query.qual[aln.begin_on_query : aln.end_on_query] if query.qual else "*"
        )
    if rev:
        codes = revcomp_codes(codes)
        if qual != "*":
            qual = qual[::-1]
    seq = decode_seq(codes) or "*"
    fields = [
        query.name or "*",
        str(flag),
        aln.contig(pack),
        str(pos),
        str(aln.sam_mapq()),
        cig,
        "*",  # RNEXT
        "0",  # PNEXT
        "0",  # TLEN
        seq,
        qual if qual else "*",
    ]
    return "\t".join(fields)


class SamWriter:
    """Streaming SAM writer (FileWriter's role, minus the thread mutex —
    the host pipeline is single-writer)."""

    def __init__(self, out: IO[str], pack: Pack, cmd: str = "ma_tpu",
                 soft_clip: bool = False, use_m_cigar: bool = True,
                 ngmlr_tags: bool = False, cg_tag: bool = True):
        self.out = out
        self.pack = pack
        self.soft_clip = soft_clip
        self.use_m = use_m_cigar
        self.ngmlr_tags = ngmlr_tags
        self.cg_tag = cg_tag
        out.write(sam_header(pack, cmd))

    def write_text(self, text: str) -> None:
        """Append pre-formatted records (the native samout.cpp fast path
        emits whole batches as one string)."""
        self.out.write(text)

    def write(self, alignments: Iterable[Alignment], query: NucSeq) -> None:
        alignments = list(alignments)
        for aln in alignments:
            line = sam_record(
                aln, query, self.pack, self.soft_clip, self.use_m, cg_tag=self.cg_tag
            )
            if self.ngmlr_tags:
                line += compute_tags(
                    aln, query, self.pack, alignments,
                    soft_clip=self.soft_clip, use_m_cigar=self.use_m,
                )
            if needs_cg_tag(aln, self.cg_tag):
                line += cg_tag_value(aln)
            self.out.write(line + "\n")


def compute_tags(
    aln: Alignment,
    query: NucSeq,
    pack: Pack,
    all_alignments=None,
    soft_clip: bool = False,
    use_m_cigar: bool = True,
) -> str:
    """NGMLR-emulation SAM tags (reference: fileWriter.h TagGenerator
    computeTag:115-365): MD, SV, AS, NM, XI, XE, XR, CV, QS/QE, SA."""
    from ma_tpu_torch.containers.alignment import (
        DELETION,
        INSERTION,
        MATCH,
        MISMATCH,
        SEED,
    )

    B = "ACGTN"
    tag = ""

    # ---- MD
    md = []
    rpos = aln.begin_on_ref
    nm = 0
    last_was_del = False
    for (op, size) in aln.data:
        if op in (MISMATCH, DELETION) and nm > 0:
            md.append(str(nm))
            nm = 0
        first = not last_was_del
        last_was_del = False
        if op in (SEED, MATCH):
            nm += size
            rpos += size
        elif op == INSERTION:
            pass
        elif op == MISMATCH:
            for c in pack.extract(rpos, rpos + size):
                if first:
                    first = False
                else:
                    md.append("0")
                md.append(B[c])
            rpos += size
        elif op == DELETION:
            md.append("^")
            md.append("".join(B[c] for c in pack.extract(rpos, rpos + size)))
            rpos += size
            last_was_del = True
    if nm > 0:
        md.append(str(nm))
    tag += "\tMD:Z:" + "".join(md)

    # ---- SV (Sniffles helper bits; holes unsupported -> bit 0x1 from holes)
    sv = 0
    if pack.holes:
        def hole_frac(lo, hi):
            lo, hi = max(lo, 0), min(hi, pack.unpacked_size_forward_plus_reverse)
            if hi <= lo:
                return 0.0
            cov = 0
            for (s, e) in pack.holes:
                cov += max(0, min(e, hi) - max(s, lo))
            return cov / (hi - lo)

        if (
            hole_frac(aln.begin_on_ref - 100, aln.begin_on_ref) > 0.8
            or hole_frac(aln.end_on_ref, aln.end_on_ref + 100) > 0.8
        ):
            sv += 1
    if aln.end_on_query - aln.begin_on_query >= len(query) * 0.95 or soft_clip:
        sv += 2
    tag += f"\tSV:i:{sv}"

    tag += f"\tAS:i:{aln.score()}"
    tag += f"\tNM:i:{aln.num_differences(True)}"
    span_q = max(aln.end_on_query - aln.begin_on_query, 1)
    span_r = max(aln.end_on_ref - aln.begin_on_ref, 1)
    tag += f"\tXI:f:{aln.num_matches() / min(span_q, span_r):.6f}"
    tag += f"\tXE:i:{aln.score()}"
    tag += f"\tXR:i:{aln.end_on_query - aln.begin_on_query}"
    tag += f"\tCV:f:{100.0 * (aln.end_on_query - aln.begin_on_query) / max(len(query), 1):.6f}"
    tag += f"\tQS:i:{aln.begin_on_query}\tQE:i:{aln.end_on_query}"

    # ---- SA: other non-secondary alignments of the same read
    if all_alignments and len(all_alignments) > 1:
        sa = []
        for other in all_alignments:
            if other is aln or other.secondary:
                continue
            if other.stats.first != aln.stats.first:
                continue
            strand = "-" if pack.is_reverse_strand(other.begin_on_ref) else "+"
            sa.append(
                f"{other.contig(pack)},{other.sam_position(pack)},{strand},"
                f"{other.cigar(pack, len(query), soft_clip, use_m_cigar)},"
                f"{other.sam_mapq() if other.sam_mapq() != 255 else 255},"
                f"{aln.num_differences(True)};"
            )
        if sa:
            tag += "\tSA:Z:" + "".join(sa)
    return tag
