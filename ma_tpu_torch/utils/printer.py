"""Human-readable alignment rendering.

A copy of ma_tpu/utils/printer.py, changed only in its imports.

Re-design of the reference's AlignmentPrinter python helper
(reference: libs/ma/python/ — prints query/bars/reference rows per
alignment for debugging).
"""
from __future__ import annotations

from ma_tpu_torch.containers.alignment import (
    Alignment,
    DELETION,
    INSERTION,
    MATCH,
    MISMATCH,
    SEED,
)
from ma_tpu_torch.containers.nucseq import decode_seq
from ma_tpu_torch.containers.pack import Pack


def format_alignment(aln: Alignment, query, pack: Pack, width: int = 80) -> str:
    """Three-row dump: query row, match bars, reference row."""
    q_row, bars, r_row = [], [], []
    qpos, rpos = aln.begin_on_query, aln.begin_on_ref
    B = "ACGTN"
    for (op, size) in aln.data:
        if op in (SEED, MATCH, MISMATCH):
            for k in range(size):
                qc = int(query[qpos + k])
                rc = int(pack.extract(rpos + k, rpos + k + 1)[0])
                q_row.append(B[qc])
                r_row.append(B[rc])
                bars.append("|" if qc == rc and qc < 4 else
                            ("*" if op == MISMATCH or qc != rc else "|"))
            qpos += size
            rpos += size
        elif op == INSERTION:
            for k in range(size):
                q_row.append(B[int(query[qpos + k])])
                r_row.append("-")
                bars.append(" ")
            qpos += size
        else:
            for k in range(size):
                q_row.append("-")
                r_row.append(B[int(pack.extract(rpos + k, rpos + k + 1)[0])])
                bars.append(" ")
            rpos += size
    lines = [
        f"query [{aln.begin_on_query},{aln.end_on_query}) vs "
        f"{aln.contig(pack)}:{aln.sam_position(pack)} score={aln.score()}"
    ]
    for s in range(0, len(q_row), width):
        lines.append("Q " + "".join(q_row[s : s + width]))
        lines.append("  " + "".join(bars[s : s + width]))
        lines.append("R " + "".join(r_row[s : s + width]))
        lines.append("")
    return "\n".join(lines)
