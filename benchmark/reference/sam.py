"""SAM text to records, and the forward-strand view of a record."""
from __future__ import annotations

import dataclasses
import re

import numpy as np

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY = 0x10, 0x100, 0x800


@dataclasses.dataclass
class Record:
    name: str
    flag: int
    contig: str
    pos: int  # 1-based
    mapq: int
    cigar: str
    seq: str

    @property
    def primary(self) -> bool:
        return not self.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)

    @property
    def reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)


def parse(sam: str) -> list:
    out = []
    for line in sam.splitlines():
        if not line or line[0] == "@":
            continue
        f = line.split("\t", 11)
        out.append(Record(f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5], f[9]))
    return out


def encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def cigar_ops(cigar: str) -> list:
    """[(op, length)]; raises ValueError on text that is not a CIGAR."""
    ops = [(op, int(n)) for n, op in CIGAR_RE.findall(cigar)]
    if "".join(f"{n}{op}" for op, n in ops) != cigar or not ops:
        raise ValueError(f"malformed CIGAR {cigar!r}")
    return ops
