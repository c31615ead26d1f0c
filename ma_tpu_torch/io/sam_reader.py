"""SAM parsing + alignment<->seed-set accuracy comparison harness.

A copy of ma_tpu/io/sam_reader.py, changed only in its imports.

Re-design of the reference evaluation tooling
(reference: libs/ma/inc/ma/module/sam_reader.h SamFileReader:11,
ReadByName:130, GetSeedsByName family :309-377, and
libs/ma/inc/ma/module/compare_alignments.h AlignmentToSeeds:12,
CompareSeedSets:37, CollectSeedSetComps:90): parse external SAM records
back into alignments/seed sets and score them against ground truth by
overlapping seed mass.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ma_tpu_torch.containers.pack import Pack

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

SeedT = Tuple[int, int, int, bool]  # (q_start, length, ref_start, on_forward)


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 1-based
    mapq: int
    cigar: str
    seq: str
    tags: Dict[str, str]

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 0x800)


def read_sam(path_or_file) -> Iterator[SamRecord]:
    """SamFileReader: yield mapped records."""
    f = open(path_or_file) if isinstance(path_or_file, str) else path_or_file
    for line in f:
        if line.startswith("@"):
            continue
        x = line.rstrip("\n").split("\t")
        if len(x) < 11 or x[2] == "*":
            continue
        tags = {}
        for t in x[11:]:
            parts = t.split(":", 2)
            if len(parts) == 3:
                tags[parts[0]] = parts[2]
        yield SamRecord(
            qname=x[0], flag=int(x[1]), rname=x[2], pos=int(x[3]),
            mapq=int(x[4]), cigar=x[5], seq=x[9], tags=tags,
        )


def records_by_name(path_or_file) -> Dict[str, List[SamRecord]]:
    """ReadByName role: group records by query name."""
    out: Dict[str, List[SamRecord]] = {}
    for rec in read_sam(path_or_file):
        out.setdefault(rec.qname, []).append(rec)
    return out


def alignment_to_seeds(rec: SamRecord, pack: Pack) -> List[SeedT]:
    """AlignmentToSeeds (compare_alignments.h:12): every match run of the
    CIGAR becomes a seed in our coordinate conventions (reverse-strand
    seeds use plain read coordinates + mirrored-largest ref coordinate)."""
    cid = pack.names.index(rec.rname)
    contig_start = int(pack.starts[cid])
    contig_len = int(pack.lengths[cid])
    r = contig_start + rec.pos - 1  # forward coordinate walker
    ops = _CIGAR_RE.findall(rec.cigar)
    qlen = sum(int(n) for (n, op) in ops if op in "MIS=X")
    seeds: List[SeedT] = []
    if not rec.is_reverse:
        q = 0
        for (n_s, op) in ops:
            n = int(n_s)
            if op in "M=X":
                seeds.append((q, n, r, True))
                q += n
                r += n
            elif op in "IS":
                q += n
            elif op in "DN":
                r += n
            elif op == "H":
                q += n
    else:
        # SAM stores the reverse-complemented read; walk the reference
        # forward while walking the original read backwards
        q = qlen  # exclusive end on the original read
        for (n_s, op) in ops:
            n = int(n_s)
            if op in "M=X":
                # original-read start of this run
                seeds.append((q - n, n, r + n - 1, False))
                q -= n
                r += n
            elif op in "IS":
                q -= n
            elif op in "DN":
                r += n
            elif op == "H":
                q -= n
    return seeds


def seed_overlap_nt(a: List[SeedT], b: List[SeedT]) -> int:
    """CompareSeedSets (compare_alignments.h:37): overlapping nt between two
    seed sets — positions matched to the same reference base and strand."""
    total = 0

    def cells(seeds):
        out = set()
        for (q, l, r, fw) in seeds:
            for j in range(l):
                out.add((q + j, r + j if fw else r - j, fw))
        return out

    ca = cells(a)
    for c in cells(b):
        if c in ca:
            total += 1
    return total


@dataclasses.dataclass
class SeedSetComp:
    """CollectSeedSetComps aggregate (compare_alignments.h:90)."""

    nt_ground_truth: int = 0
    nt_overlap: int = 0
    num_reads: int = 0

    def add(self, truth: List[SeedT], found: List[SeedT]) -> None:
        self.nt_ground_truth += sum(s[1] for s in truth)
        self.nt_overlap += seed_overlap_nt(truth, found)
        self.num_reads += 1

    @property
    def recall(self) -> float:
        return self.nt_overlap / self.nt_ground_truth if self.nt_ground_truth else 0.0


def read_ksw(path_or_file, pack: Pack) -> Iterator[Tuple[str, int, str]]:
    """KswFileReader (sam_reader.h:130-172): ksw output lines
    (contig, 1-based pos, ..., read name @ col 3, ..., cigar @ col 9) ->
    (read_name, global_ref_start, cigar)."""
    f = open(path_or_file) if isinstance(path_or_file, str) else path_or_file
    for line in f:
        line = line.rstrip("\n")
        if not line or line.startswith("@"):
            continue
        x = line.split("\t")
        if len(x) != 10:
            raise ValueError(
                "wrong number of tab separated columns for a ksw output file"
            )
        cid = pack.names.index(x[0])
        ref_start = int(x[1]) + int(pack.starts[cid]) - 1
        yield (x[3], ref_start, x[9])
