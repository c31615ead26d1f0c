"""FASTA / FASTQ readers (host input pipeline).

Covers the role of the reference FileReader/FileStream stack
(reference: libs/ma/inc/ma/module/fileReader.h:28-624 — FASTA/FASTQ parsing,
gzip support, paired zipping). The TPU engine consumes reads in fixed-shape
batches (ma_tpu_torch.containers.nucseq.ReadBatch), so readers here are simple
host-side generators; batching/bucketing happens downstream.
"""
from __future__ import annotations

import gzip
import io
from typing import IO, Iterable, Iterator, List, Sequence

from ma_tpu_torch.containers.nucseq import NucSeq, encode_seq


def _open_text(path_or_file) -> IO[str]:
    if hasattr(path_or_file, "read"):
        return path_or_file
    if str(path_or_file).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path_or_file, "rb"))
    return open(path_or_file, "r")


def read_fasta(path_or_file) -> Iterator[NucSeq]:
    """Yield NucSeq records from a FASTA file/path (plain or .gz)."""
    f = _open_text(path_or_file)
    name = None
    parts: List[str] = []
    for line in f:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield NucSeq(encode_seq("".join(parts)), name=name)
            name = line[1:].split()[0] if len(line) > 1 else ""
            parts = []
        else:
            parts.append(line)
    if name is not None:
        yield NucSeq(encode_seq("".join(parts)), name=name)


def read_fastq(path_or_file) -> Iterator[NucSeq]:
    """Yield NucSeq records from a FASTQ file/path (plain or .gz)."""
    f = _open_text(path_or_file)
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip()
        if not header:
            continue
        if not header.startswith("@"):
            raise ValueError(f"malformed FASTQ header: {header!r}")
        seq = f.readline().rstrip()
        plus = f.readline()
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ: expected '+' line")
        qual = f.readline().rstrip()
        name = header[1:].split()[0] if len(header) > 1 else ""
        yield NucSeq(encode_seq(seq), name=name, qual=qual or None)


def read_reads(path_or_file) -> Iterator[NucSeq]:
    """Sniff FASTA vs FASTQ from the first character (like FileReader's
    format detection, fileReader.h) and yield records."""
    f = _open_text(path_or_file)
    # peek first non-empty char
    pos_supported = f.seekable()
    first = ""
    while True:
        c = f.read(1)
        if not c:
            return iter(())
        if not c.isspace():
            first = c
            break
    if pos_supported:
        f.seek(0)
    else:  # pragma: no cover - non-seekable stream
        raise ValueError("read_reads requires a seekable stream")
    if first == ">":
        return read_fasta(f)
    if first == "@":
        return read_fastq(f)
    raise ValueError(f"cannot detect FASTA/FASTQ format (first char {first!r})")


def zip_paired(
    reads_a: Iterable[NucSeq], reads_b: Iterable[NucSeq]
) -> Iterator[tuple[NucSeq, NucSeq]]:
    """Zip two mate streams (PairedFileReader, fileReader.h:499-568)."""
    it_a, it_b = iter(reads_a), iter(reads_b)
    while True:
        a = next(it_a, None)
        b = next(it_b, None)
        if a is None and b is None:
            return
        if a is None or b is None:
            raise ValueError("paired files have unequal read counts")
        yield a, b
