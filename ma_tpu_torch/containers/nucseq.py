"""Nucleotide sequences, host side.

TPU-native re-design of the reference's NucSeq container
(reference: libs/ma/inc/ma/container/nucSeq.h:61 — 1 byte/base codes A,C,G,T,N -> 0..4).

Design notes (TPU-first):
* Single sequences are small numpy uint8 arrays (codes 0..4, 4 == N/unknown).
* Batches of reads are padded [B, L] int8/int32 device arrays plus a length
  vector — XLA needs static shapes, so reads are grouped into power-of-two
  length buckets (ReadBatch.bucketize).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

# Code table: A=0 C=1 G=2 T=3, anything else -> 4 (N).
_CODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i
_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N


def encode_seq(s: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A,C,G,T,N -> 0..4)."""
    if isinstance(s, str):
        s = s.encode()
    return _CODE[np.frombuffer(s, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return _CHAR[np.clip(codes, 0, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N stays N)."""
    return COMPLEMENT[codes[::-1]]


@dataclasses.dataclass
class NucSeq:
    """A named read: codes + optional quality string.

    Mirrors the roles of reference NucSeq (nucSeq.h:61): name, sequence,
    quality, complement/reverse operations.
    """

    codes: np.ndarray
    name: str = ""
    qual: str | None = None  # ASCII phred string, same length as codes

    @classmethod
    def from_str(cls, s: str, name: str = "", qual: str | None = None) -> "NucSeq":
        return cls(encode_seq(s), name=name, qual=qual)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def __str__(self) -> str:
        return decode_seq(self.codes)

    def revcomp(self) -> "NucSeq":
        q = self.qual[::-1] if self.qual is not None else None
        return NucSeq(revcomp_codes(self.codes), name=self.name, qual=q)


def _next_pow2(n: int, lo: int = 32) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@dataclasses.dataclass
class ReadBatch:
    """A fixed-shape batch of reads for device pipelines.

    seqs:  [B, L] uint8 codes, padded with 4 (N) past each read's length.
    lens:  [B] int32 true lengths (0 rows are padding reads).
    names: python-side read names (host only).
    quals: python-side quality strings (host only, may contain None).
    """

    seqs: np.ndarray
    lens: np.ndarray
    names: List[str]
    quals: List[str | None]

    @property
    def batch(self) -> int:
        return int(self.seqs.shape[0])

    @property
    def padded_len(self) -> int:
        return int(self.seqs.shape[1])

    @classmethod
    def from_reads(
        cls,
        reads: Sequence[NucSeq],
        padded_len: int | None = None,
        batch: int | None = None,
    ) -> "ReadBatch":
        n = len(reads)
        max_len = max((len(r) for r in reads), default=1)
        L = padded_len or _next_pow2(max_len)
        if max_len > L:
            raise ValueError(f"read of length {max_len} exceeds padded length {L}")
        B = batch or n
        if n > B:
            raise ValueError(f"{n} reads exceed batch {B}")
        seqs = np.full((B, L), 4, dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        names: List[str] = []
        quals: List[str | None] = []
        for i, r in enumerate(reads):
            seqs[i, : len(r)] = r.codes
            lens[i] = len(r)
            names.append(r.name)
            quals.append(r.qual)
        names += [""] * (B - n)
        quals += [None] * (B - n)
        return cls(seqs=seqs, lens=lens, names=names, quals=quals)

    @staticmethod
    def bucketize(
        reads: Sequence[NucSeq], batch: int, min_len: int = 128
    ) -> Iterable["ReadBatch"]:
        """Group reads into (power-of-two length bucket, batch-size) chunks.

        Keeps the number of distinct compiled shapes small: one shape per
        (bucket length). Reads keep their input order within a bucket.
        """
        buckets: dict[int, List[NucSeq]] = {}
        for r in reads:
            L = _next_pow2(max(len(r), 1), lo=min_len)
            buckets.setdefault(L, []).append(r)
        for L in sorted(buckets):
            rs = buckets[L]
            for i in range(0, len(rs), batch):
                chunk = rs[i : i + batch]
                yield ReadBatch.from_reads(chunk, padded_len=L, batch=batch)


# ------------------------------------------------------------- compression
def compress_codes(codes: np.ndarray):
    """Compact storable representation of base codes — the CompressedNucSeq
    role (reference: libs/ma/inc/ma/container/nucSeq.h:854-1145, 4-bit+RLE
    for DB blobs; format here: 2-bit packing with an N-run exception list).

    Returns (packed uint8 [ceil(n/4)], n, n_runs int64 [k, 2])."""
    codes = np.asarray(codes, np.uint8)
    n = len(codes)
    is_n = codes >= 4
    two_bit = np.where(is_n, 0, codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        two_bit = np.concatenate([two_bit, np.zeros(pad, np.uint8)])
    packed = (
        two_bit[0::4] | (two_bit[1::4] << 2) | (two_bit[2::4] << 4)
        | (two_bit[3::4] << 6)
    )
    # N runs as (start, length)
    d = np.diff(is_n.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if n and is_n[0]:
        starts = np.concatenate(([0], starts))
    if n and is_n[-1]:
        ends = np.concatenate((ends, [n]))
    runs = np.stack([starts, ends - starts], axis=1).astype(np.int64) \
        if len(starts) else np.zeros((0, 2), np.int64)
    return packed, n, runs


def decompress_codes(packed: np.ndarray, n: int, runs: np.ndarray) -> np.ndarray:
    """Inverse of compress_codes."""
    packed = np.asarray(packed, np.uint8)
    out = np.empty(len(packed) * 4, np.uint8)
    out[0::4] = packed & 3
    out[1::4] = (packed >> 2) & 3
    out[2::4] = (packed >> 4) & 3
    out[3::4] = (packed >> 6) & 3
    out = out[:n]
    for (s, l) in np.asarray(runs, np.int64):
        out[s : s + l] = 4
    return out
