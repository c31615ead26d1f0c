"""Read-set k-mer occurrence counting + over-frequent seed filtering.

Re-design of the reference KMerCounter/HashCounter + MMFilteredSeeding
(reference: libs/msv/inc/msv/module/count_k_mers.h — chunked concurrent
k-mer counter :183-251, seed filter dropping over-frequent k-mers :264-422)
and CombineOverlappingCalls (libs/msv/inc/msv/module/combineOverlappingCalls.h
:135-260 — SQL-assisted merge of overlapping calls across runs).

The concurrent hash table becomes one numpy sort/unique over all read
minimizer hashes; the SQL overlap walk becomes the same rectangle sweep
used for jump clustering.

A copy of ma_tpu/msv/kmer_filter.py, changed in its imports and in the
sketch: the port's `_sketch_arrays` takes a tensor and returns hashes as
int64 holding uint32 values; `_sketch` converts them to uint32, so the
counts are keyed by the same integers as ma_tpu's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ma_tpu_torch.index.minimizer import _sketch_arrays
from ma_tpu_torch.msv.calls import SvCall


def _sketch(codes: np.ndarray, k: int, w: int):
    """(minimizer mask [L] bool, hash [L] uint32) of one sequence, on the host."""
    sel, h, _, _ = _sketch_arrays(torch.from_numpy(np.asarray(codes, np.int32)), k, w)
    return sel.numpy(), h.numpy().astype(np.uint32)


class KMerCounter:
    """Counts canonical minimizer-hash occurrences over a read set."""

    def __init__(self, k: int = 15, w: int = 10):
        self.k = k
        self.w = w
        self._hashes: List[np.ndarray] = []
        self._counts: Dict[int, int] | None = None

    def add_sequence(self, codes: np.ndarray) -> None:
        if len(codes) < self.k + self.w:
            return
        sel, h = _sketch(codes, self.k, self.w)
        self._hashes.append(h[np.flatnonzero(sel)])
        self._counts = None

    def _ensure(self) -> Dict[int, int]:
        if self._counts is None:
            if self._hashes:
                allh = np.concatenate(self._hashes)
                vals, counts = np.unique(allh, return_counts=True)
                self._counts = dict(zip(vals.tolist(), counts.tolist()))
            else:
                self._counts = {}
        return self._counts

    def occurrences(self, h: int) -> int:
        return self._ensure().get(int(h), 0)

    def is_unique(self, hashes: Sequence[int], max_occ: int) -> bool:
        """isUnique (count_k_mers.h:209-225): every hash occurs <= max_occ."""
        c = self._ensure()
        return all(c.get(int(h), 0) <= max_occ for h in hashes)


def filter_frequent_seeds(
    seeds_per_read: List[List[tuple]],
    reads: Sequence,
    counter: KMerCounter,
    max_occ: int = 200,
) -> List[List[tuple]]:
    """MMFilteredSeeding's role (count_k_mers.h:402-422): drop seeds whose
    read k-mer window contains only over-frequent minimizers."""
    out = []
    for seeds, read in zip(seeds_per_read, reads):
        codes = np.asarray(read.codes if hasattr(read, "codes") else read, np.int32)
        sel, h = _sketch(codes, counter.k, counter.w)
        pos = np.flatnonzero(sel)
        kept = []
        for s in seeds:
            (q, l, *_rest) = s
            inside = pos[(pos >= q) & (pos + counter.k <= q + l)]
            if len(inside) == 0 or counter.is_unique(h[inside], max_occ):
                kept.append(s)
        out.append(kept)
    return out


def combine_overlapping_calls(
    calls: Sequence[SvCall], max_dist: int = 200
) -> List[SvCall]:
    """Merge calls whose rectangles (inflated by max_dist) overlap and share
    strand contexts (combineOverlappingCalls; 'Maximal distance between
    clusters' parameter)."""
    calls = list(calls)
    parent = list(range(len(calls)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        parent[find(i)] = find(j)

    for i in range(len(calls)):
        for j in range(i + 1, len(calls)):
            a, b = calls[i], calls[j]
            if a.from_forward != b.from_forward or a.to_forward != b.to_forward:
                continue
            if (
                a.from_pos <= b.from_pos + b.from_size + max_dist
                and b.from_pos <= a.from_pos + a.from_size + max_dist
                and a.to_pos <= b.to_pos + b.to_size + max_dist
                and b.to_pos <= a.to_pos + a.to_size + max_dist
            ):
                union(i, j)

    groups: Dict[int, List[SvCall]] = {}
    for i in range(len(calls)):
        groups.setdefault(find(i), []).append(calls[i])
    out = []
    for members in groups.values():
        if len(members) == 1:
            out.append(members[0])
            continue
        best = max(members, key=lambda c: c.supp_nt)
        merged = SvCall(
            from_pos=min(c.from_pos for c in members),
            to_pos=min(c.to_pos for c in members),
            from_size=max(c.from_pos + c.from_size for c in members)
            - min(c.from_pos for c in members),
            to_size=max(c.to_pos + c.to_size for c in members)
            - min(c.to_pos for c in members),
            from_forward=best.from_forward,
            to_forward=best.to_forward,
            supp_reads=sum(c.supp_reads for c in members),
            supp_nt=sum(c.supp_nt for c in members),
            inserted_sequence=best.inserted_sequence,
            reference_ambiguity=max(c.reference_ambiguity for c in members),
            supporting_jump_ids=sum((c.supporting_jump_ids for c in members), []),
        )
        out.append(merged)
    out.sort(key=lambda c: (c.from_pos, c.to_pos))
    return out
