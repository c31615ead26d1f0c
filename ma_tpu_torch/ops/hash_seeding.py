"""K-mer hash seeding between two sequences + MSV rectangle reseeding.

A copy of ma_tpu/ops/hash_seeding.py, changed only in its imports.

Re-design of the reference HashMapSeeding and the recursive rectangle
reseeding of the SV caller
(reference: libs/ma/inc/ma/module/hashMapSeeding.h:22-95 +
libs/ma/src/module/hashMapSeeding.cpp; rectangle k-mer size rule from
libs/msv/inc/msv/util/statisticSequenceAnalysis.h getKMerSizeForRectangle;
rectangle collection + strand handling from
libs/msv/src/module/svJumpsFromSeeds.cpp reseed/computeSeeds:230-330).

The unordered_multimap becomes a sorted packed-k-mer array + searchsorted
(numpy, host): rectangles are tiny (<= Max Size Reseed), so this is not a
device op. Rectangles between strand-switching seeds are simplified to the
bounding gap window on query/reference (the reference splits those into
two rectangles; the seeds recovered are a superset)."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ma_tpu_torch.containers.nucseq import revcomp_codes
from ma_tpu_torch.containers.pack import Pack

SeedT = Tuple[int, int, int, bool, int]


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Packed 2k-bit k-mer values for every start position (positions with
    N get value 2**62 so they never match)."""
    codes = np.asarray(codes, np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    vals = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for j in range(k):
        c = codes[j : j + n]
        vals = (vals << 2) | np.where(c < 4, c, 0)
        bad |= c >= 4
    return np.where(bad, np.int64(2) << 60, vals)


def hash_map_seeding(
    qa: np.ndarray, qb: np.ndarray, k: int
) -> List[Tuple[int, int, int]]:
    """All k-mer matches between sequences A and B:
    [(start_in_A, length=k, start_in_B)] (HashMapSeeding::execute)."""
    ka = pack_kmers(qa, k)
    kb = pack_kmers(qb, k)
    if not len(ka) or not len(kb):
        return []
    order = np.argsort(kb, kind="stable")
    sorted_b = kb[order]
    lo = np.searchsorted(sorted_b, ka, side="left")
    hi = np.searchsorted(sorted_b, ka, side="right")
    out = []
    for i in np.nonzero((hi > lo) & (ka < (np.int64(2) << 60)))[0]:
        for j in order[lo[i] : hi[i]]:
            out.append((int(i), k, int(j)))
    return out


def lump_diagonal(seeds: List[Tuple[int, int, int]]) -> List[Tuple[int, int, int]]:
    """Merge overlapping same-diagonal matches (SeedLumping on a pair of
    sequences, seedFilters.h:292-310)."""
    seeds = sorted(seeds, key=lambda s: (s[2] - s[0], s[0]))
    out: List[Tuple[int, int, int]] = []
    for (a, l, b) in seeds:
        if out and out[-1][2] - out[-1][0] == b - a and out[-1][0] + out[-1][1] >= a:
            pa, pl, pb = out[-1]
            out[-1] = (pa, max(pl, a + l - pa), pb)
        else:
            out.append((a, l, b))
    return out


def kmer_size_for_rectangle(w: int, h: int, t: float = 0.001) -> int:
    """Smallest k with expected random k-mer matches w*h/4^k <= t
    (getKMerSizeForRectangle)."""
    area = max(w, 1) * max(h, 1)
    return max(3, int(math.ceil(math.log(area / t, 4))))


def reseed_rectangle(
    query: np.ndarray,
    pack: Pack,
    q_lo: int,
    q_hi: int,
    r_lo: int,
    r_hi: int,
    t: float = 0.001,
    max_size: int = 50,
    nt: int = 0,
) -> List[SeedT]:
    """Hash-seed the query gap against both strands of the reference window
    (computeSeeds, svJumpsFromSeeds.cpp:230-330). Returns seed tuples in
    global coordinates with our SeedBatch conventions."""
    w, h = r_hi - r_lo, q_hi - q_lo
    if w <= 0 or h <= 0 or w > max_size or h > max_size:
        return []
    k = kmer_size_for_rectangle(w, h, t)
    if k > w or k > h:
        return []
    qseg = np.asarray(query[q_lo:q_hi])
    rseg = pack.extract(r_lo, r_hi)
    out: List[SeedT] = []
    for (a, l, b) in lump_diagonal(hash_map_seeding(qseg, rseg, k)):
        out.append((q_lo + a, l, r_lo + b, True, nt))
    rrev = revcomp_codes(rseg)
    for (a, l, b) in lump_diagonal(hash_map_seeding(qseg, rrev, k)):
        # position b in the revcomp window maps to forward last-coordinate
        # r_hi - 1 - b (reference: rSeed.uiPosOnReference = xXAxis.end - pos - 1)
        out.append((q_lo + a, l, r_hi - 1 - b, False, nt))
    return out


def reseed_gaps(
    seeds: Sequence[SeedT],
    query: np.ndarray,
    pack: Pack,
    t: float = 0.001,
    max_size: int = 50,
    padding: int = 100,
) -> List[SeedT]:
    """Reseed the rectangles between query-adjacent seeds and at the read
    edges; returns the original seeds plus recovered ones
    (SvJumpsFromSeeds::reseed, svJumpsFromSeeds.h:237+)."""
    ss = sorted((s for s in seeds if s[1] > 0), key=lambda s: s[0])
    out = list(ss)
    if not ss:
        return out
    qlen = len(query)
    L = pack.unpacked_size_forward_strand

    def ref_end(s):  # forward coordinate one past the match in read direction
        (q, l, r, fw, _) = s
        return r + l if fw else r - l

    def rect_between(a, b):
        q_lo, q_hi = a[0] + a[1], b[0]
        ra, rb = ref_end(a), b[2]
        r_lo, r_hi = min(ra, rb), max(ra, rb)
        return (q_lo, q_hi, max(r_lo, 0), min(r_hi, L))

    # read edges
    first, last = ss[0], ss[-1]
    fa = first[2] if first[3] else ref_end(first)
    out.extend(
        reseed_rectangle(query, pack, 0, first[0], max(fa - padding, 0), fa,
                         t, max_size, first[4])
    )
    lb = ref_end(last) if last[3] else last[2]
    out.extend(
        reseed_rectangle(query, pack, last[0] + last[1], qlen, lb,
                         min(lb + padding, L), t, max_size, last[4])
    )
    for a, b in zip(ss, ss[1:]):
        (q_lo, q_hi, r_lo, r_hi) = rect_between(a, b)
        out.extend(
            reseed_rectangle(query, pack, q_lo, q_hi, r_lo, r_hi, t,
                             max_size, min(a[4], b[4]))
        )
    return out
