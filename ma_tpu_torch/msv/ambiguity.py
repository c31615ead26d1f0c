"""Call reference-ambiguity estimation via k-mer sampling.

A copy of ma_tpu/msv/ambiguity.py, changed only in its imports.

Re-design of the reference statisticSequenceAnalysis + ComputeCallAmbiguity
(reference: libs/msv/src/util/statisticSequenceAnalysis.cpp
sampleSequenceAmbiguity:55-72 — lumped shared-k-mer mass between the
breakend neighborhoods; region/strand pairing from
libs/msv/inc/msv/util/statisticSequenceAnalysis.h
sampleSequenceAmbiguity:94-126 and getRegion:60-92; module wiring from
libs/msv/inc/msv/module/sweepSvJumps.h ComputeCallAmbiguity:637-660).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ma_tpu_torch.containers.nucseq import revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.ops.hash_seeding import (
    hash_map_seeding,
    kmer_size_for_rectangle,
    lump_diagonal,
)


def _get_region(pos: int, left: bool, pack: Pack, distance: int) -> np.ndarray:
    L = pack.unpacked_size_forward_strand
    pos = min(pos, L - 1)
    cid = int(pack.seq_id_for_position(pos))
    lo = int(pack.starts[cid])
    hi = lo + int(pack.lengths[cid])
    if left:
        start = max(pos - distance, lo)
        return pack.extract(start, pos)
    end = min(pos + distance, hi)
    return pack.extract(pos, end)


def sample_sequence_ambiguity(
    a: np.ndarray, b: np.ndarray, t: float = 0.001
) -> int:
    """Shared lumped k-mer mass between two sequences minus their lengths,
    floored at 1 (sampleAmbiguity, statisticSequenceAnalysis.h:52-57)."""
    n = len(a) + len(b)
    if n == 0:
        return 1
    k = kmer_size_for_rectangle(n, n, t)
    total = 0
    # cross AND self comparisons: the trivial self-matches contribute exactly
    # len(a) + len(b), which the subtraction below removes — what remains is
    # the repeat mass (the reference's docstring semantics; its impl comments
    # out the self-comparisons, making the subtraction degenerate)
    for (x, y) in ((a, b), (a, a), (b, b)):
        for (_, l, _) in lump_diagonal(hash_map_seeding(x, y, k)):
            total += l
    return max(1, total - len(a) - len(b))


def call_ambiguity(
    call: SvCall, pack: Pack, distance_max: int = 20, distance_min: int = 5
) -> int:
    """sampleSequenceAmbiguity over the four breakend neighborhoods."""
    f = call.from_pos + call.from_size // 2
    t_ = call.to_pos + call.to_size // 2
    size = abs(f - t_)
    if size <= distance_min and call.from_forward == call.to_forward:
        return 1
    dist = min(size, distance_max) or 1
    left_from = _get_region(f, True, pack, dist)
    right_from = _get_region(f, False, pack, dist)
    left_to = _get_region(t_, True, pack, dist)
    right_to = _get_region(t_, False, pack, dist)
    if call.from_forward != call.to_forward:
        left_to = revcomp_codes(left_to)
        right_to = revcomp_codes(right_to)
        a = sample_sequence_ambiguity(left_from, right_to)
        b = sample_sequence_ambiguity(right_from, left_to)
    else:
        a = sample_sequence_ambiguity(left_from, left_to)
        b = sample_sequence_ambiguity(right_from, right_to)
    return max(a, b)


def compute_call_ambiguity(
    calls: Sequence[SvCall], pack: Pack, distance: int = 20
) -> List[SvCall]:
    """ComputeCallAmbiguity module: set reference_ambiguity on every call
    (the call score becomes supp_nt / ambiguity)."""
    for c in calls:
        c.reference_ambiguity = call_ambiguity(c, pack, distance_max=distance)
    return list(calls)
