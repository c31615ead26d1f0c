"""MEM seeding (host): all maximal exact matches.

Re-design of the reference memExtension
(reference: libs/ma/inc/ma/module/binarySeeding.h memExtension:460-537 —
for every query position extend rightwards; at every hit-loss take the
interval difference, probe one left extension, and emit the left-maximal
rows, with the per-row rescue when only some rows are left-maximal).

MEM enumeration is O(L^2) backward searches with data-dependent interval
set differences — the reference offers it as an accuracy-comparison mode,
not a hot path, so this runs on host against the host FMDIndex. The seeds
feed the same device SoC/harmonization stage as the other techniques.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ma_tpu_torch.index.fmd_index import FMDIndex

# host SAInterval = (start, start_rc, size); start_rc = -1 when unknown
SAI = Tuple[int, int, int]
EMPTY: SAI = (0, -1, 0)


def _revcomp(ik: SAI) -> SAI:
    return (ik[1], ik[0], ik[2])


def _differences(parent: SAI, child: SAI):
    """SAInterval::do_for_difference: the rows of parent not in child
    (child is a sub-interval of parent, possibly empty)."""
    ps, _, pn = parent
    cs, _, cn = child
    if cn <= 0:
        if pn > 0:
            yield (ps, -1, pn)
        return
    if cs > ps:
        yield (ps, -1, cs - ps)
    if ps + pn > cs + cn:
        yield (cs + cn, -1, ps + pn - (cs + cn))


def mem_seeding(
    fmd: FMDIndex,
    q: np.ndarray,
    min_seed_size: int = 15,
    min_ambiguity: int = 0,
    max_ambiguity: int = 100,
) -> List[Tuple[int, int, SAI]]:
    """All MEM segments of one read: [(q_start, q_size, interval)] with the
    Segment size convention (seed length = q_size + 1)."""
    q = np.asarray(q)
    L = len(q)
    comp = lambda c: 3 - c if c < 4 else c
    segs: List[Tuple[int, int, SAI]] = []
    for i in range(L):
        if q[i] >= 4:
            continue
        ik = fmd.init_interval(comp(q[i]))
        j = i + 1
        while j <= L and ik[2] > min_ambiguity:
            ok = EMPTY
            if j < L and q[j] < 4:
                ok = fmd.extend_backward(ik, comp(q[j]))
            if j - i - 1 > min_seed_size and ok[2] < ik[2] and ik[2] < max_ambiguity:
                for diff in _differences(_revcomp(ik), _revcomp(ok)):
                    ext = EMPTY
                    if i > 0:
                        ext = fmd.extend_backward(diff, int(q[i - 1]))
                    if ext[2] == 0:
                        segs.append((i, j - i - 1, diff))
                    elif ext[2] < diff[2]:
                        # per-row rescue: emit runs of left-maximal rows
                        k_last = diff[0]
                        for k in range(diff[0], diff[0] + diff[2] + 1):
                            if (
                                k == diff[0] + diff[2]
                                or fmd.extend_backward((k, -1, 1), int(q[i - 1]))[2]
                                != 0
                            ):
                                if k > k_last:
                                    segs.append((i, j - i - 1, (k_last, -1, k - k_last)))
                                k_last = k + 1
            ik = ok
            j += 1
    return segs


def materialize_mem_seeds(
    fmd: FMDIndex,
    segs: List[Tuple[int, int, SAI]],
    max_ambiguity: int = 100,
) -> List[Tuple[int, int, int, bool, int]]:
    """Walk the suffix array for every segment row -> seed tuples
    (q_start, length, ref_start_forward_coords, on_forward, ambiguity)."""
    out = []
    half = fmd.n // 2
    for (qs, qsize, (s, _rc, n)) in segs:
        if n <= 0:
            continue
        jump = max(n // max_ambiguity, 1) if max_ambiguity and n > max_ambiguity else 1
        for row in range(s, s + n, jump):
            pos = fmd.bwt_sa(row)
            on_fwd = pos < half
            ref = pos if on_fwd else fmd.n - pos - 1
            out.append((qs, qsize + 1, int(ref), bool(on_fwd), int(n)))
    return out
