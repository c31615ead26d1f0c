"""Plane-sweep clustering of SV jumps into calls.

A copy of ma_tpu/msv/sweep.py, changed only in its imports.

Re-design of the reference sweep modules
(reference: libs/msv/inc/msv/module/sweepSvJumps.h
CompleteBipartiteSubgraphSweep:82-270 — coarse active-cluster sweep over
jump rectangles, ExactCompleteBipartiteSubgraphSweep:274-480 — exact
re-sweep with per-read jump dedup and cluster-size re-estimation — and the
call filters :488-700; cluster join/reestimate semantics from
libs/msv/inc/msv/container/svJump.h SvCall:556-768).

The SQL fetch becomes an in-memory jump COLUMN SET (msv/jumps_batch.py
JumpBatch): every sweep coordinate is precomputed vectorized, the event
loop walks scalar numpy columns, and clusters carry index lists — no
SvJump objects exist on the clustering path (round-4 re-design; the
object API remains accepted and is converted on entry)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import SvJump
from ma_tpu_torch.msv.jumps_batch import JumpBatch


@dataclasses.dataclass
class _Cols:
    """Precomputed sweep columns for one jump set."""

    x_start: np.ndarray
    x_end: np.ndarray
    y_start: np.ndarray
    y_end: np.ndarray  # tail edges already squared (sweepSvJumps.h:339-341)
    from_forward: np.ndarray
    to_forward: np.ndarray
    dummy: np.ndarray
    mirrored: np.ndarray
    supp_nt: np.ndarray
    read_id: np.ndarray
    qdist: np.ndarray
    from_known: np.ndarray
    to_known: np.ndarray
    from_pos: np.ndarray
    to_pos: np.ndarray
    jump_id: np.ndarray

    @classmethod
    def from_batch(cls, jb: JumpBatch) -> "_Cols":
        known = jb.switch_strand_known()
        return cls(
            x_start=jb.from_start(),
            x_end=jb.from_end(),
            y_start=jb.to_start(),
            y_end=np.where(known, jb.to_end(), jb.sweep_end()),
            from_forward=jb.from_forward,
            to_forward=jb.to_forward,
            dummy=~known,
            mirrored=jb.was_mirrored,
            supp_nt=jb.num_supporting_nt,
            read_id=jb.read_id,
            qdist=jb.query_distance(),
            from_known=jb.from_known(),
            to_known=jb.to_known(),
            from_pos=jb.from_pos,
            to_pos=jb.to_pos,
            jump_id=jb.id,
        )


@dataclasses.dataclass
class _Cluster:
    x_start: int
    x_end: int
    y_start: int
    y_end: int
    first: int  # creating jump index (strand/dummy/mirror flags)
    members: List[int]
    open_edges: int

    def join(self, other: "_Cluster") -> None:
        self.x_start = min(self.x_start, other.x_start)
        self.x_end = max(self.x_end, other.x_end)
        self.y_start = min(self.y_start, other.y_start)
        self.y_end = max(self.y_end, other.y_end)
        self.members.extend(other.members)
        self.open_edges += other.open_edges


def _sweep_fast(cols: _Cols, idx: np.ndarray) -> List[_Cluster]:
    """Interval sweep over x with y-overlap cluster joining — the
    CompleteBipartiteSubgraphSweep (sweepSvJumps.h:82-270) on columns.
    Members are tracked as LOCAL positions during the sweep (so ownership
    reassignment on join is direct) and translated to global jump indices
    at the end."""
    n = len(idx)
    if n == 0:
        return []
    xs = cols.x_start[idx]
    xe = cols.x_end[idx]
    ys = cols.y_start[idx]
    ye = cols.y_end[idx]
    # events: (coord, is_end, local index); starts before ends at a tie
    ev_coord = np.concatenate([xs, xe])
    ev_end = np.concatenate([np.zeros(n, np.int8), np.ones(n, np.int8)])
    order = np.lexsort((ev_end, ev_coord))
    owner: List[Optional[_Cluster]] = [None] * n
    active: List[_Cluster] = []
    done: List[_Cluster] = []
    for e in order:
        i = int(e % n)
        is_end = e >= n
        if not is_end:
            c = _Cluster(
                x_start=int(xs[i]), x_end=int(xe[i]), y_start=int(ys[i]),
                y_end=int(ye[i]), first=i, members=[i], open_edges=1,
            )
            owner[i] = c
            keep = []
            for a in active:
                if a.y_start <= c.y_end and c.y_start <= a.y_end:
                    c.join(a)
                    for li in a.members:
                        owner[li] = c
                else:
                    keep.append(a)
            keep.append(c)
            active = keep
        else:
            c = owner[i]
            c.open_edges -= 1
            if c.open_edges == 0:
                active.remove(c)
                done.append(c)
    for c in done:
        c.first = int(idx[c.first])
        c.members = [int(idx[li]) for li in c.members]
    return done


def _reestimate(cols: _Cols, members: np.ndarray, dummy: bool,
                from_forward: bool, to_forward: bool) -> Tuple[int, int]:
    """reEstimateClusterSize (svJump.h:664-703): percentile breakpoint
    estimate from member jump endpoints."""
    fk = cols.from_known[members]
    tk = cols.to_known[members]
    # horizontal: from_pos where from_known; vertical: to_pos where
    # to_known-or-not-from_known (the oracle's three append branches)
    horizontal = np.sort(cols.from_pos[members][fk])
    vertical = np.sort(cols.to_pos[members][~fk | tk])
    if dummy:
        ui, uj = len(horizontal), 0
        umin, umax = 1, 0
        while umin > umax and ui > 0 and uj < len(vertical):
            umin = int(horizontal[ui - 1])
            umax = int(vertical[uj])
            ui -= 1
            uj += 1
        if ui == 0 or uj == len(vertical):
            if ui == 0 and len(vertical):
                pos = int(vertical[int(len(vertical) * 0.05)])
            elif len(horizontal):
                pos = int(horizontal[int(len(horizontal) * 0.95)])
            else:
                pos = 0
        else:
            pos = (umin + umax) // 2
        return pos, pos
    x = int(horizontal[int(len(horizontal) * (0.95 if from_forward else 0.05))])
    y = int(vertical[int(len(vertical) * (0.05 if to_forward else 0.95))])
    return x, y


def _finalize(cols: _Cols, c: _Cluster, min_reads: int) -> Optional[SvCall]:
    # per-read dedup keeping the smallest query distance (exact sweep,
    # sweepSvJumps.h:389-409) — stable sort preserves join order at ties
    members = np.asarray(c.members, np.int64)
    order = np.argsort(cols.qdist[members], kind="stable")
    sorted_m = members[order]
    # first occurrence per read in qdist order == the oracle's dict
    # insertion order
    _, first_pos = np.unique(cols.read_id[sorted_m], return_index=True)
    kept = sorted_m[np.sort(first_pos)]
    if len(kept) < min_reads:
        return None
    dummy = bool(cols.dummy[c.first])
    x, y = _reestimate(cols, kept, dummy, bool(cols.from_forward[c.first]),
                       bool(cols.to_forward[c.first]))
    return SvCall(
        from_pos=x,
        to_pos=y,
        from_size=0,
        to_size=0,
        from_forward=bool(cols.from_forward[c.first]),
        to_forward=bool(cols.to_forward[c.first]),
        supp_reads=int(len(kept)),
        supp_nt=int(cols.supp_nt[kept].sum()),
        supporting_jump_ids=[int(v) for v in cols.jump_id[kept]],
        mirrored=bool(cols.mirrored[c.first]) and bool(
            cols.mirrored[kept].all()
        ),
    )


def _independent_sections(cols: _Cols) -> List[np.ndarray]:
    """Partition jumps into x-independent groups with numpy.

    The sweep's active set empties exactly where the next from_start lies
    strictly beyond the running max from_end, so cutting there decomposes
    the clustering EXACTLY (the genome-section work units of
    sweepSvJumps.h GenomeSectionFactory:23-75, minus the overlap/dedup
    rules — these cuts cannot split a cluster)."""
    n = len(cols.x_start)
    order = np.argsort(cols.x_start, kind="stable")
    s = cols.x_start[order]
    e = np.maximum.accumulate(cols.x_end[order])
    brk = np.flatnonzero(s[1:] > e[:-1]) + 1
    bounds = np.concatenate(([0], brk, [n]))
    return [
        order[bounds[i] : bounds[i + 1]] for i in range(len(bounds) - 1)
    ]


def sweep_jumps(
    jumps: Union[Sequence[SvJump], JumpBatch], min_reads: int = 2
) -> List[SvCall]:
    """Full clustering: coarse sweep -> exact re-sweep per coarse cluster ->
    per-read dedup + breakpoint re-estimation -> min-support filter.

    Accepts a JumpBatch (the scale path) or a list of SvJump objects
    (converted on entry). Large inputs first decompose into x-independent
    sections so whole-genome jump sets cluster in near-linear time."""
    if isinstance(jumps, JumpBatch):
        jb = jumps
    else:
        jb = JumpBatch.from_jumps(list(jumps))
    if len(jb) == 0:
        return []
    cols = _Cols.from_batch(jb)
    calls: List[SvCall] = []
    groups = (
        _independent_sections(cols)
        if len(jb) > 512
        else [np.arange(len(jb), dtype=np.int64)]
    )
    for group in groups:
        for coarse in _sweep_fast(cols, group):
            for exact in _sweep_fast(cols, np.asarray(coarse.members, np.int64)):
                call = _finalize(cols, exact, min_reads)
                if call is not None:
                    calls.append(call)
    calls.sort(key=lambda c: (c.from_pos, c.to_pos))
    return calls


# ----------------------------------------------------------------- filters
def filter_low_support_short_calls(
    calls: List[SvCall], max_supp_nt: int = 10, max_call_size: int = 20
) -> List[SvCall]:
    """FilterLowSupportShortCalls (sweepSvJumps.h:488): diagonal noise —
    drop short calls with low supporting-nt."""
    out = []
    for c in calls:
        size = abs(c.to_pos - c.from_pos)
        if c.supp_nt / max(c.supp_reads, 1) <= max_supp_nt and size <= max_call_size:
            continue
        out.append(c)
    return out


def filter_fuzzy_calls(calls: List[SvCall], max_fuzziness: int = 50) -> List[SvCall]:
    """FilterFuzzyCalls (sweepSvJumps.h:528): drop calls whose rectangle is
    wider than the fuzziness cap."""
    return [
        c for c in calls if c.from_size <= max_fuzziness and c.to_size <= max_fuzziness
    ]


def filter_diagonal_line_calls(
    calls: List[SvCall], jumps_of=None, threshold: int = 300
) -> List[SvCall]:
    """FilterDiagonalLineCalls (sweepSvJumps.h:567-620): drop calls whose
    supporting jumps form a line along the main diagonal — their (y-x)
    variance is tiny relative to the (y+x) variance. jumps_of maps a call
    to its supporting SvJump list (falls back to keeping the call)."""

    def med_var(vals: List[int]) -> int:
        vals = sorted(vals)
        n = len(vals)
        med = vals[n // 2] if n % 2 == 1 else (vals[n // 2 - 1] + vals[n // 2]) // 2
        return sum((med - v) * (med - v) for v in vals) // n

    out = []
    for c in calls:
        jumps = jumps_of(c) if jumps_of is not None else None
        if not jumps:
            out.append(c)
            continue
        da = [j.to_pos - j.from_pos for j in jumps]
        db = [j.to_pos + j.from_pos for j in jumps]
        va = med_var(da)
        vb = max(med_var(db), 1)
        if va // vb < threshold or vb < 10:
            out.append(c)
    return out


def filter_low_score_calls(calls: List[SvCall], min_score: float = 2.0) -> List[SvCall]:
    """FilterLowScoreCalls (sweepSvJumps.h:668): score = supp_nt/ambiguity."""
    return [c for c in calls if c.score() >= min_score]
