"""Banded alignment scores in plain numpy, many problems at once.

The scoring is the one a SAM record's score is counted by: match +2,
mismatch -4, a gap of L bases -min(4 + 2 L, 100) (the aligner's Alignment
score: gap open 4, extend 2, capped at its SV penalty of 100). A band is
given per row: row i of problem p covers genome columns lo[p][i] ..
lo[p][i] + W - 1, so it can follow any path, a record's own or a read's
true origin. `local` gives the best local score (Smith-Waterman); else
the query is aligned end to end and the genome ends are free (the best
score of the whole query within the band).
"""
from __future__ import annotations

import numpy as np

NEG = -(1 << 40)
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND, GAP_CAP = 2, 4, 4, 2, 100


def gap_cost(length: int) -> int:
    return min(GAP_OPEN + GAP_EXTEND * length, GAP_CAP)


def _gather(m: np.ndarray, idx: np.ndarray, W: int) -> np.ndarray:
    ok = (idx >= 0) & (idx < W)
    return np.where(ok, np.take_along_axis(m, np.clip(idx, 0, W - 1), 1), NEG)


def best_scores(queries, lo_rows, W: int, genome: np.ndarray, local) -> np.ndarray:
    """The best score of each query within its band (see the module text).
    queries: uint8 arrays; lo_rows: int64 arrays of the same lengths;
    local: one bool, or one a query."""
    n = len(queries)
    if n == 0:
        return np.zeros(0, np.int64)
    lens = np.asarray([len(q) for q in queries], np.int64)
    order = np.argsort(-lens, kind="stable")
    slens = lens[order]
    loc = np.broadcast_to(np.asarray(local, bool), (n,))[order]
    floor = np.where(loc, 0, NEG)[:, None]
    Lmax = int(slens[0])
    Q = np.full((n, Lmax), 5, np.uint8)
    LO = np.zeros((n, Lmax), np.int64)
    for r, k in enumerate(order):
        Q[r, : lens[k]] = queries[k]
        LO[r, : lens[k]] = lo_rows[k]
    G = len(genome)
    gpad = np.concatenate([np.asarray(genome, np.uint8), np.array([6], np.uint8)])
    kk = np.arange(W, dtype=np.int64)
    H = np.zeros((n, W), np.int64)  # row -1: the free start
    F1 = np.full((n, W), NEG, np.int64)
    F2 = np.full((n, W), NEG, np.int64)
    best = np.full(n, NEG, np.int64)
    prev_lo = LO[:, 0] - 1
    for i in range(Lmax):
        a = int(np.searchsorted(-slens, -(i + 1), side="right"))  # problems with len > i
        lo = LO[:a, i]
        up = kk[None, :] + (lo - prev_lo[:a])[:, None]
        h_up = _gather(H[:a], up, W)
        h_dg = _gather(H[:a], up - 1, W)
        f1 = np.maximum(h_up - (GAP_OPEN + GAP_EXTEND), _gather(F1[:a], up, W) - GAP_EXTEND)
        f2 = np.maximum(h_up - GAP_CAP, _gather(F2[:a], up, W))
        cols = lo[:, None] + kk[None, :]
        inside = (cols >= 0) & (cols < G)
        ref = gpad[np.where(inside, cols, G)]
        s = np.where(ref == Q[:a, i, None], MATCH, -MISMATCH)
        h0 = np.maximum(np.maximum(h_dg + s, np.maximum(f1, f2)), floor[:a])
        h0 = np.where(inside, h0, NEG)
        # gaps along the row, from h0 (a gap after a gap is never better
        # than one gap: the cost is subadditive)
        e1 = np.full_like(h0, NEG)
        e1[:, 1:] = (np.maximum.accumulate(h0 + GAP_EXTEND * kk, axis=1)[:, :-1]
                     - GAP_OPEN - GAP_EXTEND * kk[1:])
        e2 = np.full_like(h0, NEG)
        e2[:, 1:] = np.maximum.accumulate(h0, axis=1)[:, :-1] - GAP_CAP
        h = np.where(inside, np.maximum(h0, np.maximum(e1, e2)), NEG)
        H[:a] = h
        F1[:a] = np.where(inside, f1, NEG)
        F2[:a] = np.where(inside, f2, NEG)
        row_max = h.max(axis=1)
        best[:a] = np.where(loc[:a], np.maximum(best[:a], row_max), best[:a])
        end = ~loc[:a] & (slens[:a] == i + 1)
        best[:a][end] = row_max[end]
        prev_lo[:a] = lo
    out = np.empty(n, np.int64)
    out[order] = best
    return out


def banded(queries, rows_min, rows_max, genome, local, slack: int) -> np.ndarray:
    """best_scores over bands that cover, in every row, the columns
    rows_min[i]..rows_max[i] widened by `slack` on both sides; problems of
    like width go together. local: one bool, or one a query."""
    loc = np.broadcast_to(np.asarray(local, bool), (len(queries),))
    n = len(queries)
    out = np.zeros(n, np.int64)
    need = np.asarray([int((mx - mn).max()) + 2 * slack + 1 if len(mn) else 1
                       for mn, mx in zip(rows_min, rows_max)], np.int64)
    cls = np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64)
    for c in np.unique(cls):
        sel = np.flatnonzero(cls == c)
        W = int(need[sel].max())
        out[sel] = best_scores([queries[k] for k in sel],
                               [np.asarray(rows_min[k], np.int64) - slack for k in sel],
                               W, genome, loc[sel])
    return out
