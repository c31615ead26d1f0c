"""Host-side maximal seed extension (vectorized).

A copy of ma_tpu/ops/extend_host.py, changed only in its imports.

Re-design of the reference SeedExtender
(reference: libs/ma/inc/ma/module/seedFilters.h SeedExtender:70-160 —
extend each seed left and right over exactly-matching bases, clamped to the
owning contig; reverse seeds compare against the complement with mirrored
coordinates).

The reference walks base-by-base per seed; here all seeds of a read extend
together in chunked numpy comparisons (first mismatch per chunk via argmax)
— each round resolves 16 bases for every still-extending seed at once.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ma_tpu_torch.containers.pack import Pack

CHUNK = 16

SeedT = Tuple[int, int, int, bool, int]  # (q_start, len, ref_start, fwd, nt)


def _first_mismatch(a: np.ndarray, b: np.ndarray, limit: np.ndarray) -> np.ndarray:
    """Per row: number of leading positions where a==b, capped at limit."""
    neq = (a != b) | (
        np.arange(a.shape[1])[None, :] >= limit[:, None]
    )
    any_neq = neq.any(axis=1)
    first = np.where(any_neq, neq.argmax(axis=1), a.shape[1])
    return np.minimum(first, limit)


def extend_seeds(
    seeds: List[SeedT], query: np.ndarray, pack: Pack
) -> List[SeedT]:
    """Maximally extend every seed of one read (SeedExtender::execute)."""
    if not seeds:
        return seeds
    q = np.array([s[0] for s in seeds], np.int64)
    l = np.array([s[1] for s in seeds], np.int64)
    r = np.array([s[2] for s in seeds], np.int64)
    fw = np.array([s[3] for s in seeds], bool)
    nt = [s[4] for s in seeds]
    qlen = len(query)
    ref = pack.codes
    cid = pack.seq_id_for_position(np.minimum(r, pack.unpacked_size_forward_strand - 1))
    c_lo = pack.starts[cid].astype(np.int64)
    c_hi = c_lo + pack.lengths[cid].astype(np.int64)

    def gather(base_idx):
        idx = np.clip(base_idx, 0, len(ref) - 1)
        return ref[idx]

    # ---- leftward (towards query start)
    active = np.ones(len(seeds), bool)
    while True:
        # forward: limit by q and (r - c_lo); reverse: by q and (c_hi-1 - r)
        lim = np.minimum(q, np.where(fw, r - c_lo, c_hi - 1 - r))
        lim = np.where(active, np.clip(lim, 0, CHUNK), 0)
        if not (lim > 0).any():
            break
        off = np.arange(1, CHUNK + 1)
        qv = query[np.clip(q[:, None] - off[None, :], 0, qlen - 1)]
        rv_f = gather(r[:, None] - off[None, :])
        rv_r = 3 - gather(r[:, None] + off[None, :])
        rv = np.where(fw[:, None], rv_f, rv_r)
        n = _first_mismatch(qv, rv, lim)
        q -= n
        l += n
        r = np.where(fw, r - n, r + n)
        active = active & (n == CHUNK)  # a partial chunk means a mismatch
        if not active.any():
            break

    # ---- rightward (towards query end)
    active = np.ones(len(seeds), bool)
    while True:
        end_q = q + l
        end_ref_f = r + l  # forward: first base after the seed
        end_ref_r = r - l  # reverse: next base downward
        lim = np.minimum(
            qlen - end_q, np.where(fw, c_hi - end_ref_f, end_ref_r - c_lo + 1)
        )
        lim = np.where(active, np.clip(lim, 0, CHUNK), 0)
        if not (lim > 0).any():
            break
        off = np.arange(CHUNK)
        qv = query[np.clip(end_q[:, None] + off[None, :], 0, qlen - 1)]
        rv_f = gather(end_ref_f[:, None] + off[None, :])
        rv_r = 3 - gather(end_ref_r[:, None] - off[None, :])
        rv = np.where(fw[:, None], rv_f, rv_r)
        n = _first_mismatch(qv, rv, lim)
        l += n
        active = active & (n == CHUNK)
        if not active.any():
            break

    return [
        (int(q[i]), int(l[i]), int(r[i]), bool(fw[i]), nt[i])
        for i in range(len(seeds))
    ]
