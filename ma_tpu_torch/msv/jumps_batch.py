"""SoA SV jumps: vectorized enumeration + sweep-coordinate columns.

A copy of ma_tpu/msv/jumps_batch.py, changed only in its imports.

The per-object SvJump path (msv/jumps.py) mirrors the reference's
container semantics (svJump.h:15-388, svJumpsFromSeeds.h:374-431) and
stays as the oracle; this module re-expresses jump ENUMERATION and every
derived sweep coordinate as numpy column math so sequencing-scale jump
sets (hundreds of millions for a 30x human run, sweepSvJumps.h's reason
for streaming through SQL) never materialize Python objects.

Equivalence with the oracle is asserted element-wise in
tests/test_msv_batch.py on randomized seed sets.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ma_tpu_torch.msv.jumps import (
    DUMMY_LOCATION,
    FROM_POS_NUM_SECTIONS,
    INT64_MAX,
    JumpParams,
    SvJump,
)


@dataclasses.dataclass
class JumpBatch:
    """Columns, one row per jump (all int64 / bool numpy arrays)."""

    from_pos: np.ndarray
    to_pos: np.ndarray
    query_from: np.ndarray
    query_to: np.ndarray
    from_forward: np.ndarray  # bool
    to_forward: np.ndarray  # bool
    num_supporting_nt: np.ndarray
    read_id: np.ndarray
    was_mirrored: np.ndarray  # bool
    id: np.ndarray
    params: JumpParams = JumpParams()

    def __len__(self) -> int:
        return len(self.from_pos)

    # ------------------------------------------------------- derived columns
    # each mirrors the same-named SvJump method (jumps.py / svJump.h)
    def from_known(self):
        return self.from_pos != DUMMY_LOCATION

    def to_known(self):
        return self.to_pos != DUMMY_LOCATION

    def switch_strand_known(self):
        return self.from_known() & self.to_known()

    def is_dummy(self):
        return ~self.switch_strand_known()

    def query_distance(self):
        return self.query_to - self.query_from

    def ref_distance(self):
        return np.abs(self.to_pos - self.from_pos)

    def size(self):
        return np.where(
            self.is_dummy(),
            INT64_MAX // 4,
            np.maximum(self.query_distance(), self.ref_distance()),
        )

    def fuzziness(self):
        p = self.params
        qd = self.query_distance()
        x = np.maximum(self.ref_distance(), qd).astype(np.float64)
        s = np.where(
            (self.to_pos >= self.from_pos) | (qd >= self.from_pos - self.to_pos),
            p.jump_s,
            p.jump_s_neg,
        )
        return np.minimum(p.jump_h, np.maximum(0.0, x - s) * p.jump_m).astype(
            np.int64
        )

    def seed_dir_fuzziness(self):
        p = self.params
        act = p.seed_dir_fuzziness * 2
        return np.where(
            self.is_dummy(),
            np.where(self.query_distance() > act, p.seed_dir_fuzziness, 0),
            np.where(self.fuzziness() > act, p.seed_dir_fuzziness, 0),
        ).astype(np.int64)

    def from_fuzziness_is_rightwards(self):
        return np.where(
            ~self.from_known(), False,
            np.where(~self.to_known(), True, self.from_forward),
        )

    def to_fuzziness_is_downwards(self):
        return np.where(
            ~self.from_known(), True,
            np.where(~self.to_known(), False, self.to_forward),
        )

    def from_start_same_strand(self):
        z = np.int64(0)
        qd = self.query_distance()
        sdf = self.seed_dir_fuzziness()
        fz = self.fuzziness()
        return np.where(
            ~self.from_known(),
            np.maximum(z, self.to_pos - qd + sdf),
            np.where(
                ~self.to_known(),
                np.maximum(z, self.from_pos - sdf),
                np.where(
                    self.from_fuzziness_is_rightwards(),
                    np.maximum(z, self.from_pos - sdf),
                    np.maximum(z, self.from_pos - fz),
                ),
            ),
        )

    def from_start(self):
        ret = self.from_start_same_strand()
        dummy = self.is_dummy()
        ret = ret + np.where(dummy, INT64_MAX // (FROM_POS_NUM_SECTIONS // 4), 0)
        ret = ret + np.where(
            ~dummy & ~self.from_forward, INT64_MAX // (FROM_POS_NUM_SECTIONS // 2), 0
        )
        ret = ret + np.where(
            ~dummy & ~self.to_forward, INT64_MAX // FROM_POS_NUM_SECTIONS, 0
        )
        return ret

    def from_size(self):
        return np.where(
            self.is_dummy(),
            self.query_distance() + self.seed_dir_fuzziness(),
            self.fuzziness() + self.seed_dir_fuzziness(),
        )

    def from_end(self):
        return self.from_start() + self.from_size()

    def to_start(self):
        z = np.int64(0)
        qd = self.query_distance()
        sdf = self.seed_dir_fuzziness()
        fz = self.fuzziness()
        return np.where(
            ~self.from_known(),
            np.maximum(z, self.to_pos - qd + sdf) + 1,
            np.where(
                ~self.to_known(),
                np.maximum(z, self.from_pos - sdf) + 1,
                np.where(
                    ~self.to_fuzziness_is_downwards(),
                    np.maximum(z, self.to_pos - sdf),
                    np.maximum(z, self.to_pos - fz),
                ),
            ),
        )

    def to_size(self):
        return np.where(
            self.is_dummy(), 0, self.fuzziness() + self.seed_dir_fuzziness()
        )

    def to_end(self):
        return self.to_start() + self.to_size()

    def sweep_end(self):
        return np.where(
            self.switch_strand_known(),
            self.to_end(),
            self.to_start() + self.from_size(),
        )

    def insert_ratio(self):
        return np.where(
            self.switch_strand_known(),
            self.query_distance() - self.ref_distance(),
            INT64_MAX // 4,
        )

    # ---------------------------------------------------------- conversions
    def take(self, idx) -> "JumpBatch":
        return JumpBatch(
            from_pos=self.from_pos[idx], to_pos=self.to_pos[idx],
            query_from=self.query_from[idx], query_to=self.query_to[idx],
            from_forward=self.from_forward[idx], to_forward=self.to_forward[idx],
            num_supporting_nt=self.num_supporting_nt[idx],
            read_id=self.read_id[idx], was_mirrored=self.was_mirrored[idx],
            id=self.id[idx], params=self.params,
        )

    def to_jumps(self) -> List[SvJump]:
        return [
            SvJump(
                from_pos=int(self.from_pos[i]), to_pos=int(self.to_pos[i]),
                query_from=int(self.query_from[i]),
                query_to=int(self.query_to[i]),
                from_forward=bool(self.from_forward[i]),
                to_forward=bool(self.to_forward[i]),
                num_supporting_nt=int(self.num_supporting_nt[i]),
                read_id=int(self.read_id[i]),
                was_mirrored=bool(self.was_mirrored[i]),
                id=int(self.id[i]), params=self.params,
            )
            for i in range(len(self))
        ]

    @classmethod
    def from_jumps(cls, jumps: Sequence[SvJump],
                   params: JumpParams | None = None) -> "JumpBatch":
        n = len(jumps)
        if params is None:
            params = jumps[0].params if n else JumpParams()
        g = lambda f, dt: np.fromiter((f(j) for j in jumps), dt, n)
        return cls(
            from_pos=g(lambda j: j.from_pos, np.int64),
            to_pos=g(lambda j: j.to_pos, np.int64),
            query_from=g(lambda j: j.query_from, np.int64),
            query_to=g(lambda j: j.query_to, np.int64),
            from_forward=g(lambda j: j.from_forward, bool),
            to_forward=g(lambda j: j.to_forward, bool),
            num_supporting_nt=g(lambda j: j.num_supporting_nt, np.int64),
            read_id=g(lambda j: j.read_id, np.int64),
            was_mirrored=g(lambda j: j.was_mirrored, bool),
            id=g(lambda j: j.id, np.int64),
            params=params,
        )


def _concat_batches(parts: List[JumpBatch], params: JumpParams) -> JumpBatch:
    if not parts:
        z = np.zeros(0, np.int64)
        b = np.zeros(0, bool)
        return JumpBatch(z, z, z, z, b, b, z, z, b, z, params)
    cat = lambda f: np.concatenate([f(p) for p in parts])
    return JumpBatch(
        from_pos=cat(lambda p: p.from_pos), to_pos=cat(lambda p: p.to_pos),
        query_from=cat(lambda p: p.query_from),
        query_to=cat(lambda p: p.query_to),
        from_forward=cat(lambda p: p.from_forward),
        to_forward=cat(lambda p: p.to_forward),
        num_supporting_nt=cat(lambda p: p.num_supporting_nt),
        read_id=cat(lambda p: p.read_id),
        was_mirrored=cat(lambda p: p.was_mirrored),
        id=cat(lambda p: p.id), params=params,
    )


def _canonical_batch(from_pos, to_pos, qf, qt, ffwd, tfwd, nt, rid,
                     params) -> JumpBatch:
    """Vectorized canonical mirroring (svJump.h:131-148)."""
    mirrored = (
        (to_pos < from_pos) | ((to_pos == from_pos) & ~ffwd & tfwd)
    ) & (from_pos != DUMMY_LOCATION)
    nfrom = np.where(mirrored, to_pos, from_pos)
    nto = np.where(mirrored, from_pos, to_pos)
    nffwd = np.where(mirrored, ~tfwd, ffwd)
    ntfwd = np.where(mirrored, ~ffwd, tfwd)
    return JumpBatch(
        from_pos=nfrom.astype(np.int64), to_pos=nto.astype(np.int64),
        query_from=qf.astype(np.int64), query_to=qt.astype(np.int64),
        from_forward=nffwd.astype(bool), to_forward=ntfwd.astype(bool),
        num_supporting_nt=nt.astype(np.int64), read_id=rid.astype(np.int64),
        was_mirrored=mirrored.astype(bool),
        id=np.full(len(nfrom), -1, np.int64), params=params,
    )


def jumps_from_seed_csr(
    q: np.ndarray,  # int64 [S] query starts (pre-sorted within each read)
    l: np.ndarray,  # int64 [S] lengths (> 0)
    r: np.ndarray,  # int64 [S] ref starts (reverse: largest fwd coordinate)
    fw: np.ndarray,  # bool [S]
    nt: np.ndarray,  # int64 [S] soc nt
    read_off: np.ndarray,  # int64 [R+1] CSR offsets into the seed arrays
    qlens: np.ndarray,  # int64 [R]
    read_ids: np.ndarray,  # int64 [R]
    params: JumpParams = JumpParams(),
) -> JumpBatch:
    """Vectorized computeJumps over every read at once
    (svJumpsFromSeeds.h:374-431; oracle: jumps.py compute_jumps).

    Emits, per read: [leading dummy] + pair jumps in (i asc, k asc) order +
    [trailing dummy], ids assigned sequentially — the oracle's order.
    """
    S = len(q)
    R = len(qlens)
    q = q.astype(np.int64)
    l = l.astype(np.int64)
    qend = q + l
    seed_read = np.repeat(np.arange(R, dtype=np.int64), np.diff(read_off))
    rend = read_off[1:][seed_read]  # per-seed read end offset

    def ov_gt(a, b, thresh=0.95):
        """overlap(ss[a], ss[b]) > thresh — same float expression as the
        oracle's _overlap (division, not cross-multiplication) so boundary
        cases round identically."""
        lo = np.maximum(q[a], q[b])
        hi = np.minimum(qend[a], qend[b])
        inter = np.maximum(hi - lo, 0)
        return inter / np.minimum(l[a], l[b]) > thresh

    # ---- j(i): first index > i in the read with overlap <= 0.95
    idx = np.arange(S, dtype=np.int64)
    j = idx + 1
    alive = j < rend
    while True:
        chk = alive & (j < rend)
        sel = np.flatnonzero(chk)
        if len(sel) == 0:
            break
        over = ov_gt(sel, j[sel])
        j[sel[over]] += 1
        alive = np.zeros(S, bool)
        alive[sel[over]] = True
        if not alive.any():
            break
    has_j = j < rend

    # ---- K expansion: k = j, j+1, ... while (k == j or ov(k, j) > 0.95)
    pair_i: List[np.ndarray] = []
    pair_k: List[np.ndarray] = []
    cur_i = np.flatnonzero(has_j)
    cur_k = j[cur_i]
    while len(cur_i):
        pair_i.append(cur_i)
        pair_k.append(cur_k)
        nk = cur_k + 1
        keep = nk < rend[cur_i]
        ci, nk2 = cur_i[keep], nk[keep]
        if len(ci) == 0:
            break
        cont = ov_gt(nk2, j[ci])
        cur_i, cur_k = ci[cont], nk2[cont]

    if pair_i:
        pi = np.concatenate(pair_i)
        pk = np.concatenate(pair_k)
        order = np.lexsort((pk, pi))
        pi, pk = pi[order], pk[order]
        # make_jump (svJump.h:311-341)
        from_pos = np.where(fw[pi], r[pi] + l[pi] - 1, r[pi] - l[pi] + 1)
        to_pos = r[pk].astype(np.int64)
        qf = qend[pi]
        qt = np.maximum(q[pk], qf)
        pairs = _canonical_batch(
            from_pos, to_pos, qf, qt, fw[pi], fw[pk],
            np.minimum(nt[pi], nt[pk]), read_ids[seed_read[pi]], params,
        )
        sz = pairs.size()
        keep = sz >= params.min_size_jump
        if params.max_size_jump != 0:
            keep &= sz < params.max_size_jump
        pairs = pairs.take(np.flatnonzero(keep))
        pair_seed_i = pi[keep]
    else:
        pairs = _concat_batches([], params)
        pair_seed_i = np.zeros(0, np.int64)

    # ---- dummy jumps at read edges (svJump.h:166-200)
    parts: List[JumpBatch] = []
    nonempty = np.flatnonzero(np.diff(read_off) > 0)
    order_keys = []  # (read, rank) for final interleave

    if params.do_dummy_jumps and len(nonempty):
        first_i = read_off[:-1][nonempty]
        last_i = read_off[1:][nonempty] - 1
        mj = params.max_dist_dummy

        def dummy_batch(si, reads_sel, first: bool):
            s_q, s_l, s_r, s_fw, s_nt = q[si], l[si], r[si], fw[si], nt[si]
            qlen_sel = qlens[reads_sel]
            ff = np.full(len(si), first)
            from_pos = np.where(
                ff == s_fw, DUMMY_LOCATION,
                np.where(s_fw, s_r + s_l - 1, s_r),
            )
            to_pos = np.where(
                ff != s_fw, DUMMY_LOCATION,
                np.where(s_fw, s_r, 1 + s_r - s_l),
            )
            if first:
                qf = np.where(s_q > mj, s_q - mj, 0)
                qt = s_q
            else:
                qf = s_q + s_l
                qt = np.minimum(s_q + s_l + mj, qlen_sel)
            return _canonical_batch(
                from_pos.astype(np.int64), to_pos.astype(np.int64),
                qf.astype(np.int64), np.maximum(qf, qt).astype(np.int64),
                s_fw, s_fw, s_nt, read_ids[reads_sel], params,
            )

        lead_sel = np.flatnonzero(q[first_i] >= params.min_dist_dummy)
        lead = dummy_batch(first_i[lead_sel], nonempty[lead_sel], True)
        tail_sel = np.flatnonzero(
            qend[last_i] + params.min_dist_dummy < qlens[nonempty]
        )
        tail = dummy_batch(last_i[tail_sel], nonempty[tail_sel], False)
        parts = [lead, pairs, tail]
        order_keys = [
            (nonempty[lead_sel], np.full(len(lead_sel), -1, np.int64)),
            (seed_read[pair_seed_i], pair_seed_i),
            (nonempty[tail_sel], np.full(len(tail_sel), INT64_MAX, np.int64)),
        ]
    else:
        parts = [pairs]
        order_keys = [(seed_read[pair_seed_i], pair_seed_i)]

    out = _concat_batches(parts, params)
    key_read = np.concatenate([k[0] for k in order_keys])
    key_rank = np.concatenate([k[1] for k in order_keys])
    order = np.lexsort((key_rank, key_read))
    out = out.take(order)
    out.id = np.arange(len(out), dtype=np.int64)
    return out
