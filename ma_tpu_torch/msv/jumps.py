"""SV jumps: adjacency-matrix edge candidates computed from seed sets.

A copy of ma_tpu/msv/jumps.py, changed only in its imports.

Re-design of the reference SvJump + SvJumpsFromSeeds
(reference: libs/msv/inc/msv/container/svJump.h:15-388 — canonical
mirroring, fuzziness arithmetic, sectioned sweep coordinates;
libs/msv/inc/msv/module/svJumpsFromSeeds.h computeJumps:374-431 and
forMatchingSeeds:149-174 — jump enumeration incl. dummy jumps).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

INT64_MAX = 2**63 - 1
DUMMY_LOCATION = 2**32 - 1
FROM_POS_NUM_SECTIONS = 8


@dataclasses.dataclass(frozen=True)
class JumpParams:
    """Fuzziness/config globals (parameter.h fuzziness-s/m/h, Seed Dir
    Fuzziness, dummy-jump and size-edge parameters)."""

    jump_s: float = 200.0
    jump_s_neg: float = 200.0
    jump_m: float = 0.5
    jump_h: float = 25.0
    seed_dir_fuzziness: int = 3
    do_dummy_jumps: bool = True
    min_dist_dummy: int = 50
    max_dist_dummy: int = 60
    min_size_jump: int = 0  # "Min Size Edge"
    max_size_jump: int = 0  # "Max Size Edge" (0 = off)


@dataclasses.dataclass
class SvJump:
    from_pos: int  # inclusive; DUMMY_LOCATION if unknown
    to_pos: int  # inclusive; DUMMY_LOCATION if unknown
    query_from: int
    query_to: int
    from_forward: bool
    to_forward: bool
    num_supporting_nt: int
    read_id: int
    was_mirrored: bool = False
    id: int = -1
    params: JumpParams = JumpParams()

    # ------------------------------------------------------------ predicates
    def from_known(self) -> bool:
        return self.from_pos != DUMMY_LOCATION

    def to_known(self) -> bool:
        return self.to_pos != DUMMY_LOCATION

    def switch_strand_known(self) -> bool:
        return self.from_known() and self.to_known()

    def is_dummy(self) -> bool:
        return not self.switch_strand_known()

    def does_switch_strand(self) -> bool:
        return self.from_forward != self.to_forward

    # -------------------------------------------------------------- geometry
    def query_distance(self) -> int:
        return self.query_to - self.query_from

    def ref_distance(self) -> int:
        return abs(self.to_pos - self.from_pos)

    def size(self) -> int:
        if self.is_dummy():
            return INT64_MAX // 4
        return max(self.query_distance(), self.ref_distance())

    def fuzziness(self) -> int:
        p = self.params
        x = float(max(self.ref_distance(), self.query_distance()))
        s = (
            p.jump_s
            if (
                self.to_pos >= self.from_pos
                or self.query_distance() >= self.from_pos - self.to_pos
            )
            else p.jump_s_neg
        )
        return int(min(p.jump_h, max(0.0, x - s) * p.jump_m))

    def _sdf_activate(self) -> int:
        return self.params.seed_dir_fuzziness * 2

    def seed_dir_fuzziness(self) -> int:
        if self.is_dummy():
            return (
                self.params.seed_dir_fuzziness
                if self.query_distance() > self._sdf_activate()
                else 0
            )
        return (
            self.params.seed_dir_fuzziness
            if self.fuzziness() > self._sdf_activate()
            else 0
        )

    def from_fuzziness_is_rightwards(self) -> bool:
        if not self.from_known():
            return False
        if not self.to_known():
            return True
        return self.from_forward

    def to_fuzziness_is_downwards(self) -> bool:
        if not self.from_known():
            return True
        if not self.to_known():
            return False
        return self.to_forward

    def from_start_same_strand(self) -> int:
        if not self.from_known():
            return max(0, self.to_pos - self.query_distance() + self.seed_dir_fuzziness())
        if not self.to_known():
            return max(0, self.from_pos - self.seed_dir_fuzziness())
        if self.from_fuzziness_is_rightwards():
            return max(0, self.from_pos - self.seed_dir_fuzziness())
        return max(0, self.from_pos - self.fuzziness())

    def from_start(self) -> int:
        """Sectioned sweep coordinate separating the strand combinations
        (svJump.h:286-301)."""
        ret = self.from_start_same_strand()
        if self.is_dummy():
            return ret + INT64_MAX // (FROM_POS_NUM_SECTIONS // 4)
        if not self.from_forward:
            ret += INT64_MAX // (FROM_POS_NUM_SECTIONS // 2)
        if not self.to_forward:
            ret += INT64_MAX // FROM_POS_NUM_SECTIONS
        return ret

    def from_size(self) -> int:
        if self.is_dummy():
            return self.query_distance() + self.seed_dir_fuzziness()
        return self.fuzziness() + self.seed_dir_fuzziness()

    def from_end(self) -> int:
        return self.from_start() + self.from_size()

    def to_start(self) -> int:
        if not self.from_known():
            return (
                max(0, self.to_pos - self.query_distance() + self.seed_dir_fuzziness())
                + 1
            )
        if not self.to_known():
            return max(0, self.from_pos - self.seed_dir_fuzziness()) + 1
        if not self.to_fuzziness_is_downwards():
            return max(0, self.to_pos - self.seed_dir_fuzziness())
        return max(0, self.to_pos - self.fuzziness())

    def to_size(self) -> int:
        if self.is_dummy():
            return 0
        return self.fuzziness() + self.seed_dir_fuzziness()

    def to_end(self) -> int:
        return self.to_start() + self.to_size()

    def sweep_end(self) -> int:
        return (
            self.to_end()
            if self.switch_strand_known()
            else self.to_start() + self.from_size()
        )

    def insert_ratio(self) -> int:
        if not self.switch_strand_known():
            return INT64_MAX // 4
        return self.query_distance() - self.ref_distance()


def make_jump(
    a: Tuple[int, int, int, bool, int],
    b: Tuple[int, int, int, bool, int],
    read_id: int,
    params: JumpParams = JumpParams(),
) -> SvJump:
    """SvJump(rA, rB, readId) (svJump.h:311-341): b follows a on the query.

    Seed tuple: (q_start, length, ref_start, on_forward, soc_nt) with the
    reverse-seed ref_start = largest forward coordinate.
    """
    (qa, la, ra, fa, nta) = a
    (qb, lb, rb, fb, ntb) = b
    from_pos = (ra + la - 1) if fa else (ra - la + 1)
    to_pos = rb
    qf = qa + la
    qt = qb
    # the reference asserts query_from <= query_to; overlapping pairs (the
    # <=95% rule allows them) are clamped here instead
    qt = max(qt, qf)
    return _canonical(
        from_pos, to_pos, qf, qt, fa, fb, min(nta, ntb), read_id, params
    )


def _canonical(
    from_pos, to_pos, qf, qt, from_fwd, to_fwd, supp_nt, read_id, params
) -> SvJump:
    """Canonical mirroring so from <= to (svJump.h:131-148)."""
    mirrored = (
        to_pos < from_pos or (to_pos == from_pos and not from_fwd and to_fwd)
    ) and from_pos != DUMMY_LOCATION
    if mirrored:
        from_pos, to_pos = to_pos, from_pos
        from_fwd, to_fwd = not to_fwd, not from_fwd
    return SvJump(
        from_pos=from_pos,
        to_pos=to_pos,
        query_from=qf,
        query_to=qt,
        from_forward=from_fwd,
        to_forward=to_fwd,
        num_supporting_nt=supp_nt,
        read_id=read_id,
        was_mirrored=mirrored,
        params=params,
    )


def make_dummy_jump(
    seed: Tuple[int, int, int, bool, int],
    qlen: int,
    first_seed: bool,
    read_id: int,
    params: JumpParams = JumpParams(),
) -> SvJump:
    """Dummy jump at a read edge (svJump.h:166-200)."""
    (q, l, r, fw, nt) = seed
    max_jump = params.max_dist_dummy
    if first_seed == fw:
        from_pos = DUMMY_LOCATION
    else:
        from_pos = (r + l - 1) if fw else r
    if first_seed != fw:
        to_pos = DUMMY_LOCATION
    else:
        to_pos = r if fw else 1 + r - l
    qf = (q - max_jump if q > max_jump else 0) if first_seed else q + l
    qt = (q + l + max_jump if q + l + max_jump < qlen else qlen) if not first_seed else q
    return _canonical(from_pos, to_pos, qf, max(qf, qt), fw, fw, nt, read_id, params)


def _overlap(a, b) -> float:
    (qa, la, *_), (qb, lb, *_) = a, b
    lo, hi = max(qa, qb), min(qa + la, qb + lb)
    if hi <= lo:
        return 0.0
    return (hi - lo) / min(la, lb)


def compute_jumps(
    seeds: Sequence[Tuple[int, int, int, bool, int]],
    qlen: int,
    read_id: int,
    params: JumpParams = JumpParams(),
) -> List[SvJump]:
    """computeJumps (svJumpsFromSeeds.h:374-431): sort by query start, pair
    each seed with the first following non-overlapping (>95%) seed group,
    add dummy jumps at the read edges, filter by jump size."""
    ss = sorted((s for s in seeds if s[1] > 0), key=lambda s: s[0])
    out: List[SvJump] = []
    if not ss:
        return out
    if params.do_dummy_jumps and ss[0][0] >= params.min_dist_dummy:
        out.append(make_dummy_jump(ss[0], qlen, True, read_id, params))
    n = len(ss)
    for i in range(n):
        j = i + 1
        while j < n and _overlap(ss[i], ss[j]) > 0.95:
            j += 1
        k = j
        while k < n and (k == j or _overlap(ss[k], ss[j]) > 0.95):
            jmp = make_jump(ss[i], ss[k], read_id, params)
            sz = jmp.size()
            if sz >= params.min_size_jump and (
                params.max_size_jump == 0 or sz < params.max_size_jump
            ):
                out.append(jmp)
            k += 1
    last = ss[-1]
    if params.do_dummy_jumps and last[0] + last[1] + params.min_dist_dummy < qlen:
        out.append(make_dummy_jump(last, qlen, False, read_id, params))
    return out


def filter_jumps_by_region(
    jumps: Sequence[SvJump], lo: int, hi: int
) -> List[SvJump]:
    """Keep jumps whose from- or to-interval overlaps [lo, hi)
    (FilterJumpsByRegion, svJumpsFromSeeds.h:791-816)."""
    out = []
    for j in jumps:
        fs = j.from_start_same_strand()
        if fs < hi and fs + j.from_size() >= lo:
            out.append(j)
        elif j.to_start() < hi and j.to_end() >= lo:
            out.append(j)
    return out


def jumps_filter_contig_border(
    jumps: Sequence[SvJump], pack, max_dist: int = 0
) -> List[SvJump]:
    """Drop jumps whose breakends sit on different contigs or within
    max_dist of a contig border (JumpsFilterContigBorder)."""
    out = []
    L = pack.unpacked_size_forward_strand
    for j in jumps:
        keep = True
        for pos in (j.from_pos, j.to_pos):
            if pos == DUMMY_LOCATION:
                continue
            p = min(pos, L - 1)
            cid = int(pack.seq_id_for_position(p))
            lo = int(pack.starts[cid])
            hi = lo + int(pack.lengths[cid])
            if p < lo + max_dist or p + max_dist >= hi:
                keep = False
        if keep:
            out.append(j)
    return out
