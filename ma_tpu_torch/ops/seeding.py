"""Batched FMD-index seeding on a device (port of ma_tpu/ops/seeding.py):
maximally-spanning seeding and SMEM seeding.

Both are per-read state machines that ma_tpu runs as one `lax.while_loop`
over the batch: each iteration advances every read by one step (one batched
`extend_backward`). Here each iteration is one eager call of the seeder's
batched `step`, and the loop is `_run`.

Why `_run` checks for live reads only every CHECK_EVERY steps and still
gives ma_tpu's output exactly: every read advances on its own (the step is
lane-wise), and a read in P_DONE / S_DONE changes none of the outputs of a
step (segment slots, counts, overflow flags) - in max_spanning_seeding such
a lane may move its cursor and interval, which nothing reads once it is
done. So the steps past the point where ma_tpu's loop would stop leave the
output as it was; the loop never steps past `iter_cap`, where ma_tpu's
stops too, and reads still live there are flagged as overflowed by both.

Static shapes: `max_segs` segments and a `max_stack` interval stack per
read (`max_pending` pending intervals for SMEMs); overflow is flagged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ma_tpu_torch.ops.occ import (
    SAI,
    FMDDev,
    extend_backward,
    init_interval,
    sai_where,
)

CHECK_EVERY = 16  # state-machine steps between two host checks for live reads

# state-machine phases (maximally spanning)
P_NEW_CENTER = 0
P_RIGHT1 = 1
P_LEFT1 = 2
P_INIT2 = 3
P_LEFT2 = 4
P_RIGHT2 = 5
P_SPLIT = 6
P_DONE = 7

# phases of the SMEM state machine
S_NEW = 0
S_FWD = 1
S_BWD = 2
S_SPLIT = 3
S_DONE = 4


class SegmentBatch(NamedTuple):
    """Fixed-shape segments: query interval + SA interval per segment. The
    matched query span is [q_start, q_start + q_size] INCLUSIVE (seed
    length q_size + 1)."""

    q_start: torch.Tensor  # int32 [B, S]
    q_size: torch.Tensor  # int32 [B, S]
    sai_start: torch.Tensor  # int32 [B, S]
    sai_rc: torch.Tensor  # int32 [B, S]
    sai_size: torch.Tensor  # int32 [B, S] (0 = unused slot)
    n_segs: torch.Tensor  # int32 [B]
    overflow: torch.Tensor  # bool [B]: segment / stack capacity exceeded


def _put(arr: torch.Tensor, slot: torch.Tensor, do: torch.Tensor, val) -> torch.Tensor:
    """arr[b, slot[b]] = val[b] where do[b] (a new tensor)."""
    idx = slot.long()[:, None]
    old = torch.gather(arr, 1, idx)[:, 0]
    return arr.scatter(1, idx, torch.where(do, val, old)[:, None])


def _take(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, 1, slot.long()[:, None])[:, 0]


def _emplace(segs: SegmentBatch, do: torch.Tensor, qs, qsize, ik: SAI) -> SegmentBatch:
    """Append a segment for the reads where `do`; flag overflow when full."""
    S = segs.q_start.shape[1]
    slot = torch.clamp(segs.n_segs, max=S - 1)
    can = do & (segs.n_segs < S)
    return SegmentBatch(
        q_start=_put(segs.q_start, slot, can, qs),
        q_size=_put(segs.q_size, slot, can, qsize),
        sai_start=_put(segs.sai_start, slot, can, ik.start),
        sai_rc=_put(segs.sai_rc, slot, can, ik.start_rc),
        sai_size=_put(segs.sai_size, slot, can, ik.size),
        n_segs=segs.n_segs + can.to(torch.int32),
        overflow=segs.overflow | (do & ~can),
    )


def _empty_segments(B: int, max_segs: int, dev) -> SegmentBatch:
    zs = lambda: torch.zeros((B, max_segs), dtype=torch.int32, device=dev)  # noqa: E731
    return SegmentBatch(zs(), zs(), zs(), zs(), zs(),
                        torch.zeros(B, dtype=torch.int32, device=dev),
                        torch.zeros(B, dtype=torch.bool, device=dev))


def _comp(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c < 4, 3 - c, c)  # N stays invalid


def _gather_q(seqs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _take(seqs, torch.clamp(idx, 0, seqs.shape[1] - 1))


def _run(step, st, done_phase: int, iter_cap: int):
    """Step the state machine until no read is live or iter_cap steps ran."""
    it = 0
    while it < iter_cap and bool((st.phase != done_phase).any()):
        for _ in range(min(CHECK_EVERY, iter_cap - it)):
            st = step(st)
        it += min(CHECK_EVERY, iter_cap - it)
    return st


# ------------------------------------------------------------ maximally spanning
class _State(NamedTuple):
    phase: torch.Tensor  # int32 [B]
    s: torch.Tensor  # current area start
    e: torch.Tensor  # current area end (exclusive)
    center: torch.Tensor
    i: torch.Tensor  # extension cursor
    ik: SAI  # current interval
    st1: torch.Tensor
    en1: torch.Tensor
    st2: torch.Tensor
    en2: torch.Tensor
    cov_s: torch.Tensor  # covered interval
    cov_e: torch.Tensor
    stack_s: torch.Tensor  # int32 [B, K]
    stack_e: torch.Tensor
    sp: torch.Tensor
    segs: SegmentBatch


def _split(st, cov_s, cov_e, max_stack: int, split_phase: int, new_phase: int,
           done_phase: int):
    """The split phase shared by both seeders (procesInterval), for the reads
    in `split_phase`: push the uncovered left part [s, cov_s), continue with
    the right part from cov_e (the covered area's inclusive end) or pop.
    Returns (at_split, next phase, stack overflow, s, e, stack_s, stack_e,
    sp)."""
    at_split = st.phase == split_phase
    push = at_split & (cov_s != 0) & (st.s + 1 < cov_s)
    can_push = push & (st.sp < max_stack)
    slot = torch.clamp(st.sp, max=max_stack - 1)
    stack_s = _put(st.stack_s, slot, can_push, st.s)
    stack_e = _put(st.stack_e, slot, can_push, cov_s)
    sp = st.sp + can_push.to(torch.int32)
    cont_right = at_split & (st.e > cov_e + 1)
    s_out = torch.where(cont_right, cov_e, st.s)
    do_pop = at_split & ~cont_right & (sp > 0)
    pslot = torch.clamp(sp - 1, min=0)
    s_out = torch.where(do_pop, _take(stack_s, pslot), s_out)
    e_out = torch.where(do_pop, _take(stack_e, pslot), st.e)
    sp = sp - do_pop.to(torch.int32)
    nxt = torch.where(cont_right | do_pop, new_phase, done_phase)
    return at_split, nxt, push & ~can_push, s_out, e_out, stack_s, stack_e, sp


def max_spanning_seeding(fmd: FMDDev, seqs: torch.Tensor, lens: torch.Tensor,
                         max_segs: int = 64, max_stack: int = 16, min_ambiguity: int = 0,
                         max_ambiguity: int = 100, iter_cap: int | None = None,
                         ext_ops=None) -> SegmentBatch:
    """Maximally-spanning seeding of a batch: seqs [B, L] codes (pad 4),
    lens [B]. Empty reads give no segments. `ext_ops` replaces
    (init_interval, extend_backward): the row-sharded index's collective
    lookups (parallel/sharded_fmd.py) run the state machine unchanged."""
    init_iv, extend = ext_ops or (init_interval, extend_backward)
    seqs = seqs.to(torch.int32)
    B, L = seqs.shape
    dev = seqs.device
    lens = lens.to(torch.int32)
    if iter_cap is None:
        iter_cap = 8 * L + 64
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    zk = torch.zeros((B, max_stack), dtype=torch.int32, device=dev)
    st0 = _State(
        phase=torch.where(lens > 0, P_NEW_CENTER, P_DONE).to(torch.int32),
        s=z, e=lens, center=z, i=z, ik=SAI(z, z, z), st1=z, en1=z, st2=z, en2=z,
        cov_s=z, cov_e=z, stack_s=zk, stack_e=zk, sp=z,
        segs=_empty_segments(B, max_segs, dev),
    )

    def step(st: _State) -> _State:
        phase = st.phase
        # ---- the one batched extension of this step: right loops extend by
        # complement(q[i]), left loops by q[i]
        in_right = (phase == P_RIGHT1) | (phase == P_RIGHT2)
        in_left = (phase == P_LEFT1) | (phase == P_LEFT2)
        qi = _gather_q(seqs, st.i)
        ok = extend(fmd, st.ik, torch.where(in_right, _comp(qi), qi))
        brk = (ok.size <= 0) | ((ok.size <= min_ambiguity) & (st.ik.size <= max_ambiguity))
        in_bounds = torch.where(in_right, st.i < lens, st.i >= 0)
        step_ok = in_bounds & ~brk
        exiting = (in_right | in_left) & ~step_ok
        ik_out = sai_where(step_ok, ok, st.ik)
        i_out = torch.where(step_ok, st.i + torch.where(in_right, 1, -1).to(torch.int32), st.i)
        en1 = torch.where(step_ok & (phase == P_RIGHT1), st.i, st.en1)
        st1 = torch.where(step_ok & (phase == P_LEFT1), st.i, st.st1)
        st2 = torch.where(step_ok & (phase == P_LEFT2), st.i, st.st2)
        en2 = torch.where(step_ok & (phase == P_RIGHT2), st.i, st.en2)
        segs = st.segs
        cov_s, cov_e = st.cov_s, st.cov_e

        # ---- P_NEW_CENTER: pick the center, init the first interval
        at_new = phase == P_NEW_CENTER
        ctr = st.s + (st.e - st.s) // 2
        qc = _gather_q(seqs, ctr)
        ik_init = init_iv(fmd, _comp(qc))
        init_fail = (qc >= 4) | (ik_init.size == 0)
        # N / absent char: covered = [center, center + 1)
        next_phase = torch.where(at_new, torch.where(init_fail, P_SPLIT, P_RIGHT1), phase)
        center_out = torch.where(at_new, ctr, st.center)
        cov_s = torch.where(at_new & init_fail, ctr, cov_s)
        cov_e = torch.where(at_new & init_fail, ctr + 1, cov_e)
        ik_out = sai_where(at_new, ik_init, ik_out)
        i_out = torch.where(at_new, ctr + 1, i_out)
        en1 = torch.where(at_new, ctr, en1)

        # ---- P_RIGHT1 exit: swap to revcomp, go left from center - 1
        ex_r1 = (phase == P_RIGHT1) & exiting
        next_phase = torch.where(ex_r1, P_LEFT1, next_phase)
        ik_out = sai_where(ex_r1, ik_out.rev_comp(), ik_out)
        i_out = torch.where(ex_r1, st.center - 1, i_out)
        st1 = torch.where(ex_r1, st.center, st1)

        # ---- P_LEFT1 exit: emplace segment 1, init the second block
        ex_l1 = (phase == P_LEFT1) & exiting
        segs = _emplace(segs, ex_l1, st1, en1 - st1, ik_out)
        ik2 = init_iv(fmd, _gather_q(seqs, st.center))
        next_phase = torch.where(ex_l1, P_LEFT2, next_phase)
        ik_out = sai_where(ex_l1, ik2, ik_out)
        i_out = torch.where(ex_l1, st.center - 1, i_out)
        st2 = torch.where(ex_l1, st.center, st2)

        # ---- P_LEFT2 exit: swap to revcomp, go right from center + 1
        ex_l2 = (phase == P_LEFT2) & exiting
        next_phase = torch.where(ex_l2, P_RIGHT2, next_phase)
        ik_out = sai_where(ex_l2, ik_out.rev_comp(), ik_out)
        i_out = torch.where(ex_l2, st.center + 1, i_out)
        en2 = torch.where(ex_l2, st.center, en2)

        # ---- P_RIGHT2 exit: maybe emplace segment 2 (its revcomp), covered area
        ex_r2 = (phase == P_RIGHT2) & exiting
        same = (st1 == st2) & (en1 == en2)
        segs = _emplace(segs, ex_r2 & ~same, st2, en2 - st2, ik_out.rev_comp())
        cov_s = torch.where(ex_r2, torch.minimum(st1, st2), cov_s)
        cov_e = torch.where(ex_r2, torch.maximum(en1, en2), cov_e)
        next_phase = torch.where(ex_r2, P_SPLIT, next_phase)

        # ---- P_SPLIT
        at_split, nxt, over, s_out, e_out, stack_s, stack_e, sp = _split(
            st, cov_s, cov_e, max_stack, P_SPLIT, P_NEW_CENTER, P_DONE)
        next_phase = torch.where(at_split, nxt, next_phase)
        segs = segs._replace(overflow=segs.overflow | over)
        return _State(
            phase=next_phase.to(torch.int32), s=s_out, e=e_out, center=center_out,
            i=i_out, ik=ik_out, st1=st1, en1=en1, st2=st2, en2=en2, cov_s=cov_s,
            cov_e=cov_e, stack_s=stack_s, stack_e=stack_e, sp=sp, segs=segs,
        )

    final = _run(step, st0, P_DONE, iter_cap)
    # reads still live at the iteration cap are overflowed
    return final.segs._replace(overflow=final.segs.overflow | (final.phase != P_DONE))


# ------------------------------------------------------------------------- SMEM
class _SmemState(NamedTuple):
    phase: torch.Tensor
    s: torch.Tensor
    e: torch.Tensor
    center: torch.Tensor
    i: torch.Tensor
    ik: SAI  # forward-phase interval
    p_qs: torch.Tensor  # pending intervals of the backward phase [B, K]
    p_sz: torch.Tensor
    p_sai: SAI
    p_n: torch.Tensor  # [B]
    cov_s: torch.Tensor
    cov_e: torch.Tensor
    stack_s: torch.Tensor
    stack_e: torch.Tensor
    sp: torch.Tensor
    segs: SegmentBatch


def smem_seeding(fmd: FMDDev, seqs: torch.Tensor, lens: torch.Tensor, max_segs: int = 64,
                 max_stack: int = 16, max_pending: int = 16, min_ambiguity: int = 0,
                 max_ambiguity: int = 100, iter_cap: int | None = None,
                 ext_ops=None) -> SegmentBatch:
    """Li's SMEM extension scheme, batched: per center a forward extension
    that records an interval at every hit loss, then one joint backward
    extension of all recorded intervals ([B, K] per step), emitting the
    non-enclosed maximal matches. Center selection and splitting as in
    max_spanning_seeding; `ext_ops` as there."""
    init_iv, extend = ext_ops or (init_interval, extend_backward)
    seqs = seqs.to(torch.int32)
    B, L = seqs.shape
    K = max_pending
    dev = seqs.device
    lens = lens.to(torch.int32)
    if iter_cap is None:
        iter_cap = 8 * L + 64
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    zk = torch.zeros((B, K), dtype=torch.int32, device=dev)
    zs = torch.zeros((B, max_stack), dtype=torch.int32, device=dev)
    st0 = _SmemState(
        phase=torch.where(lens > 0, S_NEW, S_DONE).to(torch.int32),
        s=z, e=lens, center=z, i=z, ik=SAI(z, z, z), p_qs=zk, p_sz=zk,
        p_sai=SAI(zk, zk, zk), p_n=z, cov_s=z, cov_e=z, stack_s=zs, stack_e=zs, sp=z,
        segs=_empty_segments(B, max_segs, dev),
    )
    karr = torch.arange(K, device=dev)

    def push_pending(pend, do, qs, sz, sai: SAI):
        slot = torch.clamp(pend["n"], max=K - 1)
        can = do & (pend["n"] < K)
        return dict(
            qs=_put(pend["qs"], slot, can, qs), sz=_put(pend["sz"], slot, can, sz),
            sai=SAI(*(_put(a, slot, can, v) for a, v in zip(pend["sai"], sai))),
            n=pend["n"] + can.to(torch.int32), over=pend["over"] | (do & ~can),
        )

    def step(st: _SmemState) -> _SmemState:
        phase = st.phase
        segs = st.segs
        cov_s, cov_e = st.cov_s, st.cov_e
        pend = dict(qs=st.p_qs, sz=st.p_sz, sai=st.p_sai, n=st.p_n, over=segs.overflow)

        # ---- S_NEW: pick the center, init
        at_new = phase == S_NEW
        ctr = st.s + (st.e - st.s) // 2
        qc = _gather_q(seqs, ctr)
        ik_init = init_iv(fmd, _comp(qc))
        init_fail = (qc >= 4) | (ik_init.size == 0)
        next_phase = torch.where(at_new, torch.where(init_fail, S_SPLIT, S_FWD), phase)
        center_out = torch.where(at_new, ctr, st.center)
        cov_s = torch.where(at_new, ctr, cov_s)
        cov_e = torch.where(at_new, ctr, cov_e)
        ik_out = sai_where(at_new, ik_init, st.ik)
        i_out = torch.where(at_new, ctr + 1, st.i)
        pend["n"] = torch.where(at_new, 0, pend["n"]).to(torch.int32)

        # ---- S_FWD: one forward extension (complement chars)
        at_fwd = phase == S_FWD
        qi = _gather_q(seqs, st.i)
        in_bounds = st.i < lens
        ok = extend(fmd, st.ik, _comp(qi))
        lost = at_fwd & in_bounds & (ok.size != st.ik.size)
        # the interval before the loss (its revcomp; query span [center, i - 1])
        pend = push_pending(pend, lost, st.center, st.i - st.center - 1, st.ik.rev_comp())
        at_qend = at_fwd & in_bounds & (st.i == lens - 1) & (ok.size != 0)
        pend = push_pending(pend, at_qend, st.center, st.i - st.center, ok.rev_comp())
        brk = (ok.size <= 0) | ((ok.size <= min_ambiguity) & (st.ik.size <= max_ambiguity))
        step_ok = at_fwd & in_bounds & ~brk
        ik_out = sai_where(step_ok, ok, ik_out)
        cov_e = torch.where(step_ok, st.i, cov_e)
        i_out = torch.where(step_ok, st.i + 1, i_out)
        fwd_exit = at_fwd & ~step_ok
        # reverse the pending list (longest first for the backward phase)
        n_p = pend["n"][:, None]
        rev_idx = torch.clamp(n_p - 1 - karr[None, :], 0, K - 1).long()
        in_list = karr[None, :] < n_p
        do_rev = fwd_exit[:, None] & in_list
        rv = lambda a: torch.where(do_rev, torch.gather(a, 1, rev_idx), a)  # noqa: E731
        pend["qs"], pend["sz"] = rv(pend["qs"]), rv(pend["sz"])
        pend["sai"] = SAI(*(rv(a) for a in pend["sai"]))
        can_bwd = (st.center > 0) & (pend["n"] > 0)
        next_phase = torch.where(fwd_exit, torch.where(can_bwd, S_BWD, S_SPLIT), next_phase)
        # no backward phase: emplace the longest pending interval directly
        no_bwd_emplace = fwd_exit & ~can_bwd & (pend["n"] > 0)
        segs = _emplace(segs, no_bwd_emplace, pend["qs"][:, 0], pend["sz"][:, 0],
                        SAI(*(a[:, 0] for a in pend["sai"])))
        i_out = torch.where(fwd_exit & can_bwd, st.center - 1, i_out)

        # ---- S_BWD: extend all pending intervals by q[i]
        at_bwd = phase == S_BWD
        live = karr[None, :] < st.p_n[:, None]
        qi_b = _gather_q(seqs, st.i)[:, None].expand(B, K)
        okk = extend(fmd, st.p_sai, qi_b)
        # the first live entry whose extension dies is emplaced in its
        # pre-extension state (later ones are enclosed)
        dead = live & (okk.size <= min_ambiguity)
        first = torch.where(dead, karr[None, :], K).amin(1)
        has_dead = first < K
        first_dead = torch.where(has_dead, first, 0)
        gk = lambda a: _take(a, first_dead)  # noqa: E731
        segs = _emplace(segs, at_bwd & has_dead, gk(st.p_qs), gk(st.p_sz),
                        SAI(*(gk(a) for a in st.p_sai)))
        # entries that extend are kept in their extended state; the emplaced
        # (first dead) entry never is
        emplaced = dead & (karr[None, :] == first_dead[:, None])
        keep = live & ~emplaced & (
            (okk.size > min_ambiguity) | ((okk.size > 0) & (st.p_sz >= max_ambiguity)))
        pos = torch.cumsum(keep.to(torch.int32), 1, dtype=torch.int32) - 1
        n_keep = keep.sum(1, dtype=torch.int32)
        idx = torch.where(keep, pos, K - 1).long()

        # order-preserving compaction: kept entries scatter-add to their
        # (unique) cumsum slot, dropped ones add 0 at slot K - 1
        def compact(vals):
            out = torch.zeros((B, K), dtype=vals.dtype, device=dev)
            return out.scatter_add_(1, idx, torch.where(keep, vals, torch.zeros_like(vals)))

        upd = at_bwd[:, None]
        p_qs = torch.where(upd, compact(st.i[:, None].expand(B, K).contiguous()), pend["qs"])
        p_sz = torch.where(upd, compact(st.p_sz + 1), pend["sz"])
        p_sai = SAI(*(torch.where(upd, compact(n), o) for n, o in zip(okk, pend["sai"])))
        p_n = torch.where(at_bwd, n_keep, pend["n"])
        cov_s = torch.where(at_bwd & (n_keep > 0), st.i, cov_s)
        bwd_done = at_bwd & ((n_keep == 0) | (st.i == 0))
        # reached the query start with live intervals: emplace the longest
        segs = _emplace(segs, bwd_done & (n_keep > 0), p_qs[:, 0], p_sz[:, 0],
                        SAI(*(a[:, 0] for a in p_sai)))
        i_out = torch.where(at_bwd & ~bwd_done, st.i - 1, i_out)
        next_phase = torch.where(bwd_done, S_SPLIT, next_phase)

        # ---- S_SPLIT (cov_e is inclusive here)
        at_split, nxt, over, s_out, e_out, stack_s, stack_e, sp = _split(
            st, cov_s, cov_e, max_stack, S_SPLIT, S_NEW, S_DONE)
        next_phase = torch.where(at_split, nxt, next_phase)
        segs = segs._replace(overflow=segs.overflow | over | pend["over"])
        return _SmemState(
            phase=next_phase.to(torch.int32), s=s_out, e=e_out, center=center_out,
            i=i_out, ik=ik_out, p_qs=p_qs, p_sz=p_sz, p_sai=p_sai, p_n=p_n.to(torch.int32),
            cov_s=cov_s, cov_e=cov_e, stack_s=stack_s, stack_e=stack_e, sp=sp, segs=segs,
        )

    final = _run(step, st0, S_DONE, iter_cap)
    return final.segs._replace(overflow=final.segs.overflow | (final.phase != S_DONE))
