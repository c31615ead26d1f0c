"""Seed harmonization (port of ma_tpu/ops/harmonize.py).

All top-K SoCs are harmonized at once; the sequential skip/break heuristics
of Harmonization::execute are replayed afterwards over the per-SoC scores.
Per SoC: strand split, a deterministic candidate-pair RANSAC guide line,
outlier removal, the two shadow line sweeps (kernel B), and the
delta-distance artifact filter.

Floating point: every value the JAX version holds in float32 is float32
here too, and every decision compares float32 values. Transcendental
functions and sums are evaluated in float64 and rounded once to float32, so
the CPU and the CUDA results agree bit for bit (their float32 libraries and
reduction orders differ; a float64 result rounded to float32 does not).
XLA's own float32 functions and fused multiply-adds differ from that by an
ulp at times; a decision that such an ulp flips would show in the parity
tests (tests/test_torch_harmonize.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ma_tpu_torch.ops.harmonize_cuda import linesweep
from ma_tpu_torch.ops.soc import SoCBatch
from ma_tpu_torch.ops.sortops import sel_minor, sort_with_payloads

POS = 1e30
_HALF_PI_F32 = torch.tensor(math.pi / 2, dtype=torch.float32)


class HarmBatch(NamedTuple):
    """Harmonized seed sets [B, G, M], G = 2*K (forward then reverse set per
    SoC)."""

    q_start: torch.Tensor  # int32 [B, G, M]
    length: torch.Tensor  # int32 [B, G, M]
    ref_start: torch.Tensor  # int32 [B, G, M] text coords [0, 2L)
    on_forward: torch.Tensor  # bool [B, G]
    valid: torch.Tensor  # bool [B, G, M]
    set_valid: torch.Tensor  # bool [B, G]
    soc_of: torch.Tensor  # int32 [B, G]


def _masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median (sorted middle element, mean of the two middles for even
    counts) of float32 vals [..., P] over mask."""
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, POS)), dim=-1).values
    cnt = mask.sum(-1)
    hi_i = torch.clamp(cnt // 2, min=0)
    lo_i = torch.clamp((cnt - 1) // 2, min=0)
    sel = sel_minor(s, torch.stack([lo_i, hi_i], dim=-1))
    med = (sel[..., 0] + sel[..., 1]) * 0.5
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def _delta_distance(q0, r0, angle, rstart):
    """deltaDistance (harmonization.h:82-89). float32 in, float32 out; the
    trigonometry runs in float64."""
    comp = (_HALF_PI_F32.to(angle.device) - angle).double()
    a = angle.double()
    y = r0.double() + q0.double() / torch.tan(comp)
    x = (y - rstart.double()) * torch.sin(a)
    x1 = q0.double() / torch.sin(comp)
    return torch.abs(x - x1).float()


def _fit_guide_line(q, l, r, valid, n_cand: int = 8):
    """Deterministic RANSAC-like line fit -> (angle, rstart, mad), float32.

    Points: per seed (mid, start, end) in the (x=ref, y=query) plane.
    Candidates: all pairs of up to n_cand evenly spread valid seed
    midpoints, gated to 20..70 degrees, scored by inliers within MAD
    distance; least squares over the winner's inliers."""
    M = q.shape[-1]
    dev = q.device
    fq, fl, fr = q.float(), l.float(), r.float()
    xs = torch.cat([fr + fl / 2.0, fr, fr + fl], -1)
    ys = torch.cat([fq + fl / 2.0, fq, fq + fl], -1)
    pmask = torch.cat([valid] * 3, -1)
    mad = _masked_median(torch.abs(ys - _masked_median(ys, pmask)[..., None]), pmask)

    cnt = valid.sum(-1)
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)  # valid first
    j = torch.arange(n_cand, device=dev)
    denom = torch.clamp(torch.clamp(cnt, max=n_cand), 1, n_cand)
    sel = (j * torch.clamp(cnt, min=1)[..., None]) // denom[..., None]
    sel_idx = sel_minor(order, torch.clamp(sel, max=M - 1))
    cx = sel_minor(fr + fl / 2.0, sel_idx)
    cy = sel_minor(fq + fl / 2.0, sel_idx)
    cvalid = j < torch.clamp(cnt, max=n_cand)[..., None]

    pairs = [(a, b) for a in range(n_cand) for b in range(a + 1, n_cand)]
    pa = torch.tensor([p[0] for p in pairs], device=dev)
    pb = torch.tensor([p[1] for p in pairs], device=dev)
    x1, y1 = cx[..., pa], cy[..., pa]
    dx, dy = cx[..., pb] - x1, cy[..., pb] - y1
    # angle gate 20..70 degrees on |dy/dx| in the first quadrant
    flip = (dx <= 0) & (dy <= 0)
    adx = torch.where(flip, -dx, dx)
    ady = torch.where(flip, -dy, dy)
    deg = torch.rad2deg(
        torch.atan2(ady.double(), torch.clamp(adx, min=1e-9).double())
    ).float()
    ang_deg = torch.where((adx > 0) & (ady > 0), deg, torch.full_like(deg, -90.0))
    cand_ok = (
        cvalid[..., pa] & cvalid[..., pb] & (ang_deg >= 20) & (ang_deg <= 70)
        & ((dx != 0) | (dy != 0))
    )
    # point-line distances |cross| / norm  [..., P, 3M]
    dx64, dy64 = dx.double(), dy.double()
    nrm = torch.sqrt(dx64 * dx64 + dy64 * dy64)
    cross = (xs.double()[..., None, :] - x1.double()[..., :, None]) * dy64[..., :, None] - (
        ys.double()[..., None, :] - y1.double()[..., :, None]
    ) * dx64[..., :, None]
    dist = (torch.abs(cross) / torch.clamp(nrm[..., :, None], min=1e-9)).float()
    inl = pmask[..., None, :] & (dist <= mad[..., None, None])
    n_inl = torch.where(cand_ok, inl.sum(-1), torch.full_like(cand_ok, -1, dtype=torch.int64))
    best = torch.argmax(n_inl, dim=-1)  # first max wins
    has_cand = n_inl.amax(-1) > 0
    best_oh = torch.arange(n_inl.shape[-1], device=dev) == best[..., None]
    binl = (best_oh[..., None] & inl).any(-2) & pmask

    # least squares over the inliers (lin_regres.h:54-136)
    w = binl.double()
    x64, y64 = xs.double(), ys.double()
    nw = torch.clamp(w.sum(-1), min=1.0)
    mx = (x64 * w).sum(-1) / nw
    my = (y64 * w).sum(-1) / nw
    sxx = (w * (x64 - mx[..., None]) ** 2).sum(-1)
    sxy = (w * (x64 - mx[..., None]) * (y64 - my[..., None])).sum(-1)
    slope = sxy / torch.clamp(sxx, min=1e-9)
    intercept = my - slope * mx
    steep = torch.abs(slope) > 1e-6
    ok = has_cand & steep
    angle = torch.where(ok, torch.atan(slope), torch.full_like(slope, 0.785398)).float()
    # fallback: 45 degrees through the median seed
    med_i = sel_minor(order, torch.clamp(cnt // 2, min=0)[..., None])
    med_rs = (sel_minor(fr, med_i) - sel_minor(fq, med_i))[..., 0]
    fit_rs = (-intercept / torch.where(steep, slope, torch.ones_like(slope))).float()
    rstart = torch.where(ok, fit_rs, med_rs)
    return angle, rstart, mad


def _window_extract(planes: torch.Tensor, starts: torch.Tensor, M: int) -> torch.Tensor:
    """planes [P, B, S], starts [B, K] -> [P, B, K, M]: the M elements from
    each start, zero past the row end (the JAX barrel shifter's result)."""
    P, B, S = planes.shape
    idx = starts.long()[..., None] + torch.arange(M, device=planes.device)  # [B, K, M]
    inside = idx < S
    g = torch.gather(
        planes[:, :, None, :].expand(P, B, idx.shape[1], S), 3,
        idx.clamp(max=S - 1)[None].expand(P, -1, -1, -1),
    )
    return torch.where(inside[None], g, torch.zeros_like(g))


def _linesweep(starts, ends, dists, valid):
    """One shadow line sweep over [..., M] elements -> survivor mask at the
    original positions. Processing order: invalid last, start asc, end desc
    (kernel B sorts and sweeps each row)."""
    M = starts.shape[-1]
    lead = starts.shape[:-1]
    surv = linesweep(starts.reshape(-1, M), ends.reshape(-1, M), dists.reshape(-1, M),
                     valid.reshape(-1, M))
    return surv.reshape(*lead, M)


def harmonize_sets(q, l, r, valid, n_cand: int = 8):
    """harmonizeOne (harmonization.cpp:251-370) batched over leading dims.
    q/l/r int32 [..., M] (r in text coords) -> new valid mask."""
    M = q.shape[-1]
    cnt = valid.sum(-1)
    angle, rstart, mad = _fit_guide_line(q, l, r, valid, n_cand=n_cand)
    dist = _delta_distance(q.float(), r.float(), angle[..., None], rstart[..., None])
    kept = valid & (dist <= mad[..., None])  # outlier removal
    surv1 = _linesweep(q, r + l, dist, kept)  # left shadows
    surv2 = _linesweep(r, q + l, dist, kept & surv1)  # right shadows
    out = kept & surv1 & surv2

    # fallback: center seed of the outlier-removed set when <= 1 remain
    n_out = out.sum(-1)
    k_cnt = kept.sum(-1)
    order = torch.argsort((~kept).to(torch.int32), dim=-1, stable=True)
    center = sel_minor(order, torch.clamp(k_cnt // 2, min=0)[..., None])[..., 0]
    fb = (torch.arange(M, device=q.device) == center[..., None]) & (k_cnt > 0)[..., None]
    out = torch.where((n_out <= 1)[..., None], fb, out)
    # a single input seed passes through; an empty input stays empty
    return torch.where((cnt <= 1)[..., None], valid, out)


def artifact_filter(q, l, r, valid, max_delta_dist=0.1, min_delta_dist=16):
    """Delta-distance artifact filter (applyFilters) over seeds sorted by
    (ref asc, q asc); returns the new valid mask at original positions."""
    M = q.shape[-1]
    lead = q.shape[:-1]
    key_r = torch.where(valid, r, torch.full_like(r, 2**30))
    orig = torch.arange(M, dtype=torch.int32, device=q.device).expand(*lead, M)
    (sr, sq), (sv, ordr) = sort_with_payloads([key_r, q], [valid, orig])
    delta = sr - sq
    n = sv.sum(-1)
    d_prev = delta[..., 0]
    killed = torch.zeros_like(sv)
    for i in range(M):
        d_ctr = delta[..., i]
        d_post = delta[..., min(i + 1, M - 1)]
        active = (i >= 1) & (i + 1 < n)
        dist_pre = torch.abs(d_prev - d_ctr)
        dist_post = torch.abs(d_post - d_ctr)
        both = dist_pre + dist_post
        diff = torch.abs(dist_pre - dist_post).float() * 2.0 / torch.clamp(
            both.float(), min=1.0
        )
        # C++ divides by zero -> NaN -> comparison false; masked here
        trigger = active & (both != 0) & (diff < max_delta_dist) & (dist_pre > min_delta_dist)
        d_prev = torch.where(active & ~trigger, d_ctr, d_prev)
        killed[..., i] = trigger
    new_sv = sv & ~killed
    hits = torch.zeros(new_sv.shape, dtype=torch.int32, device=q.device)
    hits.scatter_add_(-1, ordr.long(), new_sv.to(torch.int32))
    return hits > 0


def harmonization(
    soc: SoCBatch,
    qlen: torch.Tensor,  # int32 [B]
    text_len: int,  # 2L
    max_socs: int = 30,
    min_socs: int = 1,
    seeds_per_soc: int = 64,
    n_cand: int = 8,
    do_heuristics: bool = True,
    switch_qlen: int = 800,
    score_tolerance: float = 0.1,
    harm_score_min: int = 18,
    harm_score_min_rel: float = 0.002,
    score_diff_tolerance: float = 0.0001,
    max_lookahead: int = 3,
    max_delta_dist: float = 0.1,
    min_delta_dist: int = 16,
) -> HarmBatch:
    """Harmonization::execute (harmonization.cpp:371-560) for a batch."""
    B = soc.n_socs.shape[0]
    K = min(max_socs, soc.start.shape[1])
    M = seeds_per_soc
    sd = soc.seeds
    dev = sd.q_start.device

    # ---- SoC windows to [B, K, M]; strand folds into ref's sign, validity
    # into a zeroed length
    S_seeds = sd.q_start.shape[1]
    idx = soc.start[:, :K, None] + torch.arange(M, device=dev)[None, None, :]
    in_win = (idx < soc.end[:, :K, None]) & (
        torch.arange(K, device=dev)[None, :, None] < soc.n_socs[:, None, None]
    )
    l_eff = torch.where(sd.valid, sd.length, torch.zeros_like(sd.length))
    ref_signed = torch.where(sd.on_forward, sd.ref_start, -sd.ref_start - 1)
    planes = torch.stack([sd.q_start, l_eff, ref_signed])
    win = _window_extract(planes, torch.clamp(soc.start[:, :K], 0, S_seeds - 1), M)
    va = in_win & (win[1] > 0)
    zero = torch.zeros_like(win[0])
    q = torch.where(va, win[0], zero)
    l = torch.where(va, win[1], zero)
    fw = win[2] >= 0
    ref = torch.where(va, torch.where(fw, win[2], -win[2] - 1), zero)
    fw = fw & va
    soc_score = l.sum(-1, dtype=torch.int32)  # uiCurrSoCScore [B, K]

    # ---- strand split; reverse seeds mirrored to text coordinates
    ref_rev = text_len - ref - 1
    q2 = torch.stack([q, q], 2)  # [B, K, 2, M]
    l2 = torch.stack([l, l], 2)
    r2 = torch.stack([ref, ref_rev], 2)
    va2 = torch.stack([va & fw, va & ~fw], 2)

    harm_valid = harmonize_sets(q2, l2, r2, va2, n_cand=n_cand)
    harm_score = torch.where(harm_valid, l2, torch.zeros_like(l2)).sum(
        (-2, -1), dtype=torch.int32
    )
    set_nonempty = harm_valid.any(-1)  # [B, K, 2]
    filt_valid = artifact_filter(q2, l2, r2, harm_valid, max_delta_dist=max_delta_dist,
                                 min_delta_dist=min_delta_dist)

    # ---- replay the sequential heuristics over the K SoCs
    qf = qlen.float()
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    last, best, repeat, total = zi, zi, zi, zi
    broken = zb
    long_q = (qlen > switch_qlen) & (switch_qlen != 0)
    short_q = (qlen < switch_qlen) & (switch_qlen != 0)
    keeps, n_pushes = [], []
    for k in range(K):
        num_tries = k + 1
        cs = soc_score[:, k]
        ch = harm_score[:, k]
        after_min = do_heuristics and num_tries > min_socs
        brk = broken | (num_tries > max_socs) | ~(k < soc.n_socs)
        skip1 = (long_q & (last > cs)) if after_min else zb
        if after_min and score_tolerance > 0:
            brk = brk | (~skip1 & (best.float() * score_tolerance > cs.float()))
        alive = ~brk & ~skip1
        best = torch.where(alive, torch.maximum(best, cs), best)
        skip2 = (ch < harm_score_min) if after_min else zb
        skip3 = (ch.float() < qf * harm_score_min_rel) if do_heuristics else zb
        skip4 = (long_q & (last > ch)) if after_min else zb
        keep = alive & ~skip2 & ~skip3 & ~skip4
        n_push = torch.where(
            keep, set_nonempty[:, k, 0].to(torch.int32) + set_nonempty[:, k, 1].to(torch.int32),
            zi,
        )
        repeat = repeat + n_push
        # short-query lookahead bookkeeping (harmonization.cpp:512-528)
        in_la = short_q if after_min else zb
        tol = qf * score_diff_tolerance
        same = (ch.float() + tol >= last.float()) & (ch.float() - tol <= last.float())
        repeat = torch.where(keep & in_la & ~same, zi, repeat)
        brk_la = keep & in_la & (repeat >= max_lookahead) & (max_lookahead != 0)
        repeat = torch.where(keep & ~in_la, zi, repeat)
        broken = brk | brk_la
        last = torch.where(keep, ch, last)
        total = total + n_push
        keeps.append(keep)
        n_pushes.append(n_push)
    keeps = torch.stack(keeps, 1)  # [B, K]
    n_pushes = torch.stack(n_pushes, 1)

    # trailing pop: drop the last `repeat` pushes while > minTries
    if do_heuristics:
        final_cnt = torch.where(
            total > min_socs, torch.clamp(total - repeat, min=min_socs), total
        )
    else:
        final_cnt = total
    push_before = torch.cumsum(n_pushes, 1, dtype=torch.int32) - n_pushes
    fw_ok = keeps & set_nonempty[:, :K, 0]
    rv_ok = keeps & set_nonempty[:, :K, 1]
    fw_keep = fw_ok & (push_before < final_cnt[:, None])
    rv_keep = rv_ok & (push_before + fw_ok.to(torch.int32) < final_cnt[:, None])
    keep2 = torch.stack([fw_keep, rv_keep], 2)
    return HarmBatch(
        q_start=q2.reshape(B, K * 2, M),
        length=l2.reshape(B, K * 2, M),
        ref_start=r2.reshape(B, K * 2, M),
        on_forward=torch.tensor([True, False], device=dev).repeat(K)[None, :].expand(B, -1),
        valid=(filt_valid & keep2[..., None]).reshape(B, K * 2, M),
        set_valid=keep2.reshape(B, K * 2),
        soc_of=torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(2)[None, :]
        .expand(B, -1),
    )
