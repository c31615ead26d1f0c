"""Harmonization shadow line sweep: kernel B (csrc/linesweep.cu) and its
plain PyTorch version (port of ma_tpu/ops/harmonize_pallas.py together with
the sort around it in `_linesweep`, ma_tpu/ops/harmonize.py:212).

Each row's valid elements are processed in the order (start asc, end desc,
original index asc). A per-row stack of (end, dist, seed) entries either
grows (the element's end passes every end seen so far), replaces the suffix
of entries whose end is >= the element's (when none of them is closer,
dist <= the element's), or kills the element. The output is the survivor
mask at the elements' ORIGINAL positions. `dist` is float32 and both
versions compare the same float32 values.

The plain version is ma_tpu's two steps: a stable sort of each row by
(valid ? start : 2^30, -end) carrying the payloads, then the sweep over the
sorted rows (`linesweep_sorted_plain`). Kernel B does both in one launch.
"""
from __future__ import annotations

import torch

from ma_tpu_torch import kernels
from ma_tpu_torch.ops.sortops import sort_with_payloads

BIG = 2**30
# kernel B takes rows of up to this many elements: the widest SoC window
# the aligner sweeps, seeds_per_soc of a long read's overflow rescue
MAX_M = 8192


def linesweep_sorted_plain(s_end, s_dist, s_valid, s_orig):
    """s_end/s_orig int32 [R, M], s_dist float32 [R, M], s_valid [R, M]
    (bool or int) in processing order -> survivors bool [R, M] at original
    positions. The rows advance in lockstep over the element index."""
    R, M = s_end.shape
    dev = s_end.device
    s_valid = s_valid.bool()
    st_end = torch.full((R, M), BIG, dtype=torch.int32, device=dev)
    st_dist = torch.zeros((R, M), dtype=torch.float32, device=dev)
    st_seed = torch.full((R, M), -1, dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    x = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pos = torch.arange(M, device=dev)[None, :]
    for j in range(M):
        e, d = s_end[:, j], s_dist[:, j]
        si, va = s_orig[:, j], s_valid[:, j]
        ge = (pos < sp[:, None]) & (st_end >= e[:, None])
        suffix_pos = torch.where(ge.any(1), torch.argmax(ge.to(torch.int32), 1), sp)
        grow = e > x
        any_closer = (ge & (st_dist <= d[:, None])).any(1)
        do_push = va & (grow | ~any_closer)
        put = torch.where(grow, sp, suffix_pos)
        oh = (pos == put[:, None]) & do_push[:, None]
        st_end = torch.where(oh, e[:, None], st_end)
        st_dist = torch.where(oh, d[:, None], st_dist)
        st_seed = torch.where(oh, si[:, None], st_seed)
        new_sp = torch.where(do_push, put + 1, sp)
        # entries past the push position die (suffix replacement)
        kill = (pos >= new_sp[:, None]) & (pos < sp[:, None])
        st_end = torch.where(kill, BIG, st_end)
        st_seed = torch.where(kill, -1, st_seed)
        x = torch.where(va, torch.maximum(x, e), x)
        sp = new_sp
    alive = (pos < sp[:, None]) & (st_seed >= 0)
    hits = torch.zeros((R, M), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, st_seed.clamp(min=0).long(), alive.to(torch.int32))
    return hits > 0


def linesweep_plain(starts, ends, dists, valid):
    """Plain PyTorch version of kernel B: starts/ends int32 [R, M], dists
    float32 [R, M], valid bool [R, M] in any order -> survivors bool [R, M]
    at the original positions (the stable sort, then the sweep)."""
    R, M = starts.shape
    key_start = torch.where(valid, starts, torch.full_like(starts, BIG))
    orig = torch.arange(M, dtype=torch.int32, device=starts.device).expand(R, M)
    _, (s_end, s_dist, s_valid, s_orig) = sort_with_payloads(
        [key_start, -ends], [ends, dists, valid.to(torch.int32), orig])
    return linesweep_sorted_plain(s_end, s_dist, s_valid, s_orig)


def linesweep(starts, ends, dists, valid):
    """The sweep on the tensors' device: the plain version for CPU tensors,
    kernel B for CUDA tensors. Same contract as `linesweep_plain`."""
    if starts.device.type == "cpu":
        return linesweep_plain(starts, ends, dists, valid)
    R, M = starts.shape
    if M > MAX_M:
        raise ValueError(f"linesweep: M={M} exceeds {MAX_M}")
    starts = starts.to(torch.int32).contiguous()
    ends = ends.to(torch.int32).contiguous()
    dists = dists.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous().view(torch.uint8)
    kernels.check(starts, "starts", torch.int32, (R, M))
    kernels.check(ends, "ends", torch.int32, (R, M))
    kernels.check(dists, "dists", torch.float32, (R, M))
    kernels.check(valid, "valid", torch.uint8, (R, M))
    surv = torch.empty((R, M), dtype=torch.uint8, device=starts.device)
    if R:
        kernels.LINESWEEP.launch(starts, ends, dists, valid, surv, R, M)
    return surv.view(torch.bool)
