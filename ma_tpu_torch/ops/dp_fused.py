"""Fused banded DP + traceback: kernels C (csrc/dp_fused.cu) and C'
(csrc/dp_fused_v2.cu) and their plain PyTorch version (port of
ma_tpu/ops/dp_fused.py `banded_align_runs`).

Contract of `banded_align_runs`: banded 2-piece affine DP with z-drop over
[P, M] queries and [P, N] targets, traced back on the device into merged
CIGAR runs. Returns runs [P, R] int32 (op | len << 2, stored back to front)
and meta [8, P] int32: n_runs, score, max_i, max_j, zdropped, run_overflow,
lastrow_max, lastrow_arg. Global problems without z-drop keep no max-cell
book (max_i = max_j = -1, lastrow_max = NEG_INF, lastrow_arg = -1).
Extension problems trace back from the max cell, or with tb_last set from
the last row's best cell. A run that does not fit in R sets run_overflow;
later emits of the same op as the last stored run still merge into it.

The plain version is `dp_rows.banded_align_rows` + `traceback_device_rows`
+ `pack_runs`. Where lastrow_max is NEG_INF, lastrow_arg is 0 here and on
the card (the Pallas kernel leaves the first lane of its first tile there).

C and C' share this contract, so they share the plain version. As in
ma_tpu, `banded_align_runs` takes C' when MA_TPU_DP_V2=1 (read at each
call) and C' tiles the row in at most 8 static tiles (`use_v2`); ma_tpu's
further term PB2 >= 32 sizes TPU VMEM and holds for every shape
(`_pick_pb_v2` never goes below 32), so it is left out.
"""
from __future__ import annotations

import os

import torch

from ma_tpu_torch import kernels
from ma_tpu_torch.ops.dp import NEG_INF, OP_D, OP_I, DPParams
from ma_tpu_torch.ops.dp_rows import banded_align_rows, traceback_device_rows

MAX_RUNS = 32


def _emit(runs, cnt, last, over, op, ln, mask):
    """Append (or merge into the previous) run for the rows in `mask`."""
    P, R = runs.shape
    rows = torch.arange(P, device=runs.device)
    mask = mask & (ln > 0)
    merge = mask & (last == op) & (cnt > 0)
    new = mask & ~merge
    ovf = new & (cnt >= R)
    new = new & ~ovf
    prev = (cnt - 1).clamp(min=0).long()
    runs[rows, prev] += torch.where(merge, ln * 4, 0).to(torch.int32)
    slot = cnt.clamp(max=R - 1).long()
    runs[rows, slot] = torch.where(new, ln * 4 + op, runs[rows, slot]).to(torch.int32)
    cnt = cnt + new.to(torch.int32)
    last = torch.where(mask & ~ovf, op, last).to(torch.int32)
    return cnt, last, over | ovf


def pack_runs(ops, n_ops, fi, fj, started, R: int):
    """Merge a back-to-front op stream (then the leading I / D residuals)
    into packed runs, exactly as the fused kernel emits them.
    Returns (runs [P, R] int32, n_runs [P] int32, overflow [P] bool)."""
    P = ops.shape[0]
    dev = ops.device
    runs = torch.zeros((P, R), dtype=torch.int32, device=dev)
    cnt = torch.zeros(P, dtype=torch.int32, device=dev)
    last = torch.full((P,), -1, dtype=torch.int32, device=dev)
    over = torch.zeros(P, dtype=torch.bool, device=dev)
    one = torch.ones(P, dtype=torch.int32, device=dev)
    for k in range(int(n_ops.max()) if P else 0):
        op = ops[:, k].to(torch.int32)
        cnt, last, over = _emit(runs, cnt, last, over, op, one, k < n_ops)
    cnt, last, over = _emit(runs, cnt, last, over, OP_I, fi + 1, started & (fi >= 0))
    cnt, last, over = _emit(runs, cnt, last, over, OP_D, fj + 1, started & (fj >= 0))
    return runs, cnt, over


def banded_align_runs_plain(q, t, qlen, tlen, band, *, M: int, N: int,
                            params: DPParams = DPParams(), zdrop: int = -1,
                            is_global: bool = True, tb_last=None, R: int = MAX_RUNS):
    """Plain PyTorch version of kernel C (same contract as banded_align_runs)."""
    P = q.shape[0]
    dev = q.device
    res = banded_align_rows(q, t, qlen, tlen, band, params, zdrop, is_global)
    m = qlen.to(torch.int32)
    n = tlen.to(torch.int32)
    if is_global:
        si, sj = m - 1, n - 1
    else:
        from_last = (tb_last if tb_last is not None
                     else torch.zeros(P, dtype=torch.int32, device=dev)) != 0
        lr_ok = res.lastrow_max > NEG_INF
        si = torch.where(from_last, torch.where(lr_ok, m - 1, -1), res.max_i)
        sj = torch.where(from_last, res.lastrow_arg, res.max_j)
    ops, n_ops, fi, fj = traceback_device_rows(res.dirs, si, sj)
    runs, n_runs, over = pack_runs(ops, n_ops, fi, fj, si >= 0, R)
    ext_book = not (is_global and zdrop < 0)
    minus = torch.full((P,), -1, dtype=torch.int32, device=dev)
    meta = torch.stack([
        n_runs,
        res.score,
        res.max_i if ext_book else minus,
        res.max_j if ext_book else minus,
        res.zdropped.to(torch.int32) if ext_book else torch.zeros_like(minus),
        over.to(torch.int32),
        res.lastrow_max if ext_book else torch.full_like(minus, NEG_INF),
        torch.where(res.lastrow_max > NEG_INF, res.lastrow_arg, 0) if ext_book else minus,
    ]).to(torch.int32)
    return runs, meta


def _pick_tj_v2(N: int) -> int:
    """C' static tile width (ma_tpu/ops/dp_fused.py `_pick_tj_v2`): at most
    8 tiles of TJ columns, TJ | N."""
    if N <= 256:
        return N
    for cand in (256, 128):
        if N % cand == 0 and N // cand <= 8:
            return cand
    c = ((N // 8 + 127) // 128) * 128
    if c and N % c == 0:
        return c
    return N


def use_v2(N: int) -> bool:
    """Whether banded_align_runs takes C' for width N: MA_TPU_DP_V2=1 and a
    row of at most 8 static tiles (which `_pick_tj_v2` gives every N >= 1,
    as in ma_tpu)."""
    tj = _pick_tj_v2(N)
    return os.environ.get("MA_TPU_DP_V2", "0") == "1" and N % tj == 0 and N // tj <= 8


def _operands(q, t, qlen, tlen, band, tb_last, M: int, N: int, R: int):
    """Checked kernel operands and outputs: q [P, M], t [P, N], meta_in
    [P, 4] (qlen, tlen, band, tb_last) int32; runs [P, R], meta [8, P]."""
    P = q.shape[0]
    dev = q.device
    q = q.to(torch.int32).contiguous()
    t = t.to(torch.int32).contiguous()
    kernels.check(q, "q", torch.int32, (P, M))
    kernels.check(t, "t", torch.int32, (P, N))
    if tb_last is None:
        tb_last = torch.zeros(P, dtype=torch.int32, device=dev)
    meta_in = torch.stack([qlen, tlen, band, tb_last], 1).to(torch.int32).contiguous()
    kernels.check(meta_in, "meta_in", torch.int32, (P, 4))
    runs = torch.empty((P, R), dtype=torch.int32, device=dev)
    meta = torch.empty((8, P), dtype=torch.int32, device=dev)
    return q, t, meta_in, runs, meta


def _scores(params: DPParams):
    return (params.match, params.mismatch, params.gap_open, params.gap_extend,
            params.gap_open2, params.gap_extend2)


def banded_align_runs_v2(q, t, qlen, tlen, band, *, M: int, N: int,
                         params: DPParams = DPParams(), zdrop: int = -1,
                         is_global: bool = True, tb_last=None, R: int = MAX_RUNS):
    """Kernel C' on CUDA tensors (N <= 4096), the plain version on CPU
    tensors; the contract of banded_align_runs."""
    if q.device.type == "cpu":
        return banded_align_runs_plain(q, t, qlen, tlen, band, M=M, N=N, params=params,
                                       zdrop=zdrop, is_global=is_global,
                                       tb_last=tb_last, R=R)
    if N > 4096:
        raise ValueError(f"dp_fused_v2: N={N} exceeds 256 threads x 16 columns (4096)")
    q, t, meta_in, runs, meta = _operands(q, t, qlen, tlen, band, tb_last, M, N, R)
    P = q.shape[0]
    # direction rows streamed out by the kernel for its own traceback, each
    # padded to a 16-byte multiple for the bulk copies
    ldn = -(-N // 16) * 16
    dirs = torch.empty((P, M, ldn), dtype=torch.uint8, device=q.device)
    if P:
        kernels.DP_FUSED_V2.launch(q, t, meta_in, runs, meta, dirs, P, M, N, ldn, R,
                                   *_scores(params), zdrop, int(is_global))
    return runs, meta


def banded_align_runs(q, t, qlen, tlen, band, *, M: int, N: int,
                      params: DPParams = DPParams(), zdrop: int = -1,
                      is_global: bool = True, tb_last=None, R: int = MAX_RUNS):
    """Fused DP + traceback on the tensors' device: the plain version for CPU
    tensors; for CUDA tensors kernel C', where `use_v2(N)`, else kernel C.
    q [P, M], t [P, N] int32 codes; qlen/tlen/band/tb_last [P]. Returns
    (runs [P, R], meta [8, P]). Kernel C's launches are tallied per (M, N,
    global or extension) with their problem counts (`kernels.DP_FUSED.tally`)."""
    if q.device.type == "cpu" or use_v2(N):
        return banded_align_runs_v2(q, t, qlen, tlen, band, M=M, N=N, params=params,
                                    zdrop=zdrop, is_global=is_global, tb_last=tb_last, R=R)
    # bytes per problem of the direction rows kernel C streams out for its own
    # traceback where the plane is too large for shared memory, else 0
    scratch = kernels.query("ma_dp_fused_scratch_bytes", M, N)
    if scratch < 0:
        raise ValueError(f"dp_fused: N={N} exceeds 256 threads x 4 columns (1024)")
    q, t, meta_in, runs, meta = _operands(q, t, qlen, tlen, band, tb_last, M, N, R)
    P = q.shape[0]
    dirs = torch.empty(P * scratch, dtype=torch.uint8, device=q.device)
    if P:
        kernels.DP_FUSED.launch(q, t, meta_in, runs, meta, dirs, P, M, N, R,
                                *_scores(params), zdrop, int(is_global),
                                shape=(M, N, "global" if is_global else "extension"), items=P)
    return runs, meta
