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

C and C' share this contract, so they share the plain version. On the
card `banded_align_runs` picks the kernel by width alone (`fused_kernel`):
C where it takes N (up to 1,024 columns, as its scratch-size query says),
C' for every wider N, in both modes (past 1,024 columns C' walks each row
in chunks of 1,024 from its band's left edge). `banded_align_runs_v2`
launches C' at any width.
"""
from __future__ import annotations

import torch

from ma_tpu_torch import kernels
from ma_tpu_torch.ops.dp import NEG_INF, OP_D, OP_I, DPParams
from ma_tpu_torch.ops.dp_rows import banded_align_rows, traceback_device_rows

MAX_RUNS = 32


def pack_runs(ops, n_ops, fi, fj, started, R: int):
    """Merge a back-to-front op stream (then the leading I / D residuals)
    into packed runs, exactly as the fused kernel emits them: adjacent equal
    ops merge into one run; a run that does not fit in R sets the overflow
    flag and is dropped, but later ops equal to the last stored run's op
    still merge into it. Returns (runs [P, R] int32, n_runs [P] int32,
    overflow [P] bool)."""
    P, S = ops.shape
    dev = ops.device
    col = torch.arange(S + 2, device=dev)[None, :]
    started = started.bool()
    # the stream: the ops (length 1 each), then fi + 1 inserts and fj + 1 deletions
    op = torch.cat([ops.long(), torch.full((P, 1), OP_I, device=dev),
                    torch.full((P, 1), OP_D, device=dev)], 1)
    ln = torch.cat([torch.ones((P, S), dtype=torch.long, device=dev),
                    (fi.long() + 1)[:, None], (fj.long() + 1)[:, None]], 1)
    valid = torch.cat([col[:, :S] < n_ops.long()[:, None], (started & (fi >= 0))[:, None],
                       (started & (fj >= 0))[:, None]], 1)
    # each item's op carried over the invalid items after it; a run starts
    # at a valid item whose op differs from the last valid item's
    last = torch.where(valid, col, -1).cummax(1).values
    seen = last >= 0
    fop = torch.where(seen, op.gather(1, last.clamp(min=0)), -1)
    prev = torch.cat([torch.full((P, 1), -1, device=dev), fop[:, :-1]], 1)
    start = valid & (fop != prev)
    rid = start.long().cumsum(1) - 1
    n_rle = start.sum(1)
    run_op = torch.zeros((P, R + 1), dtype=torch.long, device=dev)
    run_op.scatter_(1, torch.where(start & (rid < R), rid, R), torch.where(start, op, 0))
    # items of runs past R merge into run R - 1 where their op is its op
    tail = valid & (rid >= R) & (op == run_op[:, R - 1 : R])
    dest = torch.where(valid & (rid < R), rid, torch.where(tail, R - 1, R))
    run_len = torch.zeros((P, R + 1), dtype=torch.long, device=dev)
    run_len.scatter_add_(1, dest, torch.where(valid, ln, 0))
    n_runs = n_rle.clamp(max=R)
    kept = torch.arange(R, device=dev)[None, :] < n_runs[:, None]
    runs = torch.where(kept, run_len[:, :R] * 4 + run_op[:, :R], 0).to(torch.int32)
    return runs, n_runs.to(torch.int32), n_rle > R


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


def fused_kernel(N: int, c_fits: bool) -> str:
    """The kernel banded_align_runs launches for CUDA tensors of width N:
    "C" where kernel C takes the width (`c_fits`, from its scratch-size
    query for N), "C'" for every other N, global or extension."""
    return "C" if c_fits else "C'"


def banded_align_runs_v2(q, t, qlen, tlen, band, *, M: int, N: int,
                         params: DPParams = DPParams(), zdrop: int = -1,
                         is_global: bool = True, tb_last=None, R: int = MAX_RUNS):
    """Kernel C' on CUDA tensors (any N), the plain version on CPU tensors;
    the contract of banded_align_runs. The problems go in launches whose
    direction rows (and, past 1,024 columns, the row state C' carries
    between chunks) stay within 1 GiB. Launches are tallied per (M, N,
    global or extension) with their problem counts."""
    if q.device.type == "cpu":
        return banded_align_runs_plain(q, t, qlen, tlen, band, M=M, N=N, params=params,
                                       zdrop=zdrop, is_global=is_global,
                                       tb_last=tb_last, R=R)
    q, t, meta_in, runs, meta = _operands(q, t, qlen, tlen, band, tb_last, M, N, R)
    P = q.shape[0]
    # direction rows streamed out by the kernel for its own traceback, each
    # padded to a 16-byte multiple for the bulk copies (the kernel writes a
    # row's in-band span only, and its traceback makes the bytes it reaches
    # outside it); int32 row state per problem where the row is walked in
    # chunks
    ldn = -(-N // 16) * 16
    carry_ints = kernels.query("ma_dp_fused_v2_carry_ints", N, ldn)
    step = max(1, 2**30 // (M * ldn + 4 * carry_ints))
    mode = "global" if is_global else "extension"
    for s in range(0, P, step):
        k = min(step, P - s)
        dirs = torch.empty((k, M, ldn), dtype=torch.uint8, device=q.device)
        carry = torch.empty((k, carry_ints), dtype=torch.int32, device=q.device)
        part_meta = meta if k == P else torch.empty((8, k), dtype=torch.int32, device=q.device)
        kernels.DP_FUSED_V2.launch(q[s : s + k], t[s : s + k], meta_in[s : s + k],
                                   runs[s : s + k], part_meta, dirs, carry if carry_ints else 0,
                                   k, M, N, ldn, R, *_scores(params), zdrop, int(is_global),
                                   shape=(M, N, mode), items=k)
        if k != P:
            meta[:, s : s + k] = part_meta
    return runs, meta


def banded_align_runs(q, t, qlen, tlen, band, *, M: int, N: int,
                      params: DPParams = DPParams(), zdrop: int = -1,
                      is_global: bool = True, tb_last=None, R: int = MAX_RUNS):
    """Fused DP + traceback on the tensors' device: the plain version for CPU
    tensors; for CUDA tensors the kernel `fused_kernel` names (C or C').
    q [P, M], t [P, N] int32 codes; qlen/tlen/band/tb_last [P]. Returns (runs [P, R], meta [8, P]). C's and C''s launches
    are tallied per (M, N, global or extension) with their problem counts
    (`kernels.DP_FUSED.tally`, `kernels.DP_FUSED_V2.tally`)."""
    if q.device.type == "cpu":
        return banded_align_runs_plain(q, t, qlen, tlen, band, M=M, N=N, params=params,
                                       zdrop=zdrop, is_global=is_global, tb_last=tb_last, R=R)
    # bytes per problem of the direction rows kernel C streams out for its own
    # traceback where the plane is too large for shared memory, else 0; < 0
    # where C does not take the width
    scratch = kernels.query("ma_dp_fused_scratch_bytes", M, N)
    if fused_kernel(N, scratch >= 0) == "C'":
        return banded_align_runs_v2(q, t, qlen, tlen, band, M=M, N=N, params=params,
                                    zdrop=zdrop, is_global=is_global, tb_last=tb_last, R=R)
    q, t, meta_in, runs, meta = _operands(q, t, qlen, tlen, band, tb_last, M, N, R)
    P = q.shape[0]
    dirs = torch.empty(P * scratch, dtype=torch.uint8, device=q.device)
    if P:
        kernels.DP_FUSED.launch(q, t, meta_in, runs, meta, dirs, P, M, N, R,
                                *_scores(params), zdrop, int(is_global),
                                shape=(M, N, "global" if is_global else "extension"), items=P)
    return runs, meta
