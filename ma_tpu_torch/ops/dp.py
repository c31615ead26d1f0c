"""Banded 2-piece affine-gap DP (port of ma_tpu/ops/dp.py): constants,
scoring parameters, the direction-tensor DP and its traceback (kernel D and
the traceback kernel, ops/dp_wavefront.py), the descriptor-mode entries of
both DP kernels, the host CIGAR decoders, and `nw_alignment`, a single global
alignment through the direction-tensor DP.

The port has one direction-tensor DP, the anti-diagonal wavefront. ma_tpu's
`banded_align_traceback` picks its DP by MA_TPU_DP: unset it runs the XLA
row DP, "pallas" the Pallas wavefront, and any other value (the reference
setting "fused" included) the XLA anti-diagonal `banded_align`, which the
port's matches cell for cell.

Direction byte layout (shared by every DP formulation):
    bits 0..2: source of H (0=diag/match, 1=E1, 2=F1, 3=E2, 4=F2)
    bit 3/4/5/6: E1/F1/E2/F2 continuation (gap extends rather than opens)
E gaps consume the reference (CIGAR 'D'), F gaps the query ('I').
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ma_tpu_torch.utils import profile

NEG_INF = -(2**30)

SRC_MASK = 0x07
SRC_DIAG, SRC_E1, SRC_F1, SRC_E2, SRC_F2 = 0, 1, 2, 3, 4
CONT_E1, CONT_F1, CONT_E2, CONT_F2 = 0x08, 0x10, 0x20, 0x40

OP_M, OP_I, OP_D = 0, 1, 2
OP_NONE = 255

RUNS_HEAD = 12  # packed runs carried in the first rows of `comb`


class DPResult(NamedTuple):
    dirs: torch.Tensor  # uint8 [P, M+N-1, M] direction bytes per (diagonal, i)
    score: torch.Tensor  # int32 [P] global: H(m-1, n-1); extension: max-cell H
    max_i: torch.Tensor  # int32 [P] max cell query index
    max_j: torch.Tensor  # int32 [P] max cell reference index
    zdropped: torch.Tensor  # bool [P]


class DPParams(NamedTuple):
    match: int = 2
    mismatch: int = 4  # positive penalty
    gap_open: int = 4
    gap_extend: int = 2
    gap_open2: int = 24
    gap_extend2: int = 1


def run_capacity(M: int) -> int:
    """Runs per problem of the fused kernel for query bucket M: 256-base
    problems on noisy reads carry ~2 runs per indel event."""
    return 32 if M <= 64 else 96


def _desc_operands(text: torch.Tensor, seqs: torch.Tensor, desc: torch.Tensor,
                   M: int, N: int):
    """[P, M] query / [P, N] target code windows (int32, 4 = N past the
    lengths) from int32 descriptors [8, P] (read, q_off, q_len, q_rev,
    t_start, t_len, t_rev, band) against the device genome text [T] and read
    batch [B, L]."""
    b, q_off, q_len, q_rev, t_start, t_len, t_rev, band = desc.long()
    L = seqs.shape[1]
    T = text.shape[0]
    dev = seqs.device
    mi = torch.arange(M, device=dev)[None, :]
    qidx = torch.where(q_rev[:, None] == 1, q_off[:, None] + q_len[:, None] - 1 - mi,
                       q_off[:, None] + mi)
    q = seqs.reshape(-1)[b[:, None] * L + qidx.clamp(0, L - 1)]
    q = torch.where(mi < q_len[:, None], q, torch.full_like(q, 4)).to(torch.int32)
    nj = torch.arange(N, device=dev)[None, :]
    tidx = torch.where(t_rev[:, None] == 1, t_start[:, None] + t_len[:, None] - 1 - nj,
                       t_start[:, None] + nj)
    t = text[tidx.clamp(0, T - 1)]
    t = torch.where(nj < t_len[:, None], t, torch.full_like(t, 4)).to(torch.int32)
    return q, t, desc[2], desc[5], desc[7]


def _dp_desc_runs_fused(text, seqs, desc, M: int, N: int, params: DPParams,
                        zdrop: int, is_global: bool, tb_last=None):
    """Descriptor-mode DP through the fused kernel (ops/dp_fused.py):
    forward + traceback on the device; only packed runs + meta leave it.

    Returns (comb [8 + RUNS_HEAD, P] int32, runs_t [R, P] int32): comb rows
    0-7 are the meta (n_runs, score, max_i, max_j, zdropped, run_overflow,
    lastrow_max, lastrow_arg) and rows 8.. the first RUNS_HEAD packed runs
    (op | len << 2, back to front). R = run_capacity(M)."""
    from ma_tpu_torch.ops.dp_fused import banded_align_runs

    q, t, q_len, t_len, band = _desc_operands(text, seqs, desc, M, N)
    runs, meta = banded_align_runs(
        q, t, q_len, t_len, band, M=M, N=N, params=params, zdrop=zdrop,
        is_global=is_global, tb_last=tb_last, R=run_capacity(M),
    )
    runs_t = runs.transpose(0, 1).contiguous()
    return torch.cat([meta, runs_t[:RUNS_HEAD]], 0), runs_t


# ------------------------------------------------ direction-tensor DP (kernel D)
def banded_align(q, t, qlen, tlen, band, params: DPParams = DPParams(), zdrop: int = -1,
                 is_global: bool = True) -> DPResult:
    """Batched banded DP over q [P, M], t [P, N] codes with qlen/tlen/band
    [P] on their device (kernel D on a CUDA device, its plain version on
    the CPU); see ops/dp_wavefront.py for the contract."""
    from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront

    return banded_align_wavefront(q, t, qlen, tlen, band, params, zdrop, is_global)


def traceback_device(dirs: torch.Tensor, si: torch.Tensor, sj: torch.Tensor):
    """Batched traceback over dirs [P, M+N-1, M] from (si, sj), si < 0
    skipping a problem. Returns (ops [P, M+N] uint8 back to front with
    OP_NONE padding, n_ops [P], rem_i [P], rem_j [P]); rem_* are the leading
    gap residuals (rem_i + 1 inserts, rem_j + 1 deletions)."""
    from ma_tpu_torch.ops.dp_wavefront import traceback_dirs

    return traceback_dirs(dirs, si, sj)


def banded_align_traceback(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                           zdrop: int = -1, is_global: bool = True):
    """banded_align + traceback on the device; only ops and scalars leave
    it. Start cell: (qlen-1, tlen-1) in global mode, the max cell for
    extensions (max_i = -1: nothing aligned). Returns (ops, n_ops, rem_i,
    rem_j, score, max_i, max_j, zdropped)."""
    res = banded_align(q, t, qlen, tlen, band, params, zdrop, is_global)
    if is_global:
        si = qlen.to(torch.int32) - 1
        sj = tlen.to(torch.int32) - 1
    else:
        si, sj = res.max_i, res.max_j
    ops, n_ops, rem_i, rem_j = traceback_device(res.dirs, si, sj)
    return ops, n_ops, rem_i, rem_j, res.score, res.max_i, res.max_j, res.zdropped


def banded_align_traceback_packed(qa: np.ndarray, ta: np.ndarray, qlen, tlen, band, *,
                                  device, params: DPParams = DPParams(), zdrop: int = -1,
                                  is_global: bool = True):
    """Host wrapper: upload host code arrays qa [P, M], ta [P, N] to
    `device`, run banded_align_traceback there, and download meta [7, P]
    int32 (n_ops, rem_i, rem_j, score, max_i, max_j, zdropped) and the ops
    columns the longest traceback needs. Returns (ops [P, S] uint8, meta)."""
    as_dev = lambda a: torch.as_tensor(np.asarray(a), device=device)
    profile.host_sync(5)  # the five uploads below
    ops, n_ops, rem_i, rem_j, score, max_i, max_j, zd = banded_align_traceback(
        as_dev(np.asarray(qa, np.uint8)), as_dev(np.asarray(ta, np.uint8)),
        as_dev(np.asarray(qlen, np.int32)), as_dev(np.asarray(tlen, np.int32)),
        as_dev(np.asarray(band, np.int32)), params, zdrop, is_global,
    )
    meta = torch.stack([n_ops, rem_i, rem_j, score, max_i, max_j, zd.to(torch.int32)])
    profile.host_sync()
    meta = meta.to(torch.int32).cpu().numpy()
    # the ops columns the longest traceback needs, rounded up to 128
    smax = int(meta[0].max(initial=0))
    profile.host_sync()
    return ops[:, : min(ops.shape[1], max(128, -(-smax // 128) * 128))].cpu().numpy(), meta


MAX_RUNS = 32  # runs per problem _pack_runs_core keeps; rows with more decode from ops


def _pack_runs_core(ops: torch.Tensor, n_ops: torch.Tensor):
    """Run boundaries of each traceback row on the device. ops [P, S] uint8
    back to front, n_ops [P]. Returns (run_op [P, MAX_RUNS] uint8, run_start
    [P, MAX_RUNS] int32, n_runs [P] int32), runs in stored (back-to-front)
    order; runs past MAX_RUNS are dropped (n_runs still counts them)."""
    P, S = ops.shape
    dev = ops.device
    jj = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    valid = jj < n_ops[:, None]
    prev = torch.cat([torch.full((P, 1), OP_NONE, dtype=ops.dtype, device=dev), ops[:, :-1]], 1)
    ch = valid & ((ops != prev) | (jj == 0))
    rid = torch.cumsum(ch.to(torch.int32), 1, dtype=torch.int32) - 1
    n_runs = torch.where(n_ops > 0, rid[:, -1] + 1, 0).to(torch.int32)
    profile.host_sync()  # nonzero waits for its count
    pi, ji = torch.nonzero(ch & (rid < MAX_RUNS), as_tuple=True)
    ri = rid[pi, ji].long()
    run_start = torch.zeros((P, MAX_RUNS), dtype=torch.int32, device=dev)
    run_start[pi, ri] = ji.to(torch.int32)
    run_op = torch.zeros((P, MAX_RUNS), dtype=torch.uint8, device=dev)
    run_op[pi, ri] = ops[pi, ji]
    return run_op, run_start, n_runs


def _dp_tb_desc_runs(text, seqs, desc, M: int, N: int, params: DPParams, zdrop: int,
                     is_global: bool):
    """Descriptor-mode DP through kernel D + the traceback kernel, plus run
    packing on the device. desc [8, P] int32 as in _desc_operands. Returns
    (ops [P, M+N] uint8, meta [7, P] int32: n_ops, rem_i, rem_j, score,
    max_i, max_j, zdropped; run_op, run_start, n_runs)."""
    q, t, q_len, t_len, band = _desc_operands(text, seqs, desc, M, N)
    ops, n_ops, rem_i, rem_j, score, max_i, max_j, zd = banded_align_traceback(
        q, t, q_len, t_len, band, params, zdrop, is_global)
    meta = torch.stack([n_ops, rem_i, rem_j, score, max_i, max_j,
                        zd.to(torch.int32)]).to(torch.int32)
    run_op, run_start, n_runs = _pack_runs_core(ops, n_ops)
    return ops, meta, run_op, run_start, n_runs


# ------------------------------------------------------------ host decoders
def runs_to_cigars(run_op, run_start, n_ops, n_runs, rem_i, rem_j):
    """Expand run boundaries to forward-order cigars, exactly as
    rle_ops_batch does (leading D / I residuals, adjacent-op merge). Rows
    with more than MAX_RUNS runs give None (decode them from the ops row)."""
    P = run_op.shape[0]
    out = []
    for p in range(P):
        nr = int(n_runs[p])
        if nr > MAX_RUNS:
            out.append(None)
            continue
        cigar: list = []
        if rem_j[p] >= 0:
            cigar.append((OP_D, int(rem_j[p]) + 1))
        if rem_i[p] >= 0:
            cigar.append((OP_I, int(rem_i[p]) + 1))
        total = int(n_ops[p])
        if nr and total:
            starts = run_start[p]
            for r in range(nr - 1, -1, -1):  # stored order is back to front
                end = total if r == nr - 1 else int(starts[r + 1])
                op, ln = int(run_op[p, r]), end - int(starts[r])
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))
        out.append([c for c in cigar if c[1] > 0])
    return out


def rle_ops_batch(ops: np.ndarray, n_ops, rem_i, rem_j):
    """Run-length encode a whole traceback batch on the host: ops [P, S]
    back-to-front rows, n_ops / rem_i / rem_j [P]. Returns P forward-order
    cigars [(op, len)]."""
    P, S = ops.shape
    n_ops = np.asarray(n_ops, np.int64)
    j = np.arange(S, dtype=np.int64)
    idx = np.clip(n_ops[:, None] - 1 - j[None, :], 0, S - 1)
    fwd = np.take_along_axis(ops, idx, axis=1)
    valid = j[None, :] < n_ops[:, None]
    fwd = np.where(valid, fwd, OP_NONE)
    start = valid & ((j[None, :] == 0) | (fwd != np.roll(fwd, 1, axis=1)))
    rp, rj = np.nonzero(start)
    run_op = fwd[rp, rj]
    next_start = np.empty(len(rp), np.int64)
    next_start[:-1] = np.where(rp[:-1] == rp[1:], rj[1:], n_ops[rp[:-1]])
    if len(rp):
        next_start[-1] = n_ops[rp[-1]]
    run_len = next_start - rj
    row_bounds = np.searchsorted(rp, np.arange(P + 1))
    rem_i = np.asarray(rem_i)
    rem_j = np.asarray(rem_j)
    cigars = []
    for p in range(P):
        cigar: list = []
        if rem_j[p] >= 0:
            cigar.append((OP_D, int(rem_j[p]) + 1))
        if rem_i[p] >= 0:
            cigar.append((OP_I, int(rem_i[p]) + 1))
        for k in range(row_bounds[p], row_bounds[p + 1]):
            op, ln = int(run_op[k]), int(run_len[k])
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))
        cigars.append([c for c in cigar if c[1] > 0])
    return cigars


def rle_ops(ops_row: np.ndarray, n: int, rem_i: int, rem_j: int):
    """Reverse + run-length encode one traceback row into forward-order
    [(op, len)], with the leading residual gaps (D, then I) first."""
    ops = ops_row[:n][::-1]
    cigar: list = []
    if rem_j >= 0:
        cigar.append((OP_D, rem_j + 1))
    if rem_i >= 0:
        cigar.append((OP_I, rem_i + 1))
    if n:
        change = np.flatnonzero(ops[1:] != ops[:-1]) + 1
        bounds = np.concatenate(([0], change, [len(ops)]))
        for s, e in zip(bounds[:-1], bounds[1:]):
            op, ln = int(ops[s]), int(e - s)
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))
    return [c for c in cigar if c[1] > 0]


def traceback_one(dirs: np.ndarray, si: int, sj: int):
    """Host traceback of one problem's dirs [D, M] from (si, sj); leading
    gaps through the virtual row / column become leading D / I runs.
    Returns the forward-order cigar [(op, len)]."""
    ops: list = []
    i, j = si, sj
    while i >= 0 and j >= 0:
        byte = int(dirs[i + j, i])
        src = byte & SRC_MASK
        if src == SRC_DIAG:
            ops.append(OP_M)
            i -= 1
            j -= 1
        elif src in (SRC_E1, SRC_E2):
            cont_bit = CONT_E1 if src == SRC_E1 else CONT_E2
            while j >= 0:
                byte = int(dirs[i + j, i])
                ops.append(OP_D)
                j -= 1
                if not byte & cont_bit:
                    break
        else:
            cont_bit = CONT_F1 if src == SRC_F1 else CONT_F2
            while i >= 0:
                byte = int(dirs[i + j, i])
                ops.append(OP_I)
                i -= 1
                if not byte & cont_bit:
                    break
    if i >= 0:
        ops.extend([OP_I] * (i + 1))
    if j >= 0:
        ops.extend([OP_D] * (j + 1))
    ops.reverse()
    cigar: list = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return cigar


def nw_alignment(q: np.ndarray, t: np.ndarray, params: DPParams = DPParams(), *, device):
    """Plain global alignment of two sequences -> (score, cigar) — the
    NWAlignment module's role (needlemanWunsch.h:131-156). Unbanded
    (band = max(len)) single-problem convenience wrapper, on `device`."""
    q = np.asarray(q, np.uint8)
    t = np.asarray(t, np.uint8)
    band = max(len(q), len(t), 1)
    as_dev = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    ops, n_ops, rem_i, rem_j, score, _mi, _mj, _zd = banded_align_traceback(
        as_dev(q[None] if len(q) else np.full((1, 1), 4, np.uint8), torch.uint8),
        as_dev(t[None] if len(t) else np.full((1, 1), 4, np.uint8), torch.uint8),
        as_dev([len(q) or 1], torch.int32),
        as_dev([len(t) or 1], torch.int32),
        as_dev([band], torch.int32),
        params=params, zdrop=-1, is_global=True,
    )
    cigar = rle_ops(ops.cpu().numpy()[0], int(n_ops[0]), int(rem_i[0]), int(rem_j[0]))
    return int(score[0]), cigar
