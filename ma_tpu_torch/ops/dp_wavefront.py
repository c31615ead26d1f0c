"""Anti-diagonal wavefront DP: kernel D (csrc/dp_wavefront.cu), its
traceback kernel (csrc/dp_traceback.cu), and the plain PyTorch version of
each (port of ma_tpu/ops/dp_pallas.py `banded_align_pallas` and of the XLA
forms ma_tpu/ops/dp.py `banded_align` and `traceback_device`).

Contract of `banded_align_wavefront`: banded 2-piece affine DP over [P, M]
queries and [P, N] targets (codes >= 4 score 0), one scan step per
anti-diagonal d = i + j over the M query lanes. Returns a DPResult: direction
bytes [P, M+N-1, M] uint8 for every (diagonal, lane), masked cells included;
score (global: the end cell; extension: the max cell); the max cell (first
maximal lane of the first diagonal that reaches the maximum); zdropped.
z-drop is checked once per diagonal. `traceback_dirs` walks those bytes from
a start cell back to the matrix border.

A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors; there is no other route.
"""
from __future__ import annotations

import torch

from ma_tpu_torch import kernels
from ma_tpu_torch.ops.dp import (
    CONT_E1,
    CONT_E2,
    CONT_F1,
    CONT_F2,
    NEG_INF,
    OP_D,
    OP_I,
    OP_M,
    OP_NONE,
    SRC_E1,
    SRC_E2,
    SRC_F1,
    SRC_F2,
    SRC_MASK,
    DPParams,
    DPResult,
)

# kernel D keeps its state (9 int32 vectors of M lanes) in shared memory up
# to this size, in a global scratch above it
SMEM_STATE_BYTES = 200 * 1024


def _gap_cost(k, p: DPParams):
    """Best (negative) cost of a length-k gap, k >= 1."""
    return torch.maximum(-(p.gap_open + k * p.gap_extend), -(p.gap_open2 + k * p.gap_extend2))


def banded_align_wavefront_plain(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                                 zdrop: int = -1, is_global: bool = True) -> DPResult:
    """Plain PyTorch version of kernel D: the XLA scan of ma_tpu's
    `banded_align`, one step per anti-diagonal over [P, M] lanes."""
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    P, M = q.shape
    N = t.shape[1]
    D = M + N - 1
    dev = q.device
    m = qlen.to(torch.int32)[:, None]
    n = tlen.to(torch.int32)[:, None]
    w = band.to(torch.int32)[:, None]
    go1, ge1 = params.gap_open, params.gap_extend
    go2, ge2 = params.gap_open2, params.gap_extend2
    ii = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    gc_i = _gap_cost(ii, params)
    # t[d - i] for lane i is a slice of the reversed target padded with Ns
    rtp = torch.cat([torch.full((P, M - 1), 4, dtype=torch.int32, device=dev), t.flip(1),
                     torch.full((P, M), 4, dtype=torch.int32, device=dev)], 1)
    neg_col = torch.full((P, 1), NEG_INF, dtype=torch.int32, device=dev)

    def full(v):
        return torch.full((P,), v, dtype=torch.int32, device=dev)

    h1 = torch.full((P, M), NEG_INF, dtype=torch.int32, device=dev)
    h2, e1, e2, f1, f2 = (h1.clone() for _ in range(5))
    gmax = full(NEG_INF if is_global else 0)
    gi, gj, scr = full(-1), full(-1), full(NEG_INF)
    dropped = torch.zeros(P, dtype=torch.bool, device=dev)
    dirs = torch.empty((P, D, M), dtype=torch.uint8, device=dev)
    for d in range(D):
        jv = d - ii
        gc_j = _gap_cost(jv, params)
        valid = (ii < m) & (jv >= 0) & (jv < n) & (torch.abs(ii - jv) <= w)

        # E (reference gap) from (i, j-1) on diagonal d-1
        h_left = torch.where(jv > 0, h1, torch.where(ii > 0, gc_i, NEG_INF))
        e1x = torch.where(jv > 0, e1 - ge1, NEG_INF)
        e2x = torch.where(jv > 0, e2 - ge2, NEG_INF)
        ne1 = torch.maximum(h_left - (go1 + ge1), e1x)
        ne2 = torch.maximum(h_left - (go2 + ge2), e2x)
        ce1 = e1x >= h_left - (go1 + ge1)
        ce2 = e2x >= h_left - (go2 + ge2)

        # F (query gap) from (i-1, j) on diagonal d-1
        h_up = torch.where(ii > 0, torch.cat([neg_col, h1[:, :-1]], 1),
                           torch.where(jv > 0, gc_j, NEG_INF))
        f1x = torch.where(ii > 0, torch.cat([neg_col, f1[:, :-1]], 1) - ge1, NEG_INF)
        f2x = torch.where(ii > 0, torch.cat([neg_col, f2[:, :-1]], 1) - ge2, NEG_INF)
        nf1 = torch.maximum(h_up - (go1 + ge1), f1x)
        nf2 = torch.maximum(h_up - (go2 + ge2), f2x)
        cf1 = f1x >= h_up - (go1 + ge1)
        cf2 = f2x >= h_up - (go2 + ge2)

        # diagonal from (i-1, j-1) on diagonal d-2
        diag = torch.where((ii > 0) & (jv > 0), torch.cat([neg_col, h2[:, :-1]], 1),
                           torch.where((ii == 0) & (jv == 0), 0,
                                       torch.where(ii == 0, gc_j, gc_i)))
        s0 = M - 1 + N - 1 - d
        tc = rtp[:, s0 : s0 + M]
        sc = torch.where((q >= 4) | (tc >= 4), 0,
                         torch.where(q == tc, params.match, -params.mismatch))
        h = diag + sc

        # combine, ties to diag, E1, F1, E2, F2
        src = torch.zeros((P, M), dtype=torch.int32, device=dev)
        for cand, code in ((ne1, SRC_E1), (nf1, SRC_F1), (ne2, SRC_E2), (nf2, SRC_F2)):
            src = torch.where(cand > h, code, src)
            h = torch.maximum(h, cand)
        h = torch.where(valid, h, NEG_INF).to(torch.int32)
        dirs[:, d, :] = (
            src | torch.where(ce1, CONT_E1, 0) | torch.where(cf1, CONT_F1, 0)
            | torch.where(ce2, CONT_E2, 0) | torch.where(cf2, CONT_F2, 0)
        ).to(torch.uint8)

        # bookkeeping: global end cell, extension max, z-drop
        end_here = valid & (ii == m - 1) & (jv == n - 1)
        end_val = torch.where(end_here, h, NEG_INF).amax(1)
        scr = torch.where(end_here.any(1), end_val, scr)
        hm = torch.where(valid & ~dropped[:, None], h, NEG_INF)
        dmax = hm.amax(1)
        darg = torch.where(hm == dmax[:, None], ii, 2**30).amin(1)  # first maximal lane
        upd = (dmax > gmax) & ~dropped
        gmax = torch.where(upd, dmax, gmax)
        gi = torch.where(upd, darg, gi)
        gj = torch.where(upd, d - darg, gj)
        if zdrop >= 0:
            diff = torch.abs((darg - gi) - ((d - darg) - gj))
            has = valid.any(1) & (gi >= 0)
            dropped = dropped | (has & (gmax - dmax > zdrop + diff * ge1))
        h2, h1 = h1, h
        e1, e2, f1, f2 = ne1, ne2, nf1, nf2
    return DPResult(dirs=dirs, score=scr if is_global else gmax, max_i=gi, max_j=gj,
                    zdropped=dropped)


def banded_align_wavefront(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                           zdrop: int = -1, is_global: bool = True) -> DPResult:
    """Wavefront DP on the tensors' device: the plain version for CPU
    tensors, kernel D for CUDA tensors. q [P, M], t [P, N] codes;
    qlen/tlen/band [P]."""
    if q.device.type == "cpu":
        return banded_align_wavefront_plain(q, t, qlen, tlen, band, params, zdrop, is_global)
    P, M = q.shape
    N = t.shape[1]
    D = M + N - 1
    dev = q.device
    q = q.to(torch.int32).contiguous()
    t = t.to(torch.int32).contiguous()
    kernels.check(q, "q", torch.int32, (P, M))
    kernels.check(t, "t", torch.int32, (P, N))
    lens = torch.stack([qlen, tlen, band], 1).to(torch.int32).contiguous()
    kernels.check(lens, "lens", torch.int32, (P, 3))
    dirs = torch.empty((P, D, M), dtype=torch.uint8, device=dev)
    out = torch.empty((4, P), dtype=torch.int32, device=dev)
    scratch = (torch.empty((P, 9 * M), dtype=torch.int32, device=dev)
               if 9 * M * 4 > SMEM_STATE_BYTES else None)
    if P:
        kernels.DP_WAVEFRONT.launch(
            q, t, lens, dirs, out, 0 if scratch is None else scratch, P, M, N,
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            params.gap_open2, params.gap_extend2, zdrop, int(is_global),
        )
    return DPResult(dirs=dirs, score=out[0], max_i=out[1], max_j=out[2], zdropped=out[3] != 0)


_TB_H, _TB_E1, _TB_E2, _TB_F1, _TB_F2 = 0, 1, 2, 3, 4


def traceback_dirs_plain(dirs: torch.Tensor, si: torch.Tensor, sj: torch.Tensor):
    """Plain PyTorch version of the traceback kernel: the XLA scan of
    ma_tpu's `traceback_device`, one step of every problem at a time."""
    P, D, M = dirs.shape
    S = D + 1
    dev = dirs.device
    parr = torch.arange(P, device=dev)
    i = si.to(torch.int32).clone()
    j = sj.to(torch.int32).clone()
    mode = torch.zeros(P, dtype=torch.int32, device=dev)
    done = i < 0
    ops = torch.full((P, S), OP_NONE, dtype=torch.uint8, device=dev)
    for k in range(S):
        if bool(done.all()):
            break
        active = ~done & (i >= 0) & (j >= 0)
        byte = dirs[parr, (i + j).clamp(0, D - 1).long(), i.clamp(0, M - 1).long()].to(torch.int32)
        src = byte & SRC_MASK
        e_mode = torch.where(
            mode == _TB_H,
            torch.where(src == SRC_E1, _TB_E1,
                        torch.where(src == SRC_E2, _TB_E2,
                                    torch.where(src == SRC_F1, _TB_F1,
                                                torch.where(src == SRC_F2, _TB_F2, _TB_H)))),
            mode,
        )
        is_m = e_mode == _TB_H
        is_e = (e_mode == _TB_E1) | (e_mode == _TB_E2)
        op = torch.where(is_m, OP_M, torch.where(is_e, OP_D, OP_I))
        ops[:, k] = torch.where(active, op, OP_NONE).to(torch.uint8)
        cont_bit = torch.where(
            e_mode == _TB_E1, CONT_E1,
            torch.where(e_mode == _TB_E2, CONT_E2,
                        torch.where(e_mode == _TB_F1, CONT_F1, CONT_F2)),
        )
        cont = ~is_m & ((byte & cont_bit) != 0)
        ni = torch.where(active & (is_m | ~is_e), i - 1, i)
        nj = torch.where(active & (is_m | is_e), j - 1, j)
        nmode = torch.where(is_m | ~cont, _TB_H, e_mode)
        done = done | ~active | (ni < 0) | (nj < 0)
        mode = torch.where(active, nmode, mode).to(torch.int32)
        i, j = ni, nj
    n_ops = (ops != OP_NONE).sum(1, dtype=torch.int32)
    return ops, n_ops, i, j


def traceback_dirs(dirs: torch.Tensor, si: torch.Tensor, sj: torch.Tensor):
    """Traceback from (si, sj) over dirs [P, M+N-1, M] (si < 0 skips a
    problem): the plain version for CPU tensors, the traceback kernel for
    CUDA tensors. Returns (ops [P, M+N] uint8 back to front, OP_NONE padded;
    n_ops [P]; final i [P]; final j [P])."""
    if dirs.device.type == "cpu":
        return traceback_dirs_plain(dirs, si, sj)
    P, D, M = dirs.shape
    dev = dirs.device
    kernels.check(dirs, "dirs", torch.uint8, (P, D, M))
    start = torch.stack([si, sj]).to(device=dev, dtype=torch.int32).contiguous()
    kernels.check(start, "start", torch.int32, (2, P))
    ops = torch.empty((P, D + 1), dtype=torch.uint8, device=dev)
    out = torch.empty((3, P), dtype=torch.int32, device=dev)
    if P:
        kernels.DP_TRACEBACK.launch(dirs, start, ops, out, P, M, D)
    return ops, out[0], out[1], out[2]
