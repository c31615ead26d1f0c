"""Anti-diagonal wavefront DP: kernel D (csrc/dp_wavefront.cu), its
traceback kernel (csrc/dp_traceback.cu), and the plain PyTorch version of
each (port of ma_tpu/ops/dp_pallas.py `banded_align_pallas` and of the XLA
forms ma_tpu/ops/dp.py `banded_align` and `traceback_device`).

Contract of `banded_align_wavefront`: banded 2-piece affine DP over [P, M]
queries and [P, N] targets (codes >= 4 score 0; kernel D compares codes in
one byte, so on the card codes below -128 are refused), one scan step per
anti-diagonal d = i + j over the M query lanes. Returns a DPResult: direction
bytes [P, M+N-1, M] uint8 for every (diagonal, lane), masked cells included;
score (global: the end cell; extension: the max cell); the max cell (first
maximal lane of the first diagonal that reaches the maximum); zdropped.
z-drop is checked once per diagonal. `traceback_dirs` walks those bytes from
a start cell back to the matrix border.

The max cell and z-drop depend on the cells only through each diagonal's
maximum over its in-band lanes and the first lane that holds it: a drop
freezes the book and changes no cell. So kernel D keeps a table of those
per-diagonal maxima during the sweep and rebuilds the book from it after
(`wavefront_book_from_keys` is the rebuild as a plain function).

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


def _gap_cost(k, p: DPParams):
    """Best (negative) cost of a length-k gap, k >= 1."""
    return torch.maximum(-(p.gap_open + k * p.gap_extend), -(p.gap_open2 + k * p.gap_extend2))


def _wavefront_plain(q, t, qlen, tlen, band, params: DPParams, zdrop: int, is_global: bool,
                     table: bool = False):
    """The XLA scan of ma_tpu's `banded_align`, one step per anti-diagonal
    over [P, M] lanes. Returns (DPResult, dmax [P, D], darg [P, D]) where
    `table` asks for the last two (else None, None): each diagonal's maximum
    H over its in-band lanes (NEG_INF where it has none) and the first lane
    that holds it (0 where it has none), unmasked by z-drop."""
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
    kmax = karg = None
    if table:
        kmax = torch.empty((P, D), dtype=torch.int32, device=dev)
        karg = torch.empty((P, D), dtype=torch.int32, device=dev)
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

        if table:  # the invalid lanes hold NEG_INF
            kmax[:, d] = h.amax(1)
            karg[:, d] = torch.where(h == kmax[:, d : d + 1], ii, 2**30).amin(1)

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
    res = DPResult(dirs=dirs, score=scr if is_global else gmax, max_i=gi, max_j=gj,
                   zdropped=dropped)
    return res, kmax, karg


def banded_align_wavefront_plain(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                                 zdrop: int = -1, is_global: bool = True) -> DPResult:
    """Plain PyTorch version of kernel D: the XLA scan of ma_tpu's
    `banded_align`, one step per anti-diagonal over [P, M] lanes."""
    return _wavefront_plain(q, t, qlen, tlen, band, params, zdrop, is_global)[0]


def wavefront_diagonal_maxima_plain(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                                    zdrop: int = -1, is_global: bool = True):
    """The plain version's per-diagonal table, as kernel D builds it during
    its sweep: (dmax [P, D], darg [P, D]) int32, each diagonal's maximum H
    over its in-band lanes (NEG_INF where it has none) and the first lane
    holding it (0 where it has none)."""
    return _wavefront_plain(q, t, qlen, tlen, band, params, zdrop, is_global, table=True)[1:]


def _any_valid(d, qlen, tlen, band, M: int):
    """[P, D] whether diagonal d holds an in-band cell: some lane
    i < min(m, M) with 0 <= d - i < n and |2 i - d| <= band."""
    m = torch.clamp(qlen.long(), max=M)[:, None]
    n = tlen.long()[:, None]
    w = band.long()[:, None]
    half = lambda x: torch.div(x, 2, rounding_mode="floor")  # noqa: E731
    lo = torch.maximum(torch.clamp(d - n + 1, min=0), half(d - w + 1))
    hi = torch.minimum(torch.minimum(m - 1, d), half(d + w))
    return lo <= hi


def wavefront_book_from_keys(dmax, darg, qlen, tlen, band, *, M: int,
                             params: DPParams = DPParams(), zdrop: int = -1,
                             is_global: bool = True):
    """The max cell and z-drop rebuilt after the sweep from each diagonal's
    maximum and first maximal lane (dmax, darg [P, D]), as kernel D's fold
    does: a prefix argmax with strict > gives the running book (max_i,
    max_j, and the max, which starts at 0 for an extension and NEG_INF for a
    global problem); the drop diagonal is the first d with an in-band cell,
    a book (max_i >= 0) and max - dmax(d) > zdrop + |(darg - max_i) - ((d -
    darg) - max_j)| * gap_extend; the result is the book there, or at the
    last diagonal where none drops. Returns (max [P], max_i [P], max_j [P]
    int32, zdropped [P] bool)."""
    P, D = dmax.shape
    dev = dmax.device
    d = torch.arange(D, device=dev)[None, :]
    g0 = NEG_INF if is_global else 0
    # the earliest diagonal reaching the running maximum
    run = (dmax.long() * 2**32 + (2**32 - 1 - d)).cummax(1).values
    rmax = run >> 32
    rd = (2**32 - 1) - (run & (2**32 - 1))
    upd = rmax > g0
    gmax = torch.where(upd, rmax, g0)
    gi = torch.where(upd, darg.long().gather(1, rd), -1)
    gj = torch.where(upd, rd - gi, -1)
    at = torch.full((P, 1), D - 1, device=dev)
    dropped = torch.zeros(P, dtype=torch.bool, device=dev)
    if zdrop >= 0:
        a = darg.long()
        diff = torch.abs((a - gi) - ((d - a) - gj))
        drop = (_any_valid(d, qlen, tlen, band, M) & (gi >= 0)
                & (gmax - dmax.long() > zdrop + diff * params.gap_extend))
        first = torch.where(drop, d, D).amin(1, keepdim=True)
        dropped = first[:, 0] < D
        at = first.clamp(max=D - 1)
    pick = lambda x: x.gather(1, at)[:, 0].to(torch.int32)  # noqa: E731
    return pick(gmax), pick(gi), pick(gj), dropped


def banded_align_wavefront(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                           zdrop: int = -1, is_global: bool = True, *,
                           lanes: int = 0) -> DPResult:
    """Wavefront DP on the tensors' device: the plain version for CPU
    tensors, kernel D for CUDA tensors. q [P, M], t [P, N] codes;
    qlen/tlen/band [P]. `lanes`: kernel D's lanes a thread, 4 or 2 (0: the
    kernel's rule, `ma_dp_wavefront_lanes`); the result does not depend on
    it."""
    if q.device.type == "cpu":
        return banded_align_wavefront_plain(q, t, qlen, tlen, band, params, zdrop, is_global)
    P, M = q.shape
    N = t.shape[1]
    D = M + N - 1
    dev = q.device
    # kernel D compares codes in one byte (code_byte), exactly down to -128
    wide = [x.min().long() for x in (q, t) if x.dtype not in (torch.uint8, torch.int8)
            and x.numel()]
    if wide and int(torch.stack(wide).min()) < -128:
        raise ValueError("kernel D compares codes in one byte: a code is below -128")
    q = q.to(torch.int32).contiguous()
    t = t.to(torch.int32).contiguous()
    kernels.check(q, "q", torch.int32, (P, M))
    kernels.check(t, "t", torch.int32, (P, N))
    lens = torch.stack([qlen, tlen, band], 1).to(torch.int32).contiguous()
    kernels.check(lens, "lens", torch.int32, (P, 3))
    # the target as the kernel stages it: one byte a code, every code >= 4
    # an N (4), any other its low byte (csrc/dp_wavefront.cu code_byte)
    t8 = (torch.where(t >= 4, 4, t) & 0xFF).to(torch.uint8)
    dirs = torch.empty((P, D, M), dtype=torch.uint8, device=dev)
    out = torch.empty((4, P), dtype=torch.int32, device=dev)
    # the per-diagonal maxima (one 64-bit key a diagonal) and, where a
    # problem's lanes take more than one round of the team's warps, the
    # last lane's state at every diagonal for the next round (int32 x 4)
    keys = torch.empty((P, D), dtype=torch.int64, device=dev)
    lanes = lanes or kernels.query("ma_dp_wavefront_lanes", P, M)
    rounds_state = kernels.query("ma_dp_wavefront_round_ints", M, N, lanes)
    carry = torch.empty((P, rounds_state), dtype=torch.int32, device=dev)
    if P:
        kernels.DP_WAVEFRONT.launch(
            q, t8, lens, dirs, out, keys, carry if rounds_state else 0, P, M, N,
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            params.gap_open2, params.gap_extend2, zdrop, int(is_global), lanes,
            shape=(P, M, N, "global" if is_global else "extension"), items=P,
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
