"""Row-sweep banded 2-piece affine-gap DP and its traceback (port of
ma_tpu/ops/dp_rows.py). Together with `dp_fused.pack_runs` this is the
plain PyTorch version of the fused DP kernel (kernel C).

Per query row i: F gaps (query gaps) carry from row i-1; E gaps (reference
gaps) are a max-plus prefix over the row,
    E_p(i, j) = cummax_k<j (H~(i, k) + e_p k) - o_p - e_p j,
where H~ = max(diag, F1, F2) excludes same-row E. Direction bytes use the
layout of ops/dp.py; ties prefer diag, E1, F1, E2, F2. The maximum cell
is tracked per row with the anti-diagonal tie order (smaller i + j, then
smaller i); z-drop is checked per row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
)


class RowDPResult(NamedTuple):
    dirs: torch.Tensor  # uint8 [P, M, N] direction bytes per (i, j)
    score: torch.Tensor  # int32 [P] global: H(m-1, n-1); extension: max cell
    max_i: torch.Tensor  # int32 [P]
    max_j: torch.Tensor  # int32 [P]
    zdropped: torch.Tensor  # bool [P]
    lastrow_max: torch.Tensor  # int32 [P] best undropped cell of row m-1 (NEG_INF if none)
    lastrow_arg: torch.Tensor  # int32 [P] its column


def _gap_cost(k, p: DPParams):
    """Best (negative) cost of a length-k gap, k >= 1."""
    return torch.maximum(-(p.gap_open + k * p.gap_extend), -(p.gap_open2 + k * p.gap_extend2))


def banded_align_rows(q, t, qlen, tlen, band, params: DPParams = DPParams(),
                      zdrop: int = -1, is_global: bool = True) -> RowDPResult:
    """q [P, M], t [P, N] codes (>= 4 is N, scores 0); qlen/tlen/band [P]."""
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    P, M = q.shape
    N = t.shape[1]
    dev = q.device
    m = qlen.to(torch.int32)[:, None]
    n = tlen.to(torch.int32)[:, None]
    w = band.to(torch.int32)[:, None]
    go1, ge1 = params.gap_open, params.gap_extend
    go2, ge2 = params.gap_open2, params.gap_extend2
    jj = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    gc_j = _gap_cost(jj, params)
    neg_col = torch.full((P, 1), NEG_INF, dtype=torch.int32, device=dev)

    def full(v):
        return torch.full((P,), v, dtype=torch.int32, device=dev)

    h_prev = torch.full((P, N), NEG_INF, dtype=torch.int32, device=dev)
    f1p = h_prev.clone()
    f2p = h_prev.clone()
    gmax = full(NEG_INF if is_global else 0)
    gi, gj, gd = full(-1), full(-1), full(2**30)
    scr = full(NEG_INF)
    lrmax, lrarg = full(NEG_INF), full(-1)
    dropped = torch.zeros(P, dtype=torch.bool, device=dev)
    dirs = torch.zeros((P, M, N), dtype=torch.uint8, device=dev)
    m_max = int(qlen.max()) if P else 0
    for i in range(min(m_max, M)):
        valid = (jj < n) & (i < m) & (torch.abs(i - jj) <= w)
        if i == 0:
            h_up = torch.where(jj > 0, gc_j, NEG_INF).expand(P, N)
            diag = torch.where(jj == 0, 0, gc_j).expand(P, N)
        else:
            h_up = h_prev
            diag = torch.cat([torch.full((P, 1), int(_gap_cost(torch.tensor(i), params)),
                                         dtype=torch.int32, device=dev), h_prev[:, :-1]], 1)
        nf1 = torch.maximum(h_up - (go1 + ge1), f1p - ge1)
        nf2 = torch.maximum(h_up - (go2 + ge2), f2p - ge2)
        cf1 = f1p - ge1 >= h_up - (go1 + ge1)
        cf2 = f2p - ge2 >= h_up - (go2 + ge2)

        qc = q[:, i : i + 1]
        sc = torch.where((qc >= 4) | (t >= 4), 0,
                         torch.where(qc == t, params.match, -params.mismatch))
        hd = diag + sc.to(torch.int32)
        h0 = torch.where(valid, torch.maximum(hd, torch.maximum(nf1, nf2)), NEG_INF)
        virt = int(_gap_cost(torch.tensor(i), params)) if i > 0 else NEG_INF
        virt_col = torch.full((P, 1), virt, dtype=torch.int32, device=dev)
        v1 = torch.cat([virt_col - ge1, (h0 + ge1 * jj)[:, :-1]], 1)
        e1 = torch.cummax(v1, 1).values - go1 - ge1 * jj
        v2 = torch.cat([virt_col - ge2, (h0 + ge2 * jj)[:, :-1]], 1)
        e2 = torch.cummax(v2, 1).values - go2 - ge2 * jj
        open_src = torch.cat([virt_col, h0[:, :-1]], 1)
        ce1 = torch.cat([neg_col, e1[:, :-1]], 1) - ge1 >= open_src - (go1 + ge1)
        ce2 = torch.cat([neg_col, e2[:, :-1]], 1) - ge2 >= open_src - (go2 + ge2)

        h = hd
        src = torch.zeros((P, N), dtype=torch.int32, device=dev)
        for cand, code in ((e1, SRC_E1), (nf1, SRC_F1), (e2, SRC_E2), (nf2, SRC_F2)):
            src = torch.where(cand > h, code, src)
            h = torch.maximum(h, cand)
        h = torch.where(valid, h, NEG_INF)
        dirs[:, i, :] = (
            src | torch.where(ce1, CONT_E1, 0) | torch.where(cf1, CONT_F1, 0)
            | torch.where(ce2, CONT_E2, 0) | torch.where(cf2, CONT_F2, 0)
        ).to(torch.uint8)

        # ---- bookkeeping
        n_last = torch.clamp(n - 1, 0, N - 1).long()
        at_end = (i == m[:, 0] - 1) & (valid & (jj == n - 1)).any(1)
        scr = torch.where(at_end, torch.gather(h, 1, n_last)[:, 0], scr)
        hm = torch.where(valid & ~dropped[:, None], h, NEG_INF)
        rmax = hm.amax(1)
        rarg = torch.argmax(hm, 1).to(torch.int32)  # first maximal column
        at_last = i == m[:, 0] - 1
        lrmax = torch.where(at_last, rmax, lrmax)
        lrarg = torch.where(at_last, rarg, lrarg)
        upd = ((rmax > gmax) | ((rmax == gmax) & (gi >= 0) & (i + rarg < gd))) & ~dropped
        upd = upd & (rmax > NEG_INF)
        gmax = torch.where(upd, rmax, gmax)
        gi = torch.where(upd, i, gi)
        gj = torch.where(upd, rarg, gj)
        gd = torch.where(upd, i + rarg, gd)
        if zdrop >= 0:
            diff = torch.abs((i - gi) - (rarg - gj))
            has = valid.any(1) & (gi >= 0)
            dropped = dropped | (has & (gmax - rmax > zdrop + diff * ge1))
        h_prev, f1p, f2p = h, nf1, nf2
    return RowDPResult(dirs=dirs, score=scr if is_global else gmax, max_i=gi,
                       max_j=gj, zdropped=dropped, lastrow_max=lrmax,
                       lastrow_arg=lrarg)


_TB_H, _TB_E1, _TB_E2, _TB_F1, _TB_F2 = 0, 1, 2, 3, 4


def traceback_device_rows(dirs: torch.Tensor, si: torch.Tensor, sj: torch.Tensor):
    """Batched traceback over [P, M, N] direction bytes from (si, sj).
    Returns (ops [P, M+N] uint8 back-to-front, OP_NONE padded; n_ops [P];
    final i [P]; final j [P]) — the final coordinates give the leading
    I (i + 1) or D (j + 1) residual through the virtual row/column."""
    P, M, N = dirs.shape
    dev = dirs.device
    S_path = M + N
    parr = torch.arange(P, device=dev)
    i = si.to(torch.int32).clone()
    j = sj.to(torch.int32).clone()
    mode = torch.zeros(P, dtype=torch.int32, device=dev)
    done = i < 0
    ops = torch.full((P, S_path), OP_NONE, dtype=torch.uint8, device=dev)
    for k in range(S_path):
        if bool(done.all()):
            break
        active = ~done & (i >= 0) & (j >= 0)
        byte = dirs[parr, i.clamp(0, M - 1).long(), j.clamp(0, N - 1).long()].to(torch.int32)
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
