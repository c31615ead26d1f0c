"""Strip of Consideration (port of ma_tpu/ops/soc.py): `soc_collect` and
`_soc_finish`.

Seeds are sorted by delta; each seed opens a candidate strip whose window
width is (match*|q| - gap) / extend; prefix sums give every window's score
(accumulated length, tie-break lower ambiguity) in O(1). The overlap vacuum
sweep (push_back_no_overlap) is `ops/soc_cuda.soc_sweep`: kernel A on a CUDA
tensor, the port of the XLA while_loop on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ma_tpu_torch.ops.extract import INT_MAX, SeedBatch
from ma_tpu_torch.ops.soc_cuda import soc_sweep
from ma_tpu_torch.ops.sortops import (
    merge_rank,
    run_ends,
    searchsorted_rows,
    sel_minor,
    sort_with_payloads,
)


class SoCBatch(NamedTuple):
    seeds: SeedBatch  # sorted seed planes the windows index into
    start: torch.Tensor  # int32 [B, K] window start (seed index)
    end: torch.Tensor  # int32 [B, K] window end (exclusive)
    score: torch.Tensor  # int32 [B, K] accumulated seed length
    amb: torch.Tensor  # int32 [B, K] accumulated ambiguity
    n_socs: torch.Tensor  # int32 [B]
    overflow: torch.Tensor  # bool [B]


def _sort_seeds_by(seeds: SeedBatch, *keys: torch.Tensor) -> SeedBatch:
    _, (q, l, r, fw, amb, dl, nt, va) = sort_with_payloads(
        list(keys),
        [seeds.q_start, seeds.length, seeds.ref_start, seeds.on_forward,
         seeds.ambiguity, seeds.delta, seeds.soc_nt, seeds.valid],
    )
    return SeedBatch(q_start=q, length=l, ref_start=r, on_forward=fw,
                     ambiguity=amb, delta=dl, soc_nt=nt, valid=va,
                     n_seeds=seeds.n_seeds, overflow=seeds.overflow)


def _exclusive(c: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)


def soc_collect(
    seeds: SeedBatch,
    qlen: torch.Tensor,  # int32 [B]
    contig_starts: torch.Tensor,  # int32 [C]
    match: int = 2,
    extend: int = 2,
    gap: int = 4,
    fixed_width: int = 0,
    rectangular: bool = True,
    min_score=0,  # int32 [B] or int (fMinLen; 0 for small genomes)
    max_socs: int = 64,
) -> SoCBatch:
    sd, cand_all, min_score = soc_candidates(
        seeds, qlen, contig_starts, match, extend, gap, fixed_width, rectangular,
        min_score,
    )
    B, S = seeds.delta.shape
    n = sd.n_seeds
    # ---- 5. push_back_no_overlap sweep (soc.h:362-404)
    st_f, sp_f, over_f = soc_sweep(cand_all, n.contiguous(), min_score, max_socs)
    n_socs = sp_f
    soc_valid = torch.arange(max_socs, device=n.device)[None, :] < n_socs[:, None]
    return _soc_finish(
        sd, n, st_f[:, :, 0], st_f[:, :, 1], st_f[:, :, 2], st_f[:, :, 3],
        soc_valid, n_socs, seeds.overflow | over_f, rectangular, S,
    )


def soc_candidates(seeds: SeedBatch, qlen, contig_starts, match: int = 2,
                   extend: int = 2, gap: int = 4, fixed_width: int = 0,
                   rectangular: bool = True, min_score=0):
    """Steps 1-4 of soc_collect: the delta-sorted seeds, the candidate
    table [S, B, 7] int32 (sl, sa, we, pexs, aexs, pend, aend per window
    start; candidate-major, as the sweep reads it) and min_score [B] int32."""
    B, S = seeds.delta.shape
    dev = seeds.delta.device
    # ---- 1. sort by delta (padding has delta INT_MAX -> sorts last)
    sd = _sort_seeds_by(seeds, seeds.delta)
    n = sd.n_seeds
    valid = sd.valid
    min_score = torch.as_tensor(min_score, dtype=torch.int32, device=dev).expand(B)

    # ---- 2. per-seed contig / strand runs
    contig = searchsorted_rows(
        contig_starts[None, :].expand(B, -1), sd.ref_start, "right"
    ) - 1
    key = contig if rectangular else contig * 2 + sd.on_forward.to(torch.int32)
    change = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), key[:, 1:] != key[:, :-1]], 1
    )
    run_end = run_ends(change)

    # ---- 3. prefix sums for O(1) range scores
    zero = torch.zeros_like(sd.length)
    plen = torch.cumsum(torch.where(valid, sd.length, zero), 1, dtype=torch.int32)
    pamb = torch.cumsum(torch.where(valid, sd.ambiguity, zero), 1, dtype=torch.int32)
    plen_ex = _exclusive(plen)
    pamb_ex = _exclusive(pamb)

    # ---- 4. window end per start + full-window scores
    if fixed_width:
        width = torch.full((B,), fixed_width, dtype=torch.int32, device=dev)
    else:
        width = ((match * qlen - gap) // extend).to(torch.int32)
    limit = torch.where(
        sd.delta >= INT_MAX - width[:, None],
        torch.full_like(sd.delta, INT_MAX),
        sd.delta + width[:, None],
    )
    j_raw, _ = merge_rank(sd.delta, limit)
    win_end = torch.minimum(torch.minimum(j_raw, run_end), n[:, None])
    iota_s = torch.arange(S, dtype=torch.int32, device=dev)[None, :].expand(B, S)
    _, (pend_all, aend_all) = merge_rank(iota_s, win_end - 1, carries=[plen, pamb])
    sl_all = pend_all - plen_ex
    sa_all = aend_all - pamb_ex
    cand_all = torch.stack(
        [sl_all, sa_all, win_end, plen_ex, pamb_ex, pend_all, aend_all], dim=-1
    ).transpose(0, 1).contiguous()
    return sd, cand_all, min_score.contiguous()


def _soc_finish(sd, n, soc_start, soc_end, soc_len, soc_amb, soc_valid,
                n_socs, overflow, rectangular, S):
    """Rectangular re-collection + best-first heap order."""
    if rectangular:
        # every SoC becomes all seeds within its reference span, re-sorted
        # by reference position (soc.h rectangularSoC)
        idx = torch.arange(S, device=sd.ref_start.device)[None, None, :]
        in_win = (idx >= soc_start[:, :, None]) & (idx < soc_end[:, :, None])
        refs = sd.ref_start[:, None, :]
        ref_min = torch.where(in_win, refs, torch.full_like(refs, INT_MAX)).amin(2)
        ref_max = torch.where(in_win, refs, torch.full_like(refs, -1)).amax(2)
        ref_key = torch.where(sd.valid, sd.ref_start, torch.full_like(sd.ref_start, INT_MAX))
        sd = _sort_seeds_by(sd, ref_key)
        ref_sorted = torch.where(sd.valid, sd.ref_start, torch.full_like(sd.ref_start, INT_MAX))
        soc_start = searchsorted_rows(ref_sorted, ref_min, side="left")
        soc_end = torch.minimum(searchsorted_rows(ref_sorted, ref_max, side="right"),
                                n[:, None])
        zero = torch.zeros_like(sd.length)
        plen2 = torch.cumsum(torch.where(sd.valid, sd.length, zero), 1, dtype=torch.int32)
        pamb2 = torch.cumsum(torch.where(sd.valid, sd.ambiguity, zero), 1, dtype=torch.int32)
        lidx = torch.clamp(soc_start, 0, S - 1)
        ridx = torch.clamp(soc_end - 1, 0, S - 1)
        nonempty = soc_end > soc_start
        zk = torch.zeros_like(soc_start)
        soc_len = torch.where(
            nonempty, sel_minor(plen2, ridx) - sel_minor(_exclusive(plen2), lidx), zk
        )
        soc_amb = torch.where(
            nonempty, sel_minor(pamb2, ridx) - sel_minor(_exclusive(pamb2), lidx), zk
        )

    # ---- heap order: best score first (len desc, amb asc, index asc)
    sort_len = torch.where(soc_valid, soc_len, torch.full_like(soc_len, -1))
    sort_amb = torch.where(soc_valid, soc_amb, torch.full_like(soc_amb, INT_MAX))
    _, (o_start, o_end, o_len, o_amb) = sort_with_payloads(
        [-sort_len, sort_amb], [soc_start, soc_end, soc_len, soc_amb]
    )
    return SoCBatch(seeds=sd, start=o_start, end=o_end, score=o_len, amb=o_amb,
                    n_socs=n_socs, overflow=overflow)
