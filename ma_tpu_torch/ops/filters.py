"""Device seed filters (port of ma_tpu/ops/filters.py): `seed_lump` and
`min_length`."""
from __future__ import annotations

import torch

from ma_tpu_torch.ops.extract import INT_MAX, SeedBatch
from ma_tpu_torch.ops.sortops import sort_with_payloads


def _repack(seeds: SeedBatch, q_start, length, ref_start, on_forward, ambiguity,
            delta, valid) -> SeedBatch:
    zero = torch.zeros_like(q_start)
    return SeedBatch(
        q_start=torch.where(valid, q_start, zero),
        length=torch.where(valid, length, zero),
        ref_start=torch.where(valid, ref_start, zero),
        on_forward=on_forward & valid,
        ambiguity=torch.where(valid, ambiguity, zero),
        delta=torch.where(valid, delta, torch.full_like(delta, INT_MAX)),
        soc_nt=zero,
        valid=valid,
        n_seeds=valid.sum(dim=1, dtype=torch.int32),
        overflow=seeds.overflow,
    )


def _segmented_cummax(seg: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Running max of int32 `vals` that restarts wherever the non-decreasing
    segment id `seg` changes: the cummax of (seg, value) packed in int64."""
    key = (seg.to(torch.int64) << 32) | (vals.to(torch.int64) + 2**31)
    return ((torch.cummax(key, dim=1).values & 0xFFFFFFFF) - 2**31).to(torch.int32)


def seed_lump(seeds: SeedBatch) -> SeedBatch:
    """Merge same-diagonal overlapping seeds (SeedLumping): sort by (strand,
    diagonal delta, q_start); a seed opens a new run when the diagonal
    changes or it starts beyond the running maximum end; runs reduce to
    (first start, max end), kept at the run's last slot."""
    B, S = seeds.q_start.shape
    dev = seeds.q_start.device
    ld = torch.where(
        seeds.on_forward,
        seeds.ref_start - seeds.q_start,
        seeds.ref_start + seeds.q_start,
    )
    fwd = seeds.on_forward.to(torch.int32)
    key_major = torch.where(seeds.valid, 1 - fwd, torch.full_like(fwd, 2))
    (_, sld, sq), (sl, sfw, sam, sva) = sort_with_payloads(
        [key_major, ld, seeds.q_start],
        [seeds.length, seeds.on_forward, seeds.ambiguity, seeds.valid],
    )
    send = sq + sl

    same_group = (
        (sld == torch.roll(sld, 1, 1))
        & (sfw == torch.roll(sfw, 1, 1))
        & sva
        & torch.roll(sva, 1, 1)
    )
    same_group[:, 0] = False
    grp = torch.cumsum((~same_group).to(torch.int32), dim=1)
    pmax_end = _segmented_cummax(grp, send)
    pmax_before = torch.cat(
        [torch.zeros((B, 1), dtype=send.dtype, device=dev), pmax_end[:, :-1]], 1
    )
    new_run = ~same_group | (sq > pmax_before)
    run_id = torch.cumsum(new_run.to(torch.int32), dim=1)

    idx = torch.arange(S, device=dev)[None, :].expand(B, S)
    run_start = torch.cummax(torch.where(new_run, idx, torch.zeros_like(idx)), 1).values
    run_first_q = torch.gather(sq, 1, run_start)
    run_first_amb = torch.gather(sam, 1, run_start)
    run_max_e = _segmented_cummax(run_id, send)
    is_last = torch.cat(
        [run_id[:, 1:] != run_id[:, :-1],
         torch.ones((B, 1), dtype=torch.bool, device=dev)], 1
    )
    valid = is_last & sva
    zero = torch.zeros_like(sq)
    q_start = torch.where(valid, run_first_q, zero)
    length = torch.where(valid, run_max_e - run_first_q, zero)
    ref_start = torch.where(sfw, sld + q_start, sld - q_start)
    return _repack(seeds, q_start, length, ref_start, sfw,
                   torch.where(valid, run_first_amb, zero),
                   torch.where(valid, sld, torch.full_like(sld, INT_MAX)), valid)


def min_length(seeds: SeedBatch, min_len: int) -> SeedBatch:
    """Drop seeds shorter than min_len (MinLength)."""
    valid = seeds.valid & (seeds.length >= min_len)
    return _repack(seeds, seeds.q_start, seeds.length, seeds.ref_start,
                   seeds.on_forward, seeds.ambiguity, seeds.delta, valid)
