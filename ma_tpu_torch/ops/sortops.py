"""Sorted-array primitives (port of ma_tpu/ops/sortops.py).

The JAX versions express every rank and gather through variadic sorts,
because minor-axis gathers are slow on a TPU. On a GPU a gather is cheap, so
the same contracts are met directly: `torch.sort(stable=True)` plus gathers,
and `torch.searchsorted`. Results are identical integer for integer.
"""
from __future__ import annotations

from typing import Sequence

import torch


def sort_with_payloads(keys: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable ascending sort along the last axis by `keys` (major first),
    carrying `payloads`. Returns (sorted keys, sorted payloads) as lists.

    A lexicographic stable sort is a chain of stable sorts from the minor key
    to the major one (the same order jax.lax.sort(..., is_stable=True)
    gives)."""
    keys = list(keys)
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else torch.gather(k, -1, perm)
        if kk.dtype == torch.bool:
            kk = kk.to(torch.int32)
        _, idx = torch.sort(kk, dim=-1, stable=True)
        perm = idx if perm is None else torch.gather(perm, -1, idx)
    out_k = [torch.gather(k, -1, perm) for k in keys]
    out_p = [torch.gather(p, -1, perm) for p in payloads]
    return out_k, out_p


def sel_minor(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[..., idx[..., k]]; arr [..., P], idx [..., K] -> [..., K]."""
    lead = torch.broadcast_shapes(arr.shape[:-1], idx.shape[:-1])
    arr = arr.expand(*lead, arr.shape[-1])
    idx = idx.expand(*lead, idx.shape[-1])
    return torch.gather(arr, -1, idx.long())


def searchsorted_rows(values: torch.Tensor, queries: torch.Tensor,
                      side: str = "right") -> torch.Tensor:
    """Row-wise searchsorted of integer queries in rows sorted ascending."""
    return torch.searchsorted(
        values.contiguous(), queries.contiguous(), right=(side == "right")
    ).to(torch.int32)


def merge_rank(values: torch.Tensor, queries: torch.Tensor,
               carries: Sequence[torch.Tensor] = ()):
    """rank[b, m] = number of values[b, :] <= queries[b, m] (searchsorted,
    side='right'), plus for each carry c the value c[b, rank-1] (0 where
    rank == 0)."""
    rank = searchsorted_rows(values, queries, "right")
    prev = (rank.long() - 1).clamp(min=0)
    first = rank == 0

    def fill(c):
        v = torch.gather(c, -1, prev)
        return torch.where(first, torch.zeros_like(v), v)

    return rank, [fill(c) for c in carries]


def run_ends(change: torch.Tensor) -> torch.Tensor:
    """For rows partitioned into runs (change[b, i] True iff i starts a run),
    run_end[b, i] = end (exclusive) of i's run."""
    B, S = change.shape
    idx = torch.arange(S, dtype=torch.int32, device=change.device)[None, :]
    nxt = torch.cat(
        [change[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=change.device)], 1
    )
    rev = torch.where(nxt, idx + 1, torch.full_like(idx, S + 1)).flip(-1)
    ends = torch.cummin(rev, dim=1).values.flip(-1)
    return torch.clamp(ends, max=S).to(torch.int32)
