"""Seed batch container and the SoC delta value (port of ma_tpu/ops/extract.py).

Only the parts the minimizer path needs: `SeedBatch` and `compute_delta`
(FMD segment extraction belongs to the FMD seeding slice).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT_MAX = 2**31 - 1


class SeedBatch(NamedTuple):
    """Fixed-shape seed set per read (same fields as ma_tpu's SeedBatch).

    ref_start is in FORWARD strand coordinates; for reverse-strand seeds it is
    the mirrored position (largest coordinate of the match)."""

    q_start: torch.Tensor  # int32 [B, S]
    length: torch.Tensor  # int32 [B, S]
    ref_start: torch.Tensor  # int32 [B, S]
    on_forward: torch.Tensor  # bool [B, S]
    ambiguity: torch.Tensor  # int32 [B, S]
    delta: torch.Tensor  # int32 [B, S] — SoC bucketing value
    soc_nt: torch.Tensor  # int32 [B, S]
    valid: torch.Tensor  # bool [B, S]
    n_seeds: torch.Tensor  # int32 [B]
    overflow: torch.Tensor  # bool [B]


def compute_delta(q_start, length, ref_start, on_forward, qlen, contig_starts,
                  ref_len_forward: int, rectangular: bool) -> torch.Tensor:
    """Delta/bucketing value (getPositionForBucketing + setDeltaOfSeed).
    All int32; qlen broadcasts against the seed planes ([B, 1])."""
    num_contigs = contig_starts.shape[0]
    pos = ref_start
    if not rectangular:
        far = 2 * (ref_len_forward + (qlen + 1) * num_contigs)
        pos = torch.where(on_forward, ref_start, far - (ref_start - length))
    delta = pos + (qlen - q_start)
    contig = (
        torch.searchsorted(contig_starts, ref_start.contiguous(), right=True)
        .to(torch.int32) - 1
    )
    if not rectangular:
        contig = torch.where(on_forward, contig, num_contigs - contig)
    return (delta + (qlen + 1) * contig).to(torch.int32)
