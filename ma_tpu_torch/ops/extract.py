"""Seed batch container, the SoC delta value and FMD segment -> seed
extraction (port of ma_tpu/ops/extract.py).

`extract_seeds` turns every BWT row of a segment's SA interval into one seed
through the sampled-SA walk; over-ambiguous segments are subsampled with
stride size // max_ambiguity (or skipped), reverse-strand hits are mirrored
to forward coordinates, and each read keeps at most `max_seeds` seeds, laid
out by a prefix sum over the per-segment counts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ma_tpu_torch.ops.occ import FMDDev, sa_lookup

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


def extract_seeds(fmd: FMDDev, segs, qlen: torch.Tensor, contig_starts: torch.Tensor,
                  max_seeds: int = 512, max_ambiguity: int = 100, min_seed_len: int = 16,
                  skip_ambiguous: bool = False, rectangular: bool = True,
                  sa_fn=None) -> SeedBatch:
    """Seeds of a SegmentBatch (ops/seeding.py): [B, max_seeds] per field.
    Output slot k of a read belongs to the first segment whose inclusive
    count prefix exceeds k. `sa_fn` replaces sa_lookup (the row-sharded
    index, parallel/sharded_fmd.py); `fmd` then needs only `.n`."""
    B, S = segs.q_start.shape
    dev = segs.q_start.device
    qlen = qlen.to(torch.int32)
    live = torch.arange(S, device=dev)[None, :] < segs.n_segs[:, None]
    z = segs.sai_size
    # min length: the segment SIZE (seed length - 1) against Minimal Seed Length
    use = live & (segs.q_size >= min_seed_len) & (z > 0)
    over = (z > max_ambiguity) & (max_ambiguity != 0)
    if skip_ambiguous:
        use = use & ~over
        jump = torch.ones_like(z)
    else:
        jump = torch.where(over, torch.clamp(z // max(max_ambiguity, 1), min=1), 1)
    cnt = torch.where(use, (z + jump - 1) // jump, 0).to(torch.int32)  # ceil(z / jump)
    cum = torch.cumsum(cnt, 1, dtype=torch.int32)  # inclusive
    total = cum[:, -1]
    overflow = segs.overflow | (total > max_seeds)

    k = torch.arange(max_seeds, dtype=torch.int32, device=dev)[None, :].expand(B, max_seeds)
    seg_of = torch.searchsorted(cum, k.contiguous(), right=True)
    seg_of = torch.clamp(seg_of, max=S - 1)
    take = lambda a: torch.gather(a, 1, seg_of)  # noqa: E731
    j = k - take(cum - cnt)
    valid = (k < total[:, None]) & (j >= 0) & (j < take(cnt))
    rows = take(segs.sai_start) + j * take(jump)
    rows = torch.where(valid, rows, 1)  # row 1 is always a legal BWT row
    pos = (sa_fn or sa_lookup)(fmd, rows)

    half = fmd.n // 2
    on_forw = pos < half
    ref = torch.where(on_forw, pos, fmd.n - pos - 1).to(torch.int32)
    q_start = take(segs.q_start)
    length = take(segs.q_size) + 1  # seed length = segment size + 1
    ambiguity = take(z)
    delta = compute_delta(q_start, length, ref, on_forw, qlen[:, None], contig_starts, half,
                          rectangular)
    zero = torch.zeros((B, max_seeds), dtype=torch.int32, device=dev)
    return SeedBatch(
        q_start=torch.where(valid, q_start, zero),
        length=torch.where(valid, length, zero),
        ref_start=torch.where(valid, ref, zero),
        on_forward=on_forw & valid,
        ambiguity=torch.where(valid, ambiguity, zero),
        delta=torch.where(valid, delta, INT_MAX),  # padding sorts last
        soc_nt=zero,
        valid=valid,
        n_seeds=torch.clamp(total, max=max_seeds).to(torch.int32),
        overflow=overflow,
    )
