"""Minimizer index sharded by hash range over a group of ranks (port of
ma_tpu/parallel/sharded_index.py).

The hash-sorted minimizer arrays split into equal contiguous ranges, one a
rank. Every rank looks the whole batch up in its own shard (a hash outside
its range finds nothing) and the per-shard seed blocks merge along the seed
axis: a zero [B, world x S] buffer in which each rank fills its own block,
summed by one all_reduce, gives ma_tpu's tiled all_gather on every backend.

Each rank's shard is looked up through the port's CHD perfect hash (one
built over the shard's unique hashes, `MinimizerIndex.to_device`) where
ma_tpu searches the shard's bucket table two-sided; both give the same
(lo, hi) occurrence range for every hash, so the seeds are ma_tpu's slot for
slot. That includes two reference faults the port copies (ROADMAP, Queue
3): the last shard is padded with copies of its last entry, so a read
holding the index's largest hash gets it once more a pad; and shards split
by count, not by hash, so a hash whose occurrences straddle two shards is
filtered against `max_occ` per shard, and one the whole index would drop
can pass.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ma_tpu_torch.index.minimizer import MinimizerIndex, MinimizerIndexDev, minimizer_seeding
from ma_tpu_torch.ops.extract import SeedBatch
from ma_tpu_torch.parallel.mesh import RankGroup


class MinimizerShards(NamedTuple):
    """Host arrays of every shard, [n_shards, per] each (ma_tpu's H, Pp, S;
    its bucket tables, BL / shift / steps, are its search's, which the CHD
    replaces)."""

    k: int
    w: int
    hash: np.ndarray  # uint32
    pos: np.ndarray  # int32
    strand: np.ndarray  # int32


def shard_minimizer_index(mmi: MinimizerIndex, n_shards: int) -> MinimizerShards:
    """Split the sorted arrays into n equal-size contiguous hash ranges,
    padded to a common length (host-side; arrays stay hash-sorted)."""
    n = len(mmi.hash_sorted)
    per = -(-n // n_shards) if n else 1
    H = np.full((n_shards, per), np.uint32(0xFFFFFFFF), np.uint32)
    Pp = np.zeros((n_shards, per), np.int32)
    S = np.zeros((n_shards, per), np.int32)
    for i in range(n_shards):
        lo, hi = i * per, min((i + 1) * per, n)
        if hi > lo:
            H[i, : hi - lo] = mmi.hash_sorted[lo:hi]
            Pp[i, : hi - lo] = mmi.pos[lo:hi]
            S[i, : hi - lo] = mmi.strand[lo:hi]
            # ma_tpu pads the tail with the last real entry (hash, position
            # and strand), which the lookup counts as more occurrences
            if hi - lo < per:
                H[i, hi - lo :] = mmi.hash_sorted[hi - 1]
                Pp[i, hi - lo :] = mmi.pos[hi - 1]
                S[i, hi - lo :] = mmi.strand[hi - 1]
    return MinimizerShards(mmi.k, mmi.w, H, Pp, S)


def shard_to_device(shards: MinimizerShards, rank: int, device) -> MinimizerIndexDev:
    """Shard `rank` on `device`: its CHD lookup over the padded arrays."""
    return MinimizerIndex(shards.k, shards.w, shards.hash[rank], shards.pos[rank],
                          shards.strand[rank]).to_device(device)


def sharded_minimizer_seeding(
    group: RankGroup,
    shard: MinimizerIndexDev,
    seqs,
    lens,
    contig_starts,
    ref_len_forward: int,
    k: int = 15,
    w: int = 10,
    max_occ: int = 50,
    max_seeds_per_shard: int = 256,
) -> SeedBatch:
    """Look the batch up in this rank's shard and merge every rank's seed
    block: a SeedBatch of max_seeds_per_shard x world slots a read, rank r's
    block at slots [r x S, (r + 1) x S), `n_seeds` summed and `overflow`
    OR-ed over the ranks. Every rank gets the whole result."""
    dev = group.device
    sb = minimizer_seeding(
        shard, torch.as_tensor(seqs, device=dev), torch.as_tensor(lens, device=dev),
        torch.as_tensor(contig_starts, dtype=torch.int32, device=dev), ref_len_forward,
        k=k, w=w, max_occ=max_occ, max_seeds=max_seeds_per_shard, rectangular=True,
    )
    B, S = sb.q_start.shape
    W = group.world_size
    planes = (sb.q_start, sb.length, sb.ref_start, sb.on_forward, sb.ambiguity, sb.delta,
              sb.soc_nt, sb.valid)
    # one buffer, one collective: the seed planes, then n_seeds and overflow
    buf = torch.zeros(len(planes) * B * W * S + 2 * B, dtype=torch.int32, device=dev)
    blocks = buf[: len(planes) * B * W * S].view(len(planes), B, W, S)
    blocks[:, :, group.rank] = torch.stack([p.to(torch.int32) for p in planes])
    tail = buf[len(planes) * B * W * S :].view(2, B)
    tail[0] = sb.n_seeds
    tail[1] = sb.overflow.to(torch.int32)
    group.all_reduce(buf)
    out = blocks.reshape(len(planes), B, W * S)
    return SeedBatch(
        q_start=out[0], length=out[1], ref_start=out[2], on_forward=out[3] != 0,
        ambiguity=out[4], delta=out[5], soc_nt=out[6], valid=out[7] != 0,
        n_seeds=tail[0], overflow=tail[1] != 0,
    )
