"""FMD index sharded by BWT-row range over a group of ranks (port of
ma_tpu/parallel/sharded_fmd.py).

The checkpoint blocks (`bwt_words` / `occ_cp`) and the sampled SA split
into contiguous equal ranges, one a rank. Every lookup is owner-computes:
each rank resolves the query against its slab where the row falls in its
range, contributes zeros elsewhere, and one all_reduce (ma_tpu's psum)
gives every rank the whole answer. So the seeding state machines
(ops/seeding.py) and the seed extraction (ops/extract.py) run replicated
and unchanged on every rank, with the collective lookups passed through
their hooks (`ext_ops`, `occ4_fn`, `sa_fn`).

Every rank runs the same collectives in the same order, and the design
depends on that: the ranks start from the same reads, each step's local
work is a function of the replicated state and the summed lookups, so the
state stays the same on every rank, and so do the host checks that end a
loop (`_run`'s every CHECK_EVERY steps, the SA walk's live lanes every
SA_CHECK_EVERY). A collective a batch: one a state-machine extension (an
SMEM step extends twice), two a step of the SA walk (the BWT character,
then its occ count) and one for the sampled SA.

The index stays int32, as ma_tpu's: row sharding spreads the occ table's
bytes over the ranks; it does not lift the text limit of 2^31.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ma_tpu_torch.index.fmd_index import OCC_INTERVAL, FMDIndex
from ma_tpu_torch.ops.extract import SeedBatch, extract_seeds
from ma_tpu_torch.ops.occ import (
    _block,
    _inclusive_masks,
    _match_bits,
    _popcount32,
    extend_backward,
    init_interval,
    sa_walk,
)
from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding
from ma_tpu_torch.parallel.mesh import RankGroup


class FMDShardDev(NamedTuple):
    """One rank's slab of the row-sharded FMD index on its device. L2,
    primary and n are FMDDev's, so init_interval, extend_backward's interval
    bookkeeping and extract_seeds' strand fold take a slab as it is."""

    bwt_words: torch.Tensor  # int64 [nb_local, 8], uint32 values
    occ_cp: torch.Tensor  # int32 [nb_local, 4]
    ssa: torch.Tensor  # int32 [ns_local]
    L2: torch.Tensor  # int32 [5]
    primary: int
    n: int
    block_lo: int  # first checkpoint block of this slab
    ssa_lo: int  # first sampled-SA slot of this slab

    @classmethod
    def from_shards(cls, shards, rank: int, device) -> "FMDShardDev":
        """Slab `rank` of shard_fmd_index's arrays, on `device`."""
        BW, CP, SS, b_lo, s_lo, rep = shards
        if int(rep["n"]) >= 2**31:
            raise ValueError("int32 device index supports text length < 2^31")
        dev = torch.device(device)
        return cls(
            bwt_words=torch.as_tensor(BW[rank].astype(np.int64), device=dev),
            occ_cp=torch.as_tensor(CP[rank], device=dev),
            ssa=torch.as_tensor(SS[rank], device=dev),
            L2=torch.as_tensor(rep["L2"], device=dev),
            primary=int(rep["primary"]),
            n=int(rep["n"]),
            block_lo=int(b_lo[rank]),
            ssa_lo=int(s_lo[rank]),
        )


def shard_fmd_index(fmd: FMDIndex, n_shards: int):
    """Split occ blocks and sampled SA into contiguous equal ranges
    (host side). Returns stacked per-shard arrays + replicated scalars:
    (bwt_words, occ_cp, ssa, block_lo, ssa_lo, {L2, primary, n})."""
    nb = fmd.bwt_words.shape[0]
    per_b = -(-nb // n_shards)
    BW = np.zeros((n_shards, per_b, 8), np.uint32)
    CP = np.zeros((n_shards, per_b, 4), np.int32)
    ns = len(fmd.ssa)
    per_s = -(-ns // n_shards)
    SS = np.zeros((n_shards, per_s), np.int32)
    b_lo = np.zeros(n_shards, np.int32)
    s_lo = np.zeros(n_shards, np.int32)
    for i in range(n_shards):
        lo, hi = i * per_b, min((i + 1) * per_b, nb)
        BW[i, : hi - lo] = fmd.bwt_words[lo:hi]
        CP[i, : hi - lo] = fmd.occ_cp[lo:hi]
        b_lo[i] = lo
        lo, hi = i * per_s, min((i + 1) * per_s, ns)
        SS[i, : hi - lo] = fmd.ssa[lo:hi]
        s_lo[i] = lo
    rep = dict(
        L2=np.asarray(fmd.L2, np.int32),
        primary=np.int32(fmd.primary),
        n=np.int32(fmd.n),
    )
    return BW, CP, SS, b_lo, s_lo, rep


# ---------------------------------------------------------------- lookups
# Owner-computes + all_reduce forms of ops/occ.py occ4 / occ1 / bwt_char /
# inv_psi / sa_lookup: each rank evaluates against its clipped local slab,
# masks to its row range, and the sum is the whole answer on every rank.


def _local_block(sh: FMDShardDev, b: torch.Tensor):
    nbl = sh.bwt_words.shape[0]
    lb = b - sh.block_lo
    owned = (lb >= 0) & (lb < nbl)
    lbc = torch.clamp(lb, 0, nbl - 1)
    return sh.occ_cp[lbc], sh.bwt_words[lbc], owned


def occ4_sharded(group: RankGroup, sh: FMDShardDev, k: torch.Tensor) -> torch.Tensor:
    """occ4 (counts of A, C, G, T in rows [0..k]; k == -1 -> zeros)."""
    k = k.to(torch.int32)
    b, off = _block(sh, k)
    cp, words, owned = _local_block(sh, b)
    c4 = torch.arange(4, dtype=torch.int64, device=k.device)[:, None]
    z = _match_bits(words[..., None, :], c4) & _inclusive_masks(off)[..., None, :]
    out = cp + _popcount32(z).sum(-1).to(torch.int32)
    out = torch.where(((k >= 0) & owned)[..., None], out, torch.zeros_like(out))
    return group.all_reduce(out)


def occ1_sharded(group: RankGroup, sh: FMDShardDev, k: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """occ4_sharded(group, sh, k)[..., c] for a per-element char c."""
    k = k.to(torch.int32)
    c = c.to(torch.int64)
    b, off = _block(sh, k)
    cp, words, owned = _local_block(sh, b)
    cpc = torch.gather(cp, -1, c[..., None])[..., 0]
    z = _match_bits(words, c[..., None]) & _inclusive_masks(off)
    out = cpc + _popcount32(z).sum(-1).to(torch.int32)
    return group.all_reduce(torch.where((k >= 0) & owned, out, torch.zeros_like(out)))


def bwt_char_sharded(group: RankGroup, sh: FMDShardDev, kk: torch.Tensor) -> torch.Tensor:
    """Stored-BWT code at stored index kk."""
    kk = kk.to(torch.int64)
    _, words, owned = _local_block(sh, kk >> 7)
    word = torch.gather(words, -1, ((kk & (OCC_INTERVAL - 1)) >> 4)[..., None])[..., 0]
    ch = ((word >> (2 * (kk & 15))) & 3).to(torch.int32)
    # a code can be 0, so the owner sends code + 1 and the sum shifts back
    return group.all_reduce(torch.where(owned, ch + 1, torch.zeros_like(ch))) - 1


def inv_psi_sharded(group: RankGroup, sh: FMDShardDev, k: torch.Tensor) -> torch.Tensor:
    """One LF step; row `primary` maps to row 0."""
    k = k.to(torch.int32)
    kk = torch.clamp(k - (k > sh.primary).to(torch.int32), min=0)
    c = torch.clamp(bwt_char_sharded(group, sh, kk), 0, 3)
    res = sh.L2[c.long()] + occ1_sharded(group, sh, k, c)
    return torch.where(k == sh.primary, torch.zeros_like(res), res)


def ssa_sharded(group: RankGroup, sh: FMDShardDev, idx: torch.Tensor) -> torch.Tensor:
    """Sampled SA at slots idx."""
    nsl = sh.ssa.shape[0]
    li = idx.long() - sh.ssa_lo
    owned = (li >= 0) & (li < nsl)
    val = sh.ssa[torch.clamp(li, 0, nsl - 1)]
    return group.all_reduce(torch.where(owned, val, torch.zeros_like(val)))


def sa_lookup_sharded(group: RankGroup, sh: FMDShardDev, k: torch.Tensor) -> torch.Tensor:
    """sa_lookup over the sharded index: the port's SA walk (host checks
    every SA_CHECK_EVERY steps) with collective LF steps and sampled SA."""
    return sa_walk(k, lambda kc: inv_psi_sharded(group, sh, kc),
                   lambda i: ssa_sharded(group, sh, i))


# ---------------------------------------------------------------- seeding


def sharded_fmd_seeding(
    group: RankGroup,
    slab: FMDShardDev,
    seqs,
    lens,
    contig_starts,
    technique: str = "SMEMs",
    max_segs: int = 64,
    max_seeds: int = 512,
    max_ambiguity: int = 100,
    min_seed_len: int = 16,
) -> SeedBatch:
    """Seeding + seed extraction against the row-sharded FMD index:
    `technique` "SMEMs" or "maxSpan". The state machine runs replicated on
    every rank and only the lookups are collective, so the output equals
    the single-device path's exactly, on every rank."""
    dev = group.device
    seqs = torch.as_tensor(seqs, device=dev).to(torch.int32)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    cst = torch.as_tensor(contig_starts, dtype=torch.int32, device=dev)
    seed_fn = {"SMEMs": smem_seeding, "maxSpan": max_spanning_seeding}[technique]
    occ4_fn = lambda f, k: occ4_sharded(group, f, k)  # noqa: E731
    ext_ops = (init_interval,  # touches only L2, which every slab holds
               lambda f, ik, c: extend_backward(f, ik, c, occ4_fn=occ4_fn))
    segs = seed_fn(slab, seqs, lens, max_segs=max_segs, max_ambiguity=max_ambiguity,
                   ext_ops=ext_ops)
    return extract_seeds(slab, segs, lens, cst, max_seeds=max_seeds,
                         max_ambiguity=max_ambiguity, min_seed_len=min_seed_len,
                         sa_fn=lambda f, rows: sa_lookup_sharded(group, f, rows))
