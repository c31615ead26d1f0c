"""Minimizer index: host build + device lookup (port of ma_tpu/index/minimizer.py).

Sketch semantics follow minimap2 (packed 2k-bit canonical k-mers, symmetric
k-mers skipped, invertible hash, window minima with ties kept). The hash
and the CHD slot function are uint32 arithmetic; torch has no full uint32
support, so they run in int64 and are masked to 32 bits after every
multiply and shift (`_M32`), which gives the uint32 results bit for bit.

The device lookup is the CHD perfect hash only (two gathers per query),
built by `ma_tpu_torch.native.chd`; an index whose CHD table cannot be built
raises instead of falling back to the binary-search tables.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.native import chd as _chd
from ma_tpu_torch.ops.extract import INT_MAX, SeedBatch, compute_delta
from ma_tpu_torch.ops.sortops import sort_with_payloads

_M32 = 0xFFFFFFFF


def _hash_masked(key: torch.Tensor, mask: int) -> torch.Tensor:
    """minimap2 hash64 (sketch.cpp) on the masked domain; int64 in, int64 out."""
    key = ((~key) + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x, c < 2^32 without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _sketch_arrays(codes: torch.Tensor, k: int, w: int):
    """codes [..., L] int (>= 4 is N). Returns (minimizer mask over k-mer
    START positions [..., L] bool, hash [..., L] int64 holding uint32 values,
    strand [..., L] int32, valid k-mer [..., L] bool). Positions i > L-k are
    never selected. Shared by the host build and the device query."""
    L = codes.shape[-1]
    dev = codes.device
    mask = (1 << (2 * k)) - 1
    c = codes.to(torch.int64)
    is_n = c >= 4
    c = torch.where(is_n, torch.zeros_like(c), c)

    def shift(arr, j, fill):
        """arr[..., i + j], padded with `fill` past the end."""
        if j == 0:
            return arr
        pad = torch.full(arr.shape[:-1] + (j,), fill, dtype=arr.dtype, device=dev)
        return torch.cat([arr[..., j:], pad], dim=-1)

    kmer_f = torch.zeros_like(c)
    kmer_r = torch.zeros_like(c)
    any_n = torch.zeros_like(is_n)
    for j in range(k):
        cj = shift(c, j, 0)
        kmer_f = ((kmer_f << 2) | cj) & mask
        # reverse complement: base j of the forward k-mer lands at k-1-j
        kmer_r = kmer_r | ((3 ^ cj) << (2 * j))
        any_n = any_n | shift(is_n, j, True)
    kmer_r = kmer_r & mask
    valid = ~any_n
    rev_less = kmer_r < kmer_f
    strand = rev_less.to(torch.int32)
    canon = torch.where(rev_less, kmer_r, kmer_f)
    valid = valid & (kmer_f != kmer_r)
    h = _hash_masked(canon, mask)
    h_key = torch.where(valid, h, torch.full_like(h, _M32))

    # window minima: i is a minimizer iff some window covering i attains
    # its minimum at i (ties kept)
    m = h_key
    for j in range(1, w):
        m = torch.minimum(m, shift(h_key, j, _M32))
    sel = torch.zeros_like(valid)
    for j in range(w):
        if j == 0:
            mj = m
        else:
            pad = torch.full(m.shape[:-1] + (j,), _M32, dtype=m.dtype, device=dev)
            mj = torch.cat([pad, m[..., :-j]], dim=-1)
        sel = sel | (mj == h_key)
    sel = sel & valid
    sel = sel & (torch.arange(L, device=dev) <= L - k)
    return sel, h, strand, valid


class MinimizerIndexDev(NamedTuple):
    """Device tensors of the CHD lookup. All None/empty for an empty index."""

    pos: torch.Tensor  # int32 [n] global last-base position of the k-mer
    strand: torch.Tensor  # int32 [n] 0 fwd, 1 rev (canonical orientation)
    chd_d: Optional[torch.Tensor]  # int32 [m] displacement per bucket
    chd_table: Optional[torch.Tensor]  # int32 [T, 3] (hash, row_lo, row_hi)
    chd_tlog: int
    chd_mlog: int


def bucketed_searchsorted(idx: MinimizerIndexDev, h: torch.Tensor):
    """(lo, hi) occurrence ranges (int32) for uint32 hash values h (int64)."""
    if idx.chd_table is None:  # empty index: no occurrences anywhere
        z = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
        return z, z
    b = h & ((1 << idx.chd_mlog) - 1)
    d = idx.chd_d[b].to(torch.int64) & _M32
    x = (h ^ ((d * int(_chd.C1)) & _M32)) & _M32
    slot = _mul32(x, int(_chd.C2)) >> (32 - idx.chd_tlog)
    row = idx.chd_table[slot]
    found = (row[..., 0].to(torch.int64) & _M32) == h
    zero = torch.zeros_like(row[..., 1])
    return torch.where(found, row[..., 1], zero), torch.where(found, row[..., 2], zero)


@dataclasses.dataclass
class MinimizerIndex:
    k: int
    w: int
    hash_sorted: np.ndarray  # uint32 [n]
    pos: np.ndarray  # int32 [n]
    strand: np.ndarray  # int32 [n]
    # device forms built so far, by device (the CHD build + upload of a
    # genome-scale index costs seconds; callers reuse it)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, pack: Pack, k: int = 15, w: int = 10) -> "MinimizerIndex":
        hs, ps, ss = [], [], []
        for ci in range(pack.num_contigs):
            codes = pack.contig_codes(ci).astype(np.int32)
            if len(codes) < k + w:
                continue
            sel, h, strand, _ = _sketch_arrays(torch.from_numpy(codes), k, w)
            ii = np.flatnonzero(sel.numpy())
            hs.append(h.numpy()[ii].astype(np.uint32))
            ps.append((ii + k - 1 + int(pack.starts[ci])).astype(np.int32))
            ss.append(strand.numpy()[ii].astype(np.int32))
        if hs:
            h = np.concatenate(hs)
            p = np.concatenate(ps)
            s = np.concatenate(ss)
        else:
            h = np.zeros(0, np.uint32)
            p = np.zeros(0, np.int32)
            s = np.zeros(0, np.int32)
        order = np.argsort(h, kind="stable")
        return cls(k=k, w=w, hash_sorted=h[order], pos=p[order], strand=s[order])

    def to_device(self, device) -> MinimizerIndexDev:
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = self._to_device_uncached(device)
        return self._dev[key]

    def _to_device_uncached(self, device) -> MinimizerIndexDev:
        n = len(self.hash_sorted)
        pos = torch.as_tensor(self.pos, dtype=torch.int32, device=device)
        strand = torch.as_tensor(self.strand, dtype=torch.int32, device=device)
        if n == 0:
            return MinimizerIndexDev(pos, strand, None, None, 0, 0)
        # deduplicate: the CHD table maps each unique hash to its row range
        new = np.empty(n, bool)
        new[0] = True
        np.not_equal(self.hash_sorted[1:], self.hash_sorted[:-1], out=new[1:])
        hu = self.hash_sorted[new]
        uoff = np.append(np.flatnonzero(new).astype(np.int32), np.int32(n))
        built = _chd.build(hu, uoff)
        if built is None:
            raise RuntimeError("CHD perfect hash could not be built for this index")
        D, tbl, tlog, mlog = built
        return MinimizerIndexDev(
            pos=pos,
            strand=strand,
            chd_d=torch.as_tensor(D, device=device),
            chd_table=torch.as_tensor(tbl, device=device),
            chd_tlog=int(tlog),
            chd_mlog=int(mlog),
        )

    # ------------------------------------------------------------------- I/O
    def store(self, prefix: str) -> None:
        np.savez_compressed(
            prefix + ".mmi.npz", k=np.int64(self.k), w=np.int64(self.w),
            hash_sorted=self.hash_sorted, pos=self.pos, strand=self.strand,
        )

    @classmethod
    def load(cls, prefix: str) -> "MinimizerIndex":
        z = np.load(prefix + ".mmi.npz")
        return cls(k=int(z["k"]), w=int(z["w"]), hash_sorted=z["hash_sorted"],
                   pos=z["pos"], strand=z["strand"])

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(prefix + ".mmi.npz")


def minimizer_seeding(
    idx: MinimizerIndexDev,
    seqs: torch.Tensor,  # [B, L] codes
    lens: torch.Tensor,  # int32 [B]
    contig_starts: torch.Tensor,  # int32 [C]
    ref_len_forward: int,
    k: int = 15,
    w: int = 10,
    max_occ: int = 50,
    max_seeds: int = 1024,
    rectangular: bool = True,
) -> SeedBatch:
    """Batched minimizer lookup -> SeedBatch (MinimizerSeeding + seed_one)."""
    dev = seqs.device
    seqs = seqs.to(torch.int32)
    B, L = seqs.shape
    lens = lens.to(torch.int32)
    sel, h, strand_q, _ = _sketch_arrays(seqs, k, w)
    sel = sel & (torch.arange(L, device=dev)[None, :] + k <= lens[:, None])
    qpos = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(B, L)

    # compact the ~2L/(w+1) selected lanes to a [B, Mc] prefix; rows with
    # more selected minimizers than Mc keep a bit-reversed-spread subset and
    # are flagged (same lane order and truncation as the JAX version)
    exp = 2 * (L - k + 1) // (w + 1) + 1
    Mc = 32
    while Mc < min(2 * exp, L):
        Mc *= 2
    if Mc < L:
        n_sel = sel.sum(dim=1, dtype=torch.int32)
        bits = max(1, int(L - 1).bit_length())
        rev = torch.zeros_like(qpos)
        for b in range(bits):
            rev = (rev << 1) | ((qpos >> b) & 1)
        key_pos = torch.where((n_sel > Mc)[:, None], rev, qpos)
        colkey = torch.where(sel, key_pos, torch.full_like(key_pos, 1 << bits))
        _, (h, strand_q, qpos, sel) = sort_with_payloads(
            [colkey], [h, strand_q, qpos, sel]
        )
        h = h[:, :Mc]
        strand_q = strand_q[:, :Mc]
        qpos = qpos[:, :Mc]
        sel = sel[:, :Mc] & (torch.arange(Mc, device=dev)[None, :] < n_sel[:, None])

    lo, hi = bucketed_searchsorted(idx, h)
    occ = torch.where(sel, hi - lo, torch.zeros_like(lo))
    occ = torch.where(occ > max_occ, torch.zeros_like(occ), occ)

    # slot allocation: output slot s belongs to the first k-mer lane whose
    # inclusive occurrence cumsum exceeds s
    cum = torch.cumsum(occ, dim=1, dtype=torch.int32)
    total = cum[:, -1]
    overflow = total > max_seeds
    if Mc < L:
        overflow = overflow | (n_sel > Mc)
    W = cum.shape[1]
    kk = torch.arange(max_seeds, dtype=torch.int32, device=dev)[None, :]
    rank = torch.searchsorted(cum, kk.expand(B, max_seeds).contiguous(), right=True)
    own = rank.clamp(max=W - 1)
    cum_ex_at = torch.where(
        rank == 0, torch.zeros_like(kk), torch.gather(cum, 1, (rank - 1).clamp(min=0))
    )
    lo_at = torch.gather(lo, 1, own)
    occ_at = torch.gather(occ, 1, own)
    qstrand = torch.gather(strand_q, 1, own)
    pos_of = torch.gather(qpos, 1, own)
    j = kk - cum_ex_at
    valid = kk < total[:, None]

    n_idx = idx.pos.shape[0]
    if n_idx == 0:
        valid = valid & False
        rpos = torch.zeros_like(lo_at)
        rstrand = torch.zeros_like(lo_at)
    else:
        rows = torch.clamp(lo_at + j, 0, n_idx - 1).long()
        rpos = idx.pos[rows]
        rstrand = idx.strand[rows]
    same = rstrand == qstrand

    # plain read coordinates on both strands: for a reverse hit read[q+j]
    # matches 3 - genome[ref_start - j], ref_start = the k-mer's LAST base
    q_start = pos_of
    ref_start = torch.where(same, rpos - (k - 1), rpos)
    length = torch.full((B, max_seeds), k, dtype=torch.int32, device=dev)
    delta = compute_delta(q_start, length, ref_start, same, lens[:, None],
                          contig_starts, ref_len_forward, rectangular)
    zero = torch.zeros((B, max_seeds), dtype=torch.int32, device=dev)
    return SeedBatch(
        q_start=torch.where(valid, q_start, zero),
        length=torch.where(valid, length, zero),
        ref_start=torch.where(valid, ref_start, zero),
        on_forward=same & valid,
        ambiguity=torch.where(valid, occ_at, zero),
        delta=torch.where(valid, delta, torch.full_like(delta, INT_MAX)),
        soc_nt=zero,
        valid=valid,
        n_seeds=torch.clamp(total, max=max_seeds).to(torch.int32),
        overflow=overflow,
    )
