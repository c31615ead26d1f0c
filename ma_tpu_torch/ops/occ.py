"""FMD-index operations on a device (port of ma_tpu/ops/occ.py).

The index is the host `FMDIndex` of index/fmd_index.py (fwd || revcomp text, 2-bit BWT in
128-base blocks of eight 32-bit words, occ checkpoints per block, sampled SA
every 32 rows); `FMDDev.from_host` puts its arrays on a device. All
functions are batched over any shape of `k` / `c` / interval tensors and
return int32.

torch has no uint32 and no popcount: the BWT words are held in int64 (values
below 2^32), so `~` and `>>` never touch a sign bit that matters, and the
occ count within a block is a SWAR popcount of the crumb-match bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ma_tpu_torch.index.fmd_index import OCC_INTERVAL, SA_INTERVAL, FMDIndex

_CRUMB_LO = 0x55555555
_M32 = 0xFFFFFFFF


class FMDDev(NamedTuple):
    """FMD-index arrays on one device."""

    bwt_words: torch.Tensor  # int64 [nb, 8], uint32 values
    occ_cp: torch.Tensor  # int32 [nb, 4]
    L2: torch.Tensor  # int32 [5]
    primary: int
    ssa: torch.Tensor  # int32 [n // 32 + 1]
    n: int  # text length

    @classmethod
    def from_host(cls, fmd: FMDIndex, device) -> "FMDDev":
        if fmd.n >= 2**31:
            raise ValueError("int32 device index supports text length < 2^31")
        dev = torch.device(device)
        as_dev = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
        return cls(
            bwt_words=as_dev(fmd.bwt_words.astype("int64"), torch.int64),
            occ_cp=as_dev(fmd.occ_cp, torch.int32),
            L2=as_dev(fmd.L2, torch.int32),
            primary=int(fmd.primary),
            ssa=as_dev(fmd.ssa, torch.int32),
            n=int(fmd.n),
        )


def _match_bits(words: torch.Tensor, c) -> torch.Tensor:
    """Bit at even position 2j set iff crumb j of the word equals c."""
    y = words ^ (c * _CRUMB_LO)
    return (~y) & ((~y) >> 1) & _CRUMB_LO


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 values below 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _inclusive_masks(off: torch.Tensor) -> torch.Tensor:
    """[..., 8] int64 masks keeping crumbs 0..off (inclusive) of a block."""
    w_idx = torch.arange(8, dtype=torch.int64, device=off.device)
    keep = torch.clamp(off[..., None].to(torch.int64) + 1 - w_idx * 16, 0, 16)
    part = (torch.ones_like(keep) << (2 * torch.clamp(keep, max=15))) - 1
    return torch.where(keep >= 16, torch.full_like(keep, _M32), part)


def _block(fmd: FMDDev, k: torch.Tensor):
    """$-adjusted stored index of BWT row k -> (block, offset in block)."""
    kk = torch.clamp(k - (k >= fmd.primary).to(torch.int32), min=0)
    return (kk >> 7).long(), kk & (OCC_INTERVAL - 1)


def occ4(fmd: FMDDev, k: torch.Tensor) -> torch.Tensor:
    """Counts of A,C,G,T in BWT rows [0..k] inclusive; k == -1 -> zeros.
    Returns int32 [..., 4]."""
    k = k.to(torch.int32)
    b, off = _block(fmd, k)
    words = fmd.bwt_words[b]  # [..., 8]
    c4 = torch.arange(4, dtype=torch.int64, device=k.device)[:, None]
    z = _match_bits(words[..., None, :], c4) & _inclusive_masks(off)[..., None, :]
    out = fmd.occ_cp[b] + _popcount32(z).sum(-1).to(torch.int32)
    return torch.where((k >= 0)[..., None], out, torch.zeros_like(out))


def occ1(fmd: FMDDev, k: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """occ4(fmd, k)[..., c] for a per-element char c."""
    k = k.to(torch.int32)
    c = c.to(torch.int64)
    b, off = _block(fmd, k)
    cp = torch.gather(fmd.occ_cp[b], -1, c[..., None])[..., 0]
    z = _match_bits(fmd.bwt_words[b], c[..., None]) & _inclusive_masks(off)
    out = cp + _popcount32(z).sum(-1).to(torch.int32)
    return torch.where(k >= 0, out, torch.zeros_like(out))


def bwt_char(fmd: FMDDev, kk: torch.Tensor) -> torch.Tensor:
    """Stored-BWT code at stored index kk (the caller adjusts for $)."""
    kk = kk.to(torch.int64)
    word = fmd.bwt_words[kk >> 7, (kk & (OCC_INTERVAL - 1)) >> 4]
    return ((word >> (2 * (kk & 15))) & 3).to(torch.int32)


class SAI(NamedTuple):
    """Batched bidirectional SA interval."""

    start: torch.Tensor  # int32
    start_rc: torch.Tensor  # int32, start of the reverse-complement interval
    size: torch.Tensor  # int32

    def rev_comp(self) -> "SAI":
        return SAI(self.start_rc, self.start, self.size)


def sai_where(cond: torch.Tensor, a: SAI, b: SAI) -> SAI:
    return SAI(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def init_interval(fmd: FMDDev, c: torch.Tensor) -> SAI:
    """Interval of the single char c; c >= 4 gives the empty interval."""
    c = c.to(torch.int32)
    cc = torch.clamp(c, 0, 3).long()
    valid = c < 4
    z = torch.zeros_like(c)
    return SAI(
        start=torch.where(valid, fmd.L2[cc] + 1, z),
        start_rc=torch.where(valid, fmd.L2[3 - cc] + 1, z),
        size=torch.where(valid, fmd.L2[cc + 1] - fmd.L2[cc], z),
    )


def extend_backward(fmd: FMDDev, ik: SAI, c: torch.Tensor, occ4_fn=None) -> SAI:
    """Backward extension by char c, updating the revcomp interval. Where
    c >= 4 or ik.size <= 0 the result is the empty interval. `occ4_fn`
    replaces the occ lookup (the row-sharded index, parallel/sharded_fmd.py);
    `fmd` then needs only `.primary` and `.L2`."""
    c = c.to(torch.int32)
    # both occ lookups in one batched call: one occ4_fn call an extension
    cnt = (occ4_fn or occ4)(fmd, torch.stack([ik.start - 1, ik.start + ik.size - 1], -1))
    cntk, cntl = cnt[..., 0, :], cnt[..., 1, :]
    cnts = cntl - cntk  # [..., 4]
    straddles = (ik.start <= fmd.primary) & (ik.start + ik.size > fmd.primary)
    base = ik.start_rc + straddles.to(torch.int32)
    # cntk2[i] = base + sum_{j<i} cnts[complement(j)]; complement(j) = 3 - j
    cum = torch.cumsum(cnts.flip(-1), -1, dtype=torch.int32)
    cntk2 = base[..., None] + torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], -1)
    cc = torch.clamp(c, 0, 3).long()
    take = lambda a: torch.gather(a, -1, cc[..., None])[..., 0]  # noqa: E731
    valid = (c < 4) & (ik.size > 0)
    z = torch.zeros_like(c)
    return SAI(
        torch.where(valid, fmd.L2[cc] + take(cntk) + 1, z),
        torch.where(valid, take(cntk2.flip(-1)), z),  # cntk2[complement(c)]
        torch.where(valid, take(cnts), z),
    )


def inv_psi(fmd: FMDDev, k: torch.Tensor) -> torch.Tensor:
    """One LF step; row `primary` maps to row 0."""
    k = k.to(torch.int32)
    kk = torch.clamp(k - (k > fmd.primary).to(torch.int32), min=0)
    c = bwt_char(fmd, kk)
    res = fmd.L2[c.long()] + occ1(fmd, k, c)
    return torch.where(k == fmd.primary, torch.zeros_like(res), res)


SA_CHECK_EVERY = 8  # LF steps between two host checks of the live lanes


def sa_lookup(fmd: FMDDev, k: torch.Tensor) -> torch.Tensor:
    """Text positions of BWT rows k: LF steps up to a sampled row."""
    return sa_walk(k, lambda kc: inv_psi(fmd, kc), lambda i: fmd.ssa[i.long()])


def sa_walk(k: torch.Tensor, lf, sampled) -> torch.Tensor:
    """The sampled-SA walk of rows k: `lf(rows)` is one LF step, `sampled(i)`
    the sampled SA at slots i (sa_lookup's, or the row-sharded index's
    collective forms).

    The SA is sampled by ROW (every SA_INTERVAL-th row), so a walk has no
    fixed bound: each step lands on a sampled row with probability ~1/32,
    and the longest of a batch's walks runs to hundreds of steps. ma_tpu's
    while_loop runs until every lane is on a sampled row, and a lane there
    stays put. Here the lanes step SA_CHECK_EVERY times between host checks,
    and each check keeps only the lanes still walking, so the result is
    ma_tpu's exactly and the work shrinks with the live lanes."""
    k = k.to(torch.int32)
    shape = k.shape
    k = k.reshape(-1).clone()
    steps = torch.zeros_like(k)
    idx = torch.arange(k.numel(), device=k.device)
    kc, sc = k, steps
    while True:
        for _ in range(SA_CHECK_EVERY):
            active = (kc & (SA_INTERVAL - 1)) != 0
            kc = torch.where(active, lf(kc), kc)
            sc = sc + active.to(torch.int32)
        k[idx] = kc
        steps[idx] = sc
        live = torch.nonzero((kc & (SA_INTERVAL - 1)) != 0).flatten()
        if live.numel() == 0:
            break
        idx, kc, sc = idx[live], kc[live], sc[live]
    return (steps + sampled(k >> 5)).reshape(shape)
