"""FMD-index: bi-directional BWT index over forward + reverse-complement text.

TPU-native re-design of the reference FM-index
(reference: libs/ma/inc/ma/container/fMIndex.h:44-996, fMIndex.cpp:21-101):

* text T = forward strand || reverse complement(forward strand), |T| = n = 2L
* suffix array over T$; `primary` = SA row of suffix 0 (the row whose BWT
  char is the sentinel $, which is not stored — fMIndex.h "Adjust k, because
  $ is not in bwt")
* occ counts with checkpoints every OCC_INTERVAL=128 bases (fMIndex.h:33-35)
* sampled suffix array every SA_INTERVAL=32 rows with sa[0] = -1
  (fMIndex.h bwt_cal_sa_step3 / vRestoreSuffixArray)
* bidirectional backward extension carrying the reverse-complement interval
  (fMIndex.cpp extend_backward:21-101, init_interval fMIndex.h:768-775)

Memory layout is designed for TPU gathers rather than BWA file compatibility:
the BWT is kept as 2-bit crumbs in uint32 words grouped in 128-base blocks
[nb, 8], with an int checkpoint table [nb, 4]; occ within a block is a
XOR/popcount trick on the VPU (see ma_tpu_torch/ops/occ.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ma_tpu_torch.containers.nucseq import COMPLEMENT, revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.index.suffix_array import suffix_array

OCC_INTERVAL = 128  # bases per checkpoint block (fMIndex.h OCC_INTERVAL)
WORDS_PER_BLOCK = OCC_INTERVAL // 16  # 16 2-bit crumbs per uint32 word
SA_INTERVAL = 32  # sampled-SA stride (fMIndex.h bwt_cal_sa_step3(32))


def fm_text_from_pack(pack: Pack, seed: int = 42) -> np.ndarray:
    """T = fwd || revcomp(fwd) with N holes replaced by deterministic bases.

    (BWA replaces ambiguous bases with pseudo-random ones for the 2-bit BWT;
    the pack keeps the hole list so downstream stages can filter.)
    """
    fwd = pack.codes.copy()
    ns = fwd >= 4
    if ns.any():
        rng = np.random.default_rng(seed)
        fwd[ns] = rng.integers(0, 4, size=int(ns.sum()), dtype=np.uint8)
    return np.concatenate([fwd, revcomp_codes(fwd)])


_CHUNK_BLOCKS = 1 << 19  # 64 Mbases per chunk keeps temporaries ~O(chunk)


def pack_bwt_words(bwt: np.ndarray) -> np.ndarray:
    """uint8 codes [m] -> uint32 crumb words [nb, WORDS_PER_BLOCK].

    Crumb j of word w holds base index w*16+j (LSB-first within the word).
    Chunked so temporaries stay small at GRCh38 scale (the naive version
    allocates ~16 bytes/char).
    """
    m = bwt.shape[0]
    nb = -(-m // OCC_INTERVAL)
    out = np.empty((nb, WORDS_PER_BLOCK), dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    for b0 in range(0, nb, _CHUNK_BLOCKS):
        b1 = min(b0 + _CHUNK_BLOCKS, nb)
        lo, hi = b0 * OCC_INTERVAL, min(b1 * OCC_INTERVAL, m)
        padded = np.zeros((b1 - b0) * OCC_INTERVAL, dtype=np.uint32)
        padded[: hi - lo] = bwt[lo:hi]
        crumbs = padded.reshape(b1 - b0, WORDS_PER_BLOCK, 16)
        out[b0:b1] = (crumbs << shifts).sum(axis=2, dtype=np.uint32)
    return out


def occ_checkpoints(bwt: np.ndarray) -> np.ndarray:
    """int64 [nb, 4]: counts of each base in bwt[0 : b*OCC_INTERVAL).

    Chunked per-block bincount instead of a full one-hot cumsum (which is
    32 bytes/char — prohibitive past ~100 Mbp)."""
    m = bwt.shape[0]
    nb = -(-m // OCC_INTERVAL)
    per_block = np.zeros((nb, 4), dtype=np.int64)
    for b0 in range(0, nb, _CHUNK_BLOCKS):
        b1 = min(b0 + _CHUNK_BLOCKS, nb)
        lo, hi = b0 * OCC_INTERVAL, min(b1 * OCC_INTERVAL, m)
        chunk = bwt[lo:hi]
        blk = (np.arange(hi - lo) // OCC_INTERVAL).astype(np.int64)
        flat = np.bincount(
            blk * 4 + chunk, minlength=(b1 - b0) * 4
        ).reshape(b1 - b0, 4)
        per_block[b0:b1] = flat
    counts = np.zeros((nb, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=counts[1:])
    return counts


@dataclasses.dataclass
class FMDIndex:
    n: int  # text length (2L), excluding sentinel
    primary: int  # SA row whose BWT char is $
    L2: np.ndarray  # int64 [5]; L2[c] = # chars < c in T; intervals start at L2[c]+1
    bwt_words: np.ndarray  # uint32 [nb, WORDS_PER_BLOCK] 2-bit BWT (without $)
    occ_cp: np.ndarray  # int64 [nb, 4] checkpoint counts
    ssa: np.ndarray  # int64 [n // SA_INTERVAL + 1] sampled SA (ssa[0] = -1)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, pack: Pack) -> "FMDIndex":
        text = fm_text_from_pack(pack)
        return cls.from_text(text)

    # beyond this text length the int64-SA build path (~25 bytes/char with
    # temporaries) outgrows RAM; the packed-40-bit path (~6.5 bytes/char,
    # native/sais40.cpp, bwt_large.cpp role) takes over
    LARGE_TEXT_THRESHOLD = 500_000_000

    @classmethod
    def from_text(cls, text: np.ndarray) -> "FMDIndex":
        """Build from an explicit code text (values 0..3). For the aligner the
        text must be fwd||revcomp (FMD symmetry); tests may pass any text."""
        text = np.asarray(text, dtype=np.uint8)
        n = int(text.shape[0])
        if n >= cls.LARGE_TEXT_THRESHOLD:
            return cls.from_text_large(text)
        sa = suffix_array(text)  # [n+1], sa[.]==0 row is primary
        primary = int(np.nonzero(sa == 0)[0][0])
        # BWT without the $ row
        sa_no0 = np.delete(sa, primary)
        bwt = text[sa_no0 - 1]
        counts = np.bincount(text, minlength=4).astype(np.int64)
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)
        # sampled SA over rows 0, 32, 64, ... (row 0 = $ marker -1)
        n_samples = n // SA_INTERVAL + 1
        ssa = sa[np.arange(n_samples) * SA_INTERVAL].astype(np.int64)
        ssa[0] = -1
        return cls(
            n=n,
            primary=primary,
            L2=L2,
            bwt_words=pack_bwt_words(bwt),
            occ_cp=occ_checkpoints(bwt),
            ssa=ssa,
        )

    @classmethod
    def from_text_large(cls, text: np.ndarray) -> "FMDIndex":
        """Memory-bounded build through the packed-40-bit SA-IS + streaming
        BWT emitter (native/sais40.cpp; role of bwt_large.cpp:1522,1607).
        Field-identical to from_text."""
        from ma_tpu_torch.native.sais import fmd_arrays_large

        text = np.ascontiguousarray(text, dtype=np.uint8)
        n = int(text.shape[0])
        primary, bwt_words, occ_cp, ssa = fmd_arrays_large(
            text, occ_interval=OCC_INTERVAL, sa_interval=SA_INTERVAL
        )
        counts = np.bincount(text, minlength=4).astype(np.int64)
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)
        return cls(
            n=n, primary=primary, L2=L2, bwt_words=bwt_words, occ_cp=occ_cp,
            ssa=ssa,
        )

    # ------------------------------------------------------- host occ queries
    def _bwt_code(self, idx: int) -> int:
        """Stored-BWT char at stored index idx (after $ adjustment)."""
        b, off = divmod(idx, OCC_INTERVAL)
        w, j = divmod(off, 16)
        return int((self.bwt_words[b, w] >> np.uint32(2 * j)) & np.uint32(3))

    def occ4(self, k: int) -> np.ndarray:
        """Counts of A,C,G,T in BWT rows [0..k] inclusive (k may be -1).

        Mirrors bwt_occ4 (fMIndex.h:448-520) including the $ adjustment.
        """
        if k < 0:
            return np.zeros(4, dtype=np.int64)
        k = k - (1 if k >= self.primary else 0)
        b, off = divmod(k, OCC_INTERVAL)
        words = self.bwt_words[b]  # [8] uint32
        # inclusive crumb masks per word
        keep = np.clip(off + 1 - 16 * np.arange(WORDS_PER_BLOCK), 0, 16)
        masks = np.where(
            keep >= 16,
            np.uint32(0xFFFFFFFF),
            (np.uint32(1) << (2 * np.minimum(keep, 15)).astype(np.uint32)) - np.uint32(1),
        ).astype(np.uint32)
        pats = (np.arange(4, dtype=np.uint32) * np.uint32(0x55555555))[:, None]
        y = words[None, :] ^ pats  # [4, 8]
        z = (~y) & ((~y) >> np.uint32(1)) & np.uint32(0x55555555)
        incnt = np.bitwise_count(z & masks[None, :]).sum(axis=1)
        return self.occ_cp[b] + incnt.astype(np.int64)

    # ------------------------------------------------- FMD interval algebra
    def init_interval(self, c: int) -> Tuple[int, int, int]:
        """(start, start_revcomp, size) for single char c (fMIndex.h:768-775)."""
        if c >= 4:
            return (0, 0, 0)
        return (
            int(self.L2[c]) + 1,
            int(self.L2[int(COMPLEMENT[c])]) + 1,
            int(self.L2[c + 1] - self.L2[c]),
        )

    def extend_backward(self, ik: Tuple[int, int, int], c: int) -> Tuple[int, int, int]:
        """Backward extension with char c, updating the revcomp interval.

        Host reference implementation of fMIndex.cpp:21-101 (used by tests;
        the device path lives in ma_tpu_torch/ops/occ.py).
        """
        if c >= 4:
            return (0, 0, 0)
        start, start_rc, size = ik
        cntk = self.occ4(start - 1)
        cntl = self.occ4(start + size - 1)
        cnts = cntl - cntk
        cntk2_0 = start_rc
        # $ adjustment: the sentinel is counted implicitly when the interval
        # straddles the primary row (fMIndex.cpp:72-77)
        if start <= self.primary and start + size > self.primary:
            cntk2_0 += 1
        cntk2 = np.zeros(4, dtype=np.int64)
        cntk2[0] = cntk2_0
        for i in range(1, 4):
            cntk2[i] = cntk2[i - 1] + cnts[int(COMPLEMENT[i - 1])]
        return (
            int(self.L2[c] + cntk[c] + 1),
            int(cntk2[int(COMPLEMENT[c])]),
            int(cnts[c]),
        )

    # ------------------------------------------------------------ SA lookup
    def inv_psi(self, k: int) -> int:
        """One LF step: row of suffix SA[k]-1... i.e. walk one char left."""
        if k == self.primary:
            return 0
        kk = k - (1 if k > self.primary else 0)
        c = self._bwt_code(kk)
        return int(self.L2[c] + self.occ4(k)[c])

    def bwt_sa(self, k: int) -> int:
        """Reference position for BWT row k via the sampled SA
        (fMIndex.h bwt_sa:788-814)."""
        steps = 0
        while k & (SA_INTERVAL - 1):
            steps += 1
            k = self.inv_psi(k)
        return int(steps + self.ssa[k // SA_INTERVAL])

    # ------------------------------------------------------------------- I/O
    def store(self, prefix: str) -> None:
        np.savez_compressed(
            prefix + ".fmd.npz",
            n=np.int64(self.n),
            primary=np.int64(self.primary),
            L2=self.L2,
            bwt_words=self.bwt_words,
            occ_cp=self.occ_cp,
            ssa=self.ssa,
        )

    @classmethod
    def load(cls, prefix: str) -> "FMDIndex":
        z = np.load(prefix + ".fmd.npz")
        return cls(
            n=int(z["n"]),
            primary=int(z["primary"]),
            L2=z["L2"],
            bwt_words=z["bwt_words"],
            occ_cp=z["occ_cp"],
            ssa=z["ssa"],
        )

    @staticmethod
    def exists(prefix: str) -> bool:
        import os

        return os.path.exists(prefix + ".fmd.npz")
