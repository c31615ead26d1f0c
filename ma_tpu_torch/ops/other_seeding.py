"""Bowtie- and BLASR-style seeding (accuracy-comparison modes).

A copy of ma_tpu/ops/other_seeding.py, changed only in its imports.

Re-design of the reference OtherSeeding module
(reference: libs/ma/src/module/otherSeeding.cpp bowtieExtension:21-48,
doBlasrExtension:50-88): fixed-length k-mer extension at a stride
(bowtie) and per-position maximal backward extension keeping the
one-shorter interval (blasr). Host implementations over the host FMDIndex,
like the MEM comparison mode.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ma_tpu_torch.index.fmd_index import FMDIndex

SAI = Tuple[int, int, int]


def bowtie_seeding(
    fmd: FMDIndex, q: np.ndarray, size: int = 16, step: int = 1
) -> List[Tuple[int, int, SAI]]:
    """Fixed 16-mer forward extensions at every position (bowtieExtension).
    Returns [(q_start, q_size, interval)] with the Segment size convention."""
    q = np.asarray(q)
    comp = lambda c: 3 - c if c < 4 else c
    out = []
    for i in range(0, len(q) - size, step):
        if q[i] >= 4:
            continue
        ik = fmd.init_interval(comp(int(q[i])))
        ok = True
        for i2 in range(1, size + 1):
            c = int(q[i + i2])
            if c >= 4:
                ok = False
                break
            ik = fmd.extend_backward(ik, comp(c))
            if ik[2] == 0:
                ok = False
                break
        if ok and ik[2] > 0:
            out.append((i, size, (ik[1], ik[0], ik[2])))  # revComp
    return out


def blasr_seeding(
    fmd: FMDIndex, q: np.ndarray, min_len: int = 12
) -> List[Tuple[int, int, SAI]]:
    """Per-position maximal backward extension, emitting the interval one
    shorter than maximal (doBlasrExtension)."""
    q = np.asarray(q)
    out = []
    for i in range(len(q)):
        if q[i] >= 4:
            continue
        ik = fmd.init_interval(int(q[i]))
        lk: SAI = (0, 0, 0)
        llk: SAI = (0, 0, 0)
        i2 = 0
        while i2 <= i:
            llk = lk
            lk = ik
            c = int(q[i - i2])
            if c >= 4:
                break
            ik = fmd.extend_backward(ik, c)
            if ik[2] == 0:
                break
            i2 += 1
        if i2 <= min_len:
            continue
        out.append((i - i2 + 1, i2 - 1, llk))
    return out
