"""Peaks of one NVIDIA H100 SXM and the work of kernels C and D.

The peaks are constants, not read from the card, so the yardstick does not
move with a card's clocks: HBM 3.35 TB/s as published; int32 operations
132 SMs x 64 INT32 lanes x 1,980 MHz (the Hopper SM's lanes at its boost
clock) = 16.73 T op/s. The counts are of the work the inputs need,
whatever implements it: a redesign of a kernel does not change them.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, SM_CLOCK_HZ = 132, 64, 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ
# int32 operations one cell of the fused banded DP recurrence needs, one per
# add, max, compare, select or bit op, with row and column constants hoisted
# and no band masks: F1 and F2 4 each, E1 and E2 4 each, score 4, diagonal
# + score 1, H~ 2, source select 12, direction byte 8, row maximum 3
DP_OPS_PER_CELL = 46


def inband_cells(qlen, tlen, band, M: int, N: int) -> int:
    """Cells (i, j) with i < min(m, M), j < min(n, N), |i - j| <= band."""
    m = np.minimum(np.asarray(qlen, np.int64), M)[:, None]
    n = np.minimum(np.asarray(tlen, np.int64), N)[:, None]
    w = np.asarray(band, np.int64)[:, None]
    i = np.arange(M)[None, :]
    lo, hi = np.maximum(0, i - w), np.minimum(n - 1, i + w)
    return int(np.where(i < m, np.clip(hi - lo + 1, 0, None), 0).sum())


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over HBM
    and the int32 operations over the int32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def dp_fused_work(qlen, tlen, band, M: int, N: int, R: int) -> tuple:
    """(bytes, ops) of one launch of kernel C over P problems: the codes
    (int32 [P, M] and [P, N]) and the four int32 lengths a problem in, the
    runs (int32 [P, R]) and the eight-word meta out once; 46 ops an in-band
    cell."""
    P = len(qlen)
    nbytes = 4 * P * (M + N + 4) + 4 * P * (R + 8)
    return nbytes, DP_OPS_PER_CELL * inband_cells(qlen, tlen, band, M, N)


def dp_wavefront_work(qlen, tlen, band, M: int, N: int) -> tuple:
    """(bytes, ops) of one launch of kernel D over P problems: the codes
    (int32 [P, M], one byte [P, N]) and three int32 lengths in; the
    direction bytes of every anti-diagonal ([P, M + N - 1, M]), the
    four-word result and the per-diagonal 64-bit maxima out once; 46 ops an
    in-band cell."""
    P = len(qlen)
    D = M + N - 1
    nbytes = P * (4 * M + N + 12) + P * (D * M + 16 + 8 * D)
    return nbytes, DP_OPS_PER_CELL * inband_cells(qlen, tlen, band, M, N)
