"""Suffix-array construction (host).

Covers the role of the reference SA builders: SA-IS (libs/ma/src/container/is.cpp)
and the incremental large-genome builder (libs/ma/src/container/bwt_large.cpp).

Two backends:
* `suffix_array_doubling` — vectorized numpy prefix doubling, O(n log n)
  lexsorts. Always available.
* a native C++ SA-IS (ma_tpu_torch/native/) — faster, used when built; falls back
  to numpy otherwise.
"""
from __future__ import annotations

import numpy as np


def suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """Suffix array of T$ for a code array T (values 0..K).

    Returns int64 [n+1] where entry 0 is the $ suffix (== len(T)).
    The sentinel $ sorts before every other symbol.
    """
    t = np.asarray(codes)
    n = t.shape[0] + 1
    rank = np.zeros(n, dtype=np.int64)
    rank[:-1] = t.astype(np.int64) + 1  # $ -> 0
    k = 1
    order = np.argsort(rank, kind="stable")
    # initial ranks from first character
    r_sorted = rank[order]
    diff = np.ones(n, dtype=np.int64)
    diff[1:] = (r_sorted[1:] != r_sorted[:-1]).astype(np.int64)
    new_rank = np.empty(n, dtype=np.int64)
    new_rank[order] = np.cumsum(diff) - 1
    rank = new_rank
    while rank[order[-1]] != n - 1:
        key2 = np.zeros(n, dtype=np.int64)
        key2[: n - k] = rank[k:] + 1
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        diff = np.ones(n, dtype=np.int64)
        diff[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(np.int64)
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(diff) - 1
        rank = new_rank
        k *= 2
    return order


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of T$ (see suffix_array_doubling). Uses the native SA-IS
    extension when available."""
    try:
        from ma_tpu_torch.native import sais  # type: ignore

        return sais.suffix_array(np.asarray(codes, dtype=np.uint8))
    except Exception:
        return suffix_array_doubling(codes)
