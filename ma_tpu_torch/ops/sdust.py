"""Symmetric DUST (SDUST) low-complexity masking, host-side (a copy of
ma_tpu/ops/sdust.py).

Independent implementation of the SDUST algorithm (Morgulis, Gertz,
Schaffer & Agarwala 2006, "A fast and symmetric DUST implementation to
mask low-complexity DNA sequences"), providing the capability of the
reference's vendored masker (reference: libs/minimizerscpp/src/sdust.cpp)
and the minimizer dust filter (reference: libs/minimizerscpp/src/map.cpp
mm_dust_minier:12-44).

Note the reference aligner itself runs with dust DISABLED
(minimizer_index.h:73 sets sdust_thres = 0); this module exists for parity
and for real-genome workloads where repetitive DNA floods the minimizer
index. The score of a window is sum_t c_t*(c_t-1)/2 over its triplet
counts; a "perfect" interval is one whose score/length ratio exceeds T/10
and is not dominated by a higher-ratio subinterval.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

_WLEN = 3  # triplet words
_WTOT = 1 << (2 * _WLEN)


def _save_masked(res: List[List[int]], P: List[list], start: int) -> None:
    """Move perfect intervals that fell out of the window into `res`,
    merging overlapping/adjacent output intervals."""
    if not P or P[-1][0] >= start:
        return
    p = P[-1]
    if res and p[0] <= res[-1][1]:
        res[-1][1] = max(res[-1][1], p[1])
    else:
        res.append([p[0], p[1]])
    while P and P[-1][0] < start:
        P.pop()


def _find_perfect(P: List[list], win: deque, T: int, start: int, L: int,
                  rv: int, cv: List[int]) -> None:
    """Extend the suffix leftwards one triplet at a time; record every
    prefix whose score ratio is >= that of all perfect intervals it
    contains (keeps P sorted by start desc, score-maximal)."""
    c = cv.copy()
    r = rv
    max_r = max_l = 0
    wl = len(win)
    for i in range(wl - L - 1, -1, -1):
        t = win[i]
        r += c[t]
        c[t] += 1
        new_l = wl - i - 1
        if r * 10 > T * new_l:
            j = 0
            while j < len(P) and P[j][0] >= i + start:
                if max_r == 0 or P[j][2] * max_l > max_r * P[j][3]:
                    max_r, max_l = P[j][2], P[j][3]
                j += 1
            if max_r == 0 or r * max_l >= max_r * new_l:
                max_r, max_l = r, new_l
                P.insert(j, [i + start, wl + (_WLEN - 1) + start, r, new_l])


def sdust(codes, T: int = 20, W: int = 64) -> List[Tuple[int, int]]:
    """Low-complexity intervals [(start, end)) of a base-code sequence
    (0..3 = ACGT, >=4 = N; N splits the sequence into independent pieces)."""
    codes = np.asarray(codes)
    n = len(codes)
    res: List[List[int]] = []
    P: List[list] = []
    win: deque = deque()
    cw = [0] * _WTOT
    cv = [0] * _WTOT
    rw = rv = L = 0
    l = t = 0
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & (_WTOT - 1)
            if l >= _WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                _save_masked(res, P, start)
                # slide the triplet window
                if len(win) >= W - _WLEN + 1:
                    s = win.popleft()
                    cw[s] -= 1
                    rw -= cw[s]
                    if L > len(win):
                        L -= 1
                        cv[s] -= 1
                        rv -= cv[s]
                win.append(t)
                L += 1
                rw += cw[t]
                cw[t] += 1
                rv += cv[t]
                cv[t] += 1
                # keep the suffix's per-triplet count bounded (2T/10)
                if cv[t] * 10 > 2 * T:
                    while True:
                        s = win[len(win) - L]
                        cv[s] -= 1
                        rv -= cv[s]
                        L -= 1
                        if s == t:
                            break
                if rw * 10 > L * T:
                    _find_perfect(P, win, T, start, L, rv, cv)
        else:
            # N (or end): flush pending perfect intervals. The reference
            # resets only l/t here, NOT the window/count state (sdust.cpp
            # sdust_core:172-177) — reproduced faithfully, including the
            # resulting possibility of a finish past the piece boundary.
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                _save_masked(res, P, start)
                start += 1
            l = t = 0
    return [(s, e) for s, e in res]


def dust_overlap_ok(q_start: int, length: int,
                    dust: List[Tuple[int, int]]) -> bool:
    """Keep a seed iff at most half its query span falls inside dust
    regions (the mm_dust_minier rule, map.cpp:27-38)."""
    s, e = q_start, q_start + length
    covered = 0
    for ds, de in dust:
        if de <= s:
            continue
        if ds >= e:
            break
        covered += min(e, de) - max(s, ds)
    return covered <= length // 2


def filter_seeds_by_dust(seeds, dust: List[Tuple[int, int]]):
    """Filter an iterable of (q_start, length, ...) seed tuples by the
    dust-overlap rule; returns the surviving subset as a list."""
    return [sd for sd in seeds if dust_overlap_ok(sd[0], sd[1], dust)]


def dust_mask_array(codes, T: int = 20, W: int = 64) -> np.ndarray:
    """Boolean per-base mask (True = low-complexity) — convenient for
    batched device-side masking of query minimizers."""
    m = np.zeros(len(codes), bool)
    for s, e in sdust(codes, T=T, W=W):
        m[s:e] = True
    return m
