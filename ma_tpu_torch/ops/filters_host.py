"""Host seed filters operating on per-read seed tuple lists.

A copy of ma_tpu/ops/filters_host.py, changed only in its imports.

Re-designs of the remaining reference seed-filter modules
(reference: libs/ma/inc/ma/module/seedFilters.h — FilterToUnique:390,
FilterContigBorder:436, MaxExtendedToSMEM:473, MaxExtendedToMaxSpanning:561,
FilterOverlappingSeeds:655, ParlindromeFilter:1047). These run on the small
per-read seed lists after device extraction; seed tuples are
(q_start, length, ref_start, on_forward, nt) with the reverse-seed
largest-coordinate convention.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ma_tpu_torch.containers.pack import Pack

SeedT = Tuple[int, int, int, bool, int]


def filter_contig_border(
    seeds: Sequence[SeedT], pack: Pack, max_dist: int = 25000
) -> List[SeedT]:
    """Drop seeds within max_dist of a contig border (FilterContigBorder)."""
    out = []
    for s in seeds:
        (q, l, r, fw, nt) = s
        start = r if fw else r - l + 1
        end = (r + l - 1) if fw else r
        cid = int(pack.seq_id_for_position(start))
        if int(pack.seq_id_for_position(end)) != cid:
            continue
        lo = int(pack.starts[cid])
        hi = lo + int(pack.lengths[cid])
        if lo + max_dist >= start:
            continue
        if hi <= end + max_dist:
            continue
        out.append(s)
    return out


def max_extended_to_smem(seeds: Sequence[SeedT]) -> List[SeedT]:
    """Keep only non-enclosed seeds (MaxExtendedToSMEM:473-522): sorted by
    (start asc, size desc, ref), keep when extending past the max end seen."""
    ss = sorted(seeds, key=lambda s: (s[0], -s[1], s[2]))
    out: List[SeedT] = []
    max_end = 0
    for s in ss:
        end = s[0] + s[1]
        if end > max_end:
            out.append(s)
        elif end == max_end and out and s[0] == out[-1][0] and s[2] != out[-1][2]:
            out.append(s)
        max_end = max(max_end, end)
    return out


def max_extended_to_max_spanning(seeds: Sequence[SeedT]) -> List[SeedT]:
    """Keep each query position's longest covering seed
    (MaxExtendedToMaxSpanning:561-650; ties by start then ref)."""
    ss = list(seeds)
    keep = []
    for s in ss:
        (q, l, r, fw, nt) = s
        is_max_somewhere = False
        for p in range(q, q + l):
            best = None
            for o in ss:
                if o[0] <= p < o[0] + o[1]:
                    key = (-o[1], o[0], o[2])
                    if best is None or key < best[0]:
                        best = (key, o)
            if best is not None and best[1] is s:
                is_max_somewhere = True
                break
        if is_max_somewhere:
            keep.append(s)
    return keep


def filter_overlapping_seeds(
    seeds: Sequence[SeedT], min_nt_non_overlap: int = 16
) -> List[SeedT]:
    """Break seeds into their non-overlapping query sections, dropping
    short fragments (FilterOverlappingSeeds:655-740)."""
    ss = sorted(seeds, key=lambda s: (s[0], -s[1]))
    out: List[SeedT] = []
    ui_max = 0
    for i, s in enumerate(ss):
        (q, l, r, fw, nt) = s
        end = q + l
        local_max = max(ui_max, q)
        j = i + 1
        while local_max < end:
            local_end = end
            if j < len(ss) and ss[j][0] < local_end:
                local_end = ss[j][0]
            if local_max + min_nt_non_overlap < local_end or (
                local_max == q and local_end == end
            ):
                ln = local_end - local_max
                rp = r + (local_max - q) if fw else r - (local_max - q)
                out.append((local_max, ln, rp, fw, nt))
            if j < len(ss):
                local_max = max(local_max, ss[j][0] + ss[j][1])
            j += 1
            if j > len(ss):
                break
        ui_max = max(ui_max, end)
    return out


def filter_to_unique(
    seeds: Sequence[SeedT],
    query: np.ndarray,
    ref: np.ndarray,
    num_mismatches_allowed: int = 3,
) -> List[SeedT]:
    """Keep seeds whose sequence occurs nowhere else in `ref` within the
    mismatch budget (FilterToUnique:390-428; quadratic like the reference,
    vectorized over ref windows)."""
    out = []
    query = np.asarray(query)
    ref = np.asarray(ref)
    for s in seeds:
        (q, l, r, fw, nt) = s
        if l <= 0 or len(ref) <= l:
            continue
        pat = query[q : q + l]
        windows = np.lib.stride_tricks.sliding_window_view(ref, l)
        mm = (windows != pat[None, :]).sum(axis=1)
        mm[r if 0 <= r < len(mm) else 0] = l + 1 if 0 <= r < len(mm) else 0
        if not (mm <= num_mismatches_allowed).any():
            out.append(s)
    return out


def _rot_coords(s: SeedT) -> Tuple[int, int, int, int]:
    """Rotated 45-degree coordinates (ParlindromeFilter:1047-1110)."""
    (q, l, r, fw, nt) = s
    sx = r if fw else r - l + 1
    ex = (r + l - 1) if fw else r
    sy, ey = q, q + l - 1
    if fw:
        return (sx + sy, ex + ey, sx - sy, sx - sy)
    return (ex + sy, ex + sy, sx - ey, ex - sy)


def palindrome_filter(seeds: Sequence[SeedT]) -> Tuple[List[SeedT], List[SeedT]]:
    """Drop the shorter seed of forward/reverse pairs that cross in the
    rotated plane — palindromic artifacts (ParlindromeFilter; the reference
    line-sweeps the rotated coords, this is the quadratic equivalent).
    Returns (kept, palindromes)."""
    ss = list(seeds)
    dead = [False] * len(ss)
    for i in range(len(ss)):
        for j in range(i + 1, len(ss)):
            if ss[i][3] == ss[j][3]:
                continue
            ax0, ax1, ay0, ay1 = _rot_coords(ss[i])
            bx0, bx1, by0, by1 = _rot_coords(ss[j])
            if ax0 <= bx1 and bx0 <= ax1 and min(ay0, ay1) <= max(by0, by1) and min(
                by0, by1
            ) <= max(ay0, ay1):
                if ss[i][1] < ss[j][1]:
                    dead[i] = True
                else:
                    dead[j] = True
    kept = [s for s, d in zip(ss, dead) if not d]
    pal = [s for s, d in zip(ss, dead) if d]
    return kept, pal


def filter_seeds_by_area(
    seeds: Sequence[SeedT], start: int, size: int
) -> List[SeedT]:
    """Keep seeds whose reference span intersects [start, start+size)
    (FilterSeedsByArea, filter_seeds_by_area.h:16)."""
    out = []
    for s in seeds:
        (q, l, r, fw, nt) = s
        lo = r if fw else r - l + 1
        hi = (r + l) if fw else r + 1
        if lo < start + size and hi > start:
            out.append(s)
    return out


def pick_local_seed_set(
    seeds: Sequence[SeedT],
    match: int = 2,
    extend: int = 2,
    gap: int = 4,
    sv_penalty: int = 100,
    optimistic: bool = True,
) -> List[SeedT]:
    """Gap-cost-estimation cutting ("Pick Local Seed Set", off by default;
    reference: Harmonization::applyFilters harmonization.cpp:14-135):
    Kadane-style trim of a sorted seed chain to its maximal-scoring run,
    with rectangular gaps costed as one indel + matches."""
    ss = sorted((s for s in seeds if s[1] > 0), key=lambda s: (s[2], s[0]))
    if not ss:
        return []
    score = match * ss[0][1]
    max_score = score
    last_start = 0
    opt_start, opt_end = 0, 0
    for i in range(1, len(ss)):
        score += match * ss[i][1]
        gap_nt = 0
        if ss[i][0] > ss[i - 1][0]:
            gap_nt = ss[i][0] - ss[i - 1][0]
        dr = ss[i][2] - ss[i - 1][2]
        if dr > 0:
            if dr < gap_nt:
                gap_nt -= dr
                if optimistic:
                    score += match * dr
            else:
                if optimistic:
                    score += match * gap_nt
                gap_nt = dr - gap_nt
        cost = gap_nt * extend
        if cost > 0:
            cost += gap
        if sv_penalty and cost > sv_penalty:
            cost = sv_penalty
        if score < cost:
            score = 0
            last_start = i
        else:
            score -= cost
        if score > max_score:
            max_score = score
            opt_start, opt_end = last_start, i
    return list(ss[opt_start : opt_end + 1])


def _adjust_seed(seed: SeedT, lo: int, hi: int):
    """Trim the part of the seed's query interval inside [lo, hi)
    (FilterOverlappingSoCs::adjustSeed, seedFilters.h:740-808). Returns the
    adjusted seed or None when fully removed."""
    (q, l, r, fw, nt) = seed
    end = q + l
    if q >= lo:
        if q < hi:
            if end <= hi:
                return None
            sb = hi - q
            return (q + sb, l - sb, r + sb if fw else r - sb, fw, nt)
        return seed
    if end > lo:
        if end <= hi:
            return (q, l - (end - lo), r, fw, nt)
        return None  # region cuts the seed in half
    return seed


def filter_overlapping_socs(
    socs: List[List[SeedT]],
    min_non_overlap_frac: float = 0.50,
    min_non_overlap_nt: int = 5,
    value_fac: float = 2.0,
    pairwise_overlap: bool = False,
) -> List[List[SeedT]]:
    """Line sweep over SoC query intervals removing overlaps
    (FilterOverlappingSoCs::core, seedFilters.h:876-975): overlapping SoCs
    with unique regions get cut at the overlap center; enclosed SoCs are
    kept only when sufficiently more valuable; mostly-covered SoCs drop."""
    entries = []
    for seeds in socs:
        live = [s for s in seeds if s[1] > 0]
        if not live:
            continue
        q_min = min(s[0] for s in live)
        q_max = max(s[0] + s[1] for s in live)
        entries.append([q_min, q_max, list(live), list(live)])
    entries.sort(key=lambda t: (t[0], -t[1]))

    def value_in_range(lo, hi, entry):
        v = 0
        for (q, l, *_r) in entry[3]:
            if q + l > lo and q < hi:
                v += min(q + l, hi) - max(q, lo)
        return v

    def remove_in_range(lo, hi, entry):
        entry[2] = [
            s2 for s2 in (
                _adjust_seed(s, lo, hi) for s in entry[2]
            ) if s2 is not None and s2[1] > 0
        ]

    cur_max = 0
    for i, ei in enumerate(entries):
        i_start, i_end = ei[0], ei[1]
        pct_i = max(int((i_end - i_start) * min_non_overlap_frac),
                    min_non_overlap_nt)
        uncovered = 0
        local_max = max(cur_max, i_start)
        j = i + 1
        while j < len(entries) and i_end > entries[j][0]:
            ej = entries[j]
            j_start, j_end = ej[0], ej[1]
            if j_start > local_max:
                uncovered += j_start - local_max
            local_max = max(local_max, j_end)
            pct_j = max(int((j_end - j_start) * min_non_overlap_frac),
                        min_non_overlap_nt)
            start_i_unc = i_start + pct_i <= j_start
            end_i_unc = j_end + pct_i <= i_end
            end_j_unc = i_end + pct_j <= j_end
            start_j_unc = j_start + pct_j <= i_start
            if start_i_unc and end_j_unc:
                center = (i_end + j_start) // 2
                remove_in_range(center, i_end, ei)
                remove_in_range(j_start, center, ej)
            elif not end_j_unc and not start_j_unc:
                vi = value_in_range(j_start, j_end, ei)
                vj = value_in_range(j_start, j_end, ej)
                if vj > vi * value_fac:
                    remove_in_range(j_start, j_end, ei)
                else:
                    ej[2] = []
            elif (not start_i_unc and not end_i_unc and not end_j_unc
                  and not start_j_unc and pairwise_overlap):
                lo, hi = max(i_start, j_start), min(i_end, j_end)
                vi = value_in_range(lo, hi, ei)
                vj = value_in_range(lo, hi, ej)
                if vi <= vj * value_fac:
                    ei[2] = []
                if vj <= vi * value_fac:
                    ej[2] = []
            j += 1
        if i_end > local_max:
            uncovered += i_end - local_max
        if uncovered < pct_i and not pairwise_overlap:
            ei[2] = []
        cur_max = max(cur_max, i_end)
    return [e[2] for e in entries if e[2]]
