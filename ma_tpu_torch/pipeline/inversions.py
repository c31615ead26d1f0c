"""Small-inversion rescue (port of ma_tpu/pipeline/inversions.py, the
reference's SmallInversions module).

* for_all_drop_pos: replay an alignment's run-length ops with a running
  score; between consecutive SEED runs, report the window if the largest
  z-drop inside it reached Z Drop Inversions
* each window: re-align the query stretch against the reverse complement
  of its reference window with a banded global DP (kernel D + the traceback
  kernel on a CUDA device); if the score beats the harmonization minimum,
  append a supplementary alignment on the opposite strand (MAPQ 0)

ma_tpu solves all windows of a batch in one call at the largest window
shape and traces back on the host; here the windows go to the device in
calls whose direction tensors stay within 1 GiB, traced back on the device.
Each window's result does not depend on the padding of its call.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ma_tpu_torch.containers.alignment import (
    DELETION,
    INSERTION,
    MATCH,
    MISMATCH,
    SEED,
    Alignment,
)
from ma_tpu_torch.containers.nucseq import NucSeq
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.ops.dp import DPParams, banded_align_traceback, rle_ops
from ma_tpu_torch.utils import profile

MAX_DIR_BYTES = 2**30  # direction bytes per device call


def for_all_drop_pos(aln: Alignment, match: int, mismatch: int, gap: int, extend: int,
                     zdrop_inv: int) -> List[Tuple[int, int, int, int]]:
    """Z-drop window scan: [(start_q, start_r, end_q, end_r)] windows
    between seeds where the score dropped by >= zdrop_inv."""
    out: List[Tuple[int, int, int, int]] = []
    pos_q = aln.begin_on_query
    pos_r = aln.begin_on_ref
    start_q, start_r = pos_q, pos_r
    max_pos_q, max_pos_r = pos_q, pos_r
    max_score = -(2**62)
    curr = 0
    max_drop = 0
    for op, size in aln.data:
        if op == SEED:
            if max_drop >= zdrop_inv:
                out.append((start_q, start_r, pos_q, pos_r))
            start_q = pos_q + size
            start_r = pos_r + size
            max_drop = 0
            curr = 0
            max_score = -(2**62)
        if op in (SEED, MATCH):
            curr += match * size
            pos_q += size
            pos_r += size
        elif op == MISMATCH:
            curr -= mismatch * size
            pos_q += size
            pos_r += size
        elif op == INSERTION:
            curr -= gap + extend * size
            pos_q += size
        else:
            curr -= gap + extend * size
            pos_r += size
        if curr >= max_score:
            max_score = curr
            max_pos_q, max_pos_r = pos_q, pos_r
        else:
            diff = max(pos_q - max_pos_q, pos_r - max_pos_r)
            max_drop = max(max_drop, max_score - curr - diff * extend)
    return out


def _window_cigars(segs, band: int, params: DPParams, device) -> List[list]:
    """Global cigars of [(query codes, reference codes)] windows, in device
    calls of consecutive windows whose [P, M+N-1, M] direction bytes stay
    within MAX_DIR_BYTES."""
    cigars: List[list] = []
    s = 0
    while s < len(segs):
        e, M, N = s, 1, 1
        while e < len(segs):
            m2, n2 = max(M, len(segs[e][0])), max(N, len(segs[e][1]))
            if e > s and (e + 1 - s) * (m2 + n2 - 1) * m2 > MAX_DIR_BYTES:
                break
            M, N, e = m2, n2, e + 1
        P = e - s
        q = np.full((P, M), 4, np.uint8)
        t = np.full((P, N), 4, np.uint8)
        for k, (qs, ts) in enumerate(segs[s:e]):
            q[k, : len(qs)] = qs
            t[k, : len(ts)] = ts
        as_dev = lambda a: torch.as_tensor(a, device=device)
        profile.host_sync(5)  # the five uploads below
        qlen = np.asarray([len(x[0]) for x in segs[s:e]], np.int32)
        tlen = np.asarray([len(x[1]) for x in segs[s:e]], np.int32)
        ops, n_ops, rem_i, rem_j, *_ = banded_align_traceback(
            as_dev(q), as_dev(t), as_dev(qlen), as_dev(tlen),
            as_dev(np.full(P, band, np.int32)), params, -1, True)
        profile.host_sync()
        meta = torch.stack([n_ops, rem_i, rem_j]).cpu().numpy()
        smax = int(meta[0].max(initial=0))
        profile.host_sync()
        ops = ops[:, :smax].cpu().numpy()
        cigars += [rle_ops(ops[k], int(meta[0, k]), int(meta[1, k]), int(meta[2, k]))
                   for k in range(P)]
        s = e
    return cigars


def small_inversions(alignments_per_read: Sequence[List[Alignment]], reads: Sequence[NucSeq],
                     pack: Pack, *, device, params: DPParams = DPParams(), band: int = 512,
                     zdrop_inv: int = 100, harm_score_min: int = 18,
                     disable_heuristics: bool = False) -> Tuple[int, int]:
    """Append supplementary inversion alignments in place (SmallInversions).
    Returns (windows re-aligned, inversion alignments appended)."""
    windows = []  # (read_idx, parent, startQ, endQ, refRevStart, refRevEnd)
    for ri, alns in enumerate(alignments_per_read):
        for aln in alns:
            for (sq, sr, eq, er) in for_all_drop_pos(aln, params.match, params.mismatch,
                                                     params.gap_open, params.gap_extend,
                                                     zdrop_inv):
                if eq <= sq or er <= sr:
                    continue
                rev_s = int(pack.pos_to_reverse_strand(er))
                rev_e = int(pack.pos_to_reverse_strand(sr))
                if rev_e <= rev_s:
                    continue
                windows.append((ri, aln, sq, eq, rev_s, rev_e))
    if not windows:
        return 0, 0
    segs = [(np.asarray(reads[ri].codes[sq:eq], np.uint8), np.asarray(pack.extract(rs, re_),
                                                                      np.uint8))
            for (ri, _aln, sq, eq, rs, re_) in windows]
    cigars = _window_cigars(segs, band, params, device)
    found = 0

    for (ri, parent, sq, eq, rs, re_), (qseg, tseg), cigar in zip(windows, segs, cigars):
        inv = Alignment(
            begin_on_ref=rs, begin_on_query=sq, match=params.match, mismatch=params.mismatch,
            gap=params.gap_open, extend=params.gap_extend,
        )
        qpos, rpos = 0, 0
        for op, ln in cigar:
            if op == 0:  # M
                for j in range(ln):
                    inv.append(MATCH if qseg[qpos + j] == tseg[rpos + j] else MISMATCH, 1)
                qpos += ln
                rpos += ln
            elif op == 1:
                inv.append(INSERTION, ln)
                qpos += ln
            else:
                inv.append(DELETION, ln)
                rpos += ln
        inv.make_local()
        if disable_heuristics or inv.score() > harm_score_min * params.match:
            inv.supplementary = True
            inv.secondary = False
            inv.stats = parent.stats
            inv.mapping_quality = 0.0
            alignments_per_read[ri].append(inv)
            found += 1
    return len(windows), found
