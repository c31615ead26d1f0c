"""Connector-pattern call filter.

A copy of ma_tpu/msv/connector.py, changed in its imports and in the
device: the DP runs on `device` (kernel D on a CUDA device, its plain
version on the CPU).

Re-design of the reference ConnectorPatternFilter
(reference: libs/msv/inc/msv/module/connectorPatternFilter.h:20-155):
a call survives only if its supporting reads connect the two breakends
better (by extension-alignment score of the flanks) than the reference
connects to itself — separating real junctions from reference-induced
artifacts. The SQL read fetch becomes an in-memory read list and ALL
extension problems across every call batch into one device DP call.

Deviation: the reference pairs the read's left flank with the ref window
RIGHT of the to-breakend and the right flank with the window LEFT of the
from-breakend (connectorPatternFilter.h:127-141), which scores ~0 for true
junctions (flanks match the matching-side contexts, not the crossed ones)
— the module is unused by the shipped scripts. Here the flanks pair with
their matching-side contexts (left-vs-left-of-from, right-vs-right-of-to),
which actually discriminates read-supported junctions.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ma_tpu_torch.containers.nucseq import revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import SvJump
from ma_tpu_torch.ops.dp import DPParams, banded_align


def _ref_window(pack: Pack, begin: int, size: int) -> np.ndarray:
    L2 = pack.unpacked_size_forward_plus_reverse
    begin = max(0, min(begin, L2))
    end = max(0, min(begin + size, L2))
    if end <= begin:
        return np.zeros(0, np.uint8)
    return pack.extract(begin, end)


def connector_pattern_filter(
    calls: Sequence[SvCall],
    jumps: Sequence[SvJump],
    reads: Sequence,
    pack: Pack,
    max_ext: int = 100,
    zdrop: int = 200,
    params: DPParams = DPParams(),
    *,
    device,
) -> List[SvCall]:
    by_id = {j.id: j for j in jumps}
    problems = []  # (q codes, t codes)
    call_meta = []  # per call: (ref_problem_ids, [(jump_problem_ids)])

    for call in calls:
        x0 = call.from_pos
        x1 = call.from_pos + max(call.from_size, 1)
        y0 = call.to_pos
        y1 = call.to_pos + max(call.to_size, 1)
        left = _ref_window(pack, x0 - max_ext, min(max_ext, x0))[::-1].copy()
        right = _ref_window(pack, x1, max_ext)
        down = _ref_window(pack, y0 - max_ext, min(max_ext, y0))[::-1].copy()
        up = _ref_window(pack, y1, max_ext)
        if call.from_forward != call.to_forward:
            up, down = down, up
            up = np.where(up < 4, 3 - up, up).astype(np.uint8)
            down = np.where(down < 4, 3 - down, down).astype(np.uint8)
        ref_ids = []
        for (a, b) in ((left, down), (right, up)):
            problems.append((a, b))
            ref_ids.append(len(problems) - 1)
        jump_ids = []
        for jid in call.supporting_jump_ids:
            j = by_id.get(jid)
            if j is None:
                continue
            codes = np.asarray(reads[j.read_id].codes)
            qf, qt = j.query_from, j.query_to
            rl = codes[max(0, qf - max_ext) : qf][::-1].copy()
            rr = codes[qt : qt + max_ext]
            pair = []
            for (a, b) in ((rl, left), (rr, up)):
                problems.append((a, b))
                pair.append(len(problems) - 1)
            jump_ids.append(pair)
        call_meta.append((ref_ids, jump_ids))

    if not problems:
        return list(calls)

    M = max(max((len(a) for a, _ in problems), default=1), 8)
    N = max(max((len(b) for _, b in problems), default=1), 8)
    P = len(problems)
    q = np.full((P, M), 4, np.uint8)
    t = np.full((P, N), 4, np.uint8)
    qlen = np.ones(P, np.int32)
    tlen = np.ones(P, np.int32)
    for i, (a, b) in enumerate(problems):
        q[i, : len(a)] = a
        t[i, : len(b)] = b
        qlen[i] = max(len(a), 1)
        tlen[i] = max(len(b), 1)
    up = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    res = banded_align(
        up(q), up(t), up(qlen), up(tlen),
        torch.full((P,), 100, dtype=torch.int32, device=device), params,
        zdrop=zdrop, is_global=False,
    )
    scores = res.score.cpu().numpy()

    out: List[SvCall] = []
    for call, (ref_ids, jump_ids) in zip(calls, call_meta):
        ref_score = sum(max(int(scores[i]), 0) for i in ref_ids)
        read_score = sum(
            max(int(scores[i]), 0) for pair in jump_ids for i in pair
        )
        n = max(len(jump_ids), 1)
        if read_score // n > ref_score:
            out.append(call)
    return out
