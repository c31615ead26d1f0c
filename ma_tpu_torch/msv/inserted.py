"""Inserted-sequence recovery for SV calls.

A copy of ma_tpu/msv/inserted.py, changed only in its imports.

The reference stores an inserted_sequence per call (sv_call_table column;
reconstruction consumes it, svCall.h:314-331) but computes it outside this
repository (MSV-EVAL). Here: for every call whose supporting jumps span
more query than reference (a net insertion), the representative supporting
jump's read substring between the breakends becomes the call's inserted
sequence (reverse-complemented for mirrored jumps so it reads in reference
orientation).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ma_tpu_torch.containers.nucseq import revcomp_codes
from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import SvJump


def compute_inserted_sequences(
    calls: Sequence[SvCall],
    jumps: Sequence[SvJump],
    reads: Sequence,
) -> List[SvCall]:
    """Fill call.inserted_sequence in place; returns the calls.

    reads: indexable by SvJump.read_id, each with a `.codes` array.
    """
    by_id: Dict[int, SvJump] = {j.id: j for j in jumps}
    for call in calls:
        support = [
            by_id[i] for i in call.supporting_jump_ids if i in by_id
        ]
        cands = [
            j for j in support
            if j.switch_strand_known()
            and j.query_distance() > j.ref_distance()
        ]
        if not cands:
            continue
        # representative: median insert ratio (robust against outliers)
        cands.sort(key=lambda j: j.insert_ratio())
        j = cands[len(cands) // 2]
        # the read bases between the breakend-adjacent seed ends are exactly
        # what reconstruction must emit between from_pos and to_pos
        # (query_from = first base after seed A, query_to = first base of
        # seed B, svJump.h:330-334)
        codes = np.asarray(reads[j.read_id].codes)
        seg = codes[j.query_from : j.query_to]
        if j.was_mirrored:
            seg = revcomp_codes(seg)
        if len(seg):
            call.inserted_sequence = np.asarray(seg, np.uint8)
            # align the breakends to the representative jump so the
            # inserted sequence and the call are mutually consistent
            # (micro-homology shifts breakends and insertions together)
            call.from_pos = j.from_pos
            call.to_pos = j.to_pos
    return list(calls)
