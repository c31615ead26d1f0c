"""Genome reconstruction from SV calls — MSV's core lossless-representation
invariant.

A copy of ma_tpu/msv/reconstruct.py, changed only in its imports.

Re-design of the reference reconstruction path
(reference: libs/msv/inc/msv/container/sv_db/tables/svCall.h
callsToSeedsHelper:443-628 + getNextCall:374-435, and
libs/msv/src/container/sv_db/svSchema.cpp
reconstructSequencedGenomeFromSeeds:55-98):

* walk each output contig's ordered call list; between consecutive calls
  copy the reference stretch from the current position to the call's FROM
  breakend (forward or reverse-complement depending on the current strand
  context), then jump to the call's TO breakend, switching context and
  appending any inserted sequence
* a call with `mirrored` set is traversed from its TO side (reversed view)
* the contig remainder after the last call is appended when it is shorter
  than half the reference contig (sanity rule from the reference)

The SQL-order-id-driven fetch becomes a plain ordered list per output
contig — the run/order model is kept, the database is not.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ma_tpu_torch.containers.nucseq import revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.msv.calls import SvCall

# a reconstruction seed: (start_on_donor, size, ref_start, on_forward)
SeedTup = Tuple[int, int, int, bool]


def calls_to_seeds(
    calls_per_contig: Sequence[Sequence[SvCall]],
    pack: Pack,
    with_insertions: bool = True,
) -> List[Tuple[str, List[SeedTup], List[Optional[np.ndarray]]]]:
    """callsToSeedsHelper: ordered calls -> reconstruction seeds.

    calls_per_contig[c] is the traversal path of output contig c, in order
    (the reference stores this order in order_id/ctg_order_id columns).
    """
    out = []
    for ctg_i, path in enumerate(calls_per_contig):
        seeds: List[SeedTup] = []
        insertions: List[Optional[np.ndarray]] = []
        forward_ctx = True
        last_pos = 0
        last_ins = 0

        def q_cursor() -> int:
            if not seeds:
                return last_ins
            q, sz, _, _ = seeds[-1]
            return q + sz + last_ins

        for order, call0 in enumerate(path):
            call = call0.reversed_view() if call0.mirrored else call0
            # jump start: right of the call in forward ctx, left in backward
            jump_from = (
                call.from_pos + call.from_size if call.from_forward else call.from_pos
            )
            # jump end: bottom of the call for forward next ctx, top otherwise
            jump_to = call.to_pos if call.to_forward else call.to_pos + call.to_size

            if order == 0:
                # start at the boundary of the contig the first call sits in
                cid = int(pack.seq_id_for_position(jump_from))
                forward_ctx = call.from_forward
                if forward_ctx:
                    last_pos = int(pack.starts[cid])
                else:
                    last_pos = int(pack.starts[cid] + pack.lengths[cid]) - 1

            if forward_ctx and last_pos <= jump_from and not pack.bridging(
                last_pos, jump_from + 1
            ):
                seeds.append((q_cursor(), jump_from - last_pos + 1, last_pos, True))
            elif not forward_ctx and last_pos >= jump_from and not pack.bridging(
                jump_from, last_pos + 1
            ):
                seeds.append((q_cursor(), last_pos - jump_from + 1, last_pos, False))
            else:  # contradiction: zero-size placeholder keeps insertion order
                seeds.append((q_cursor(), 0, 0, True))
            last_ins = 0

            ins = call.inserted_sequence
            if with_insertions:
                insertions.append(ins if ins is not None and len(ins) else None)
            if ins is not None:
                last_ins = len(ins)

            forward_ctx = call.to_forward
            last_pos = jump_to

        # contig remainder
        if path:
            cid = int(pack.seq_id_for_position(min(last_pos,
                      pack.unpacked_size_forward_plus_reverse - 1)))
            if forward_ctx:
                size = int(pack.starts[cid] + pack.lengths[cid]) - last_pos
            else:
                size = last_pos - int(pack.starts[cid])
            if 0 < size < int(pack.lengths[cid]) / 2:
                seeds.append(
                    (q_cursor(), size, last_pos, forward_ctx)
                )
                if with_insertions:
                    insertions.append(None)
        out.append((f"chr{ctg_i + 1}", seeds, insertions))
    return out


def reconstruct_from_seeds(
    seed_tuples: List[Tuple[str, List[SeedTup], List[Optional[np.ndarray]]]],
    pack: Pack,
) -> Pack:
    """reconstructSequencedGenomeFromSeeds (svSchema.cpp:55-98)."""
    ret = Pack.empty()
    for (name, seeds, insertions) in seed_tuples:
        chrom = []
        for i, (q, size, ref_start, fw) in enumerate(seeds):
            if size > 0:
                if fw:
                    chrom.append(pack.extract(ref_start, ref_start + size))
                else:
                    # reverse seed: ref_start is the LARGEST coordinate
                    seg = pack.extract(ref_start - size + 1, ref_start + 1)
                    chrom.append(revcomp_codes(seg))
            if insertions and i < len(insertions) and insertions[i] is not None:
                chrom.append(np.asarray(insertions[i], np.uint8))
        seq = (
            np.concatenate(chrom).astype(np.uint8)
            if chrom
            else np.zeros(0, np.uint8)
        )
        ret.append(name, seq)
    return ret


def reconstruct_sequenced_genome(
    calls_per_contig: Sequence[Sequence[SvCall]], pack: Pack
) -> Pack:
    """Full pipeline: ordered calls -> donor genome pack."""
    return reconstruct_from_seeds(calls_to_seeds(calls_per_contig, pack), pack)
