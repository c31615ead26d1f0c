"""SV call container.

A copy of ma_tpu/msv/calls.py, changed only in its imports.

Re-design of the reference SvCall
(reference: libs/msv/inc/msv/container/svJump.h SvCall:389-768): a call is
a rectangle in the (from, to) adjacency matrix plus strand contexts, an
optional inserted sequence, support statistics, and traversal-order fields
used by genome reconstruction (order_id / ctg_order_id / mirrored).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SvCall:
    from_pos: int  # x start (rectangle)
    to_pos: int  # y start
    from_size: int = 0
    to_size: int = 0
    from_forward: bool = True
    to_forward: bool = True
    supp_reads: int = 0
    supp_nt: int = 0
    inserted_sequence: Optional[np.ndarray] = None  # base codes
    reference_ambiguity: int = 1
    supporting_jump_ids: List[int] = dataclasses.field(default_factory=list)
    id: int = -1
    order_id: int = -1
    ctg_order_id: int = -1
    mirrored: bool = False  # traverse this call in reverse during reconstruction

    def score(self) -> float:
        """sv_call_table score = supporting_nt / reference_ambiguity
        (svCall.h score column definition)."""
        return self.supp_nt / max(self.reference_ambiguity, 1)

    def reversed_view(self) -> "SvCall":
        """The call as seen when traversed from its TO side
        (getNextCall's mirrored handling, svCall.h:396-409): positions and
        sizes swap, both contexts negate-and-swap."""
        return dataclasses.replace(
            self,
            from_pos=self.to_pos,
            to_pos=self.from_pos,
            from_size=self.to_size,
            to_size=self.from_size,
            from_forward=not self.to_forward,
            to_forward=not self.from_forward,
            mirrored=False,
        )
