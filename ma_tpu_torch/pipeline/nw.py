"""DP problem state of the native finish path (port of the descriptor-mode
parts of ma_tpu/pipeline/nw.py).

Planning and CIGAR assembly run in C++ (`ma_tpu.pipeline.finish_native`,
shared with ma_tpu); this module keeps the DP configuration, the
descriptor of a DP problem, the per-batch device operands, and the rare
run-overflow redo.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ma_tpu_torch.ops.dp import DPParams, _desc_operands


@dataclasses.dataclass
class DPProblem:
    """Descriptor of one DP problem against the device-resident operands."""

    band: int
    is_global: bool
    read_idx: int = -1
    q_off: int = 0
    q_len: int = 0
    q_rev: int = 0
    t_start: int = 0
    t_len: int = 0
    t_rev: int = 0

    @classmethod
    def from_desc(cls, row, is_global: bool) -> "DPProblem":
        """From a planner descriptor row (read, q_off, q_len, q_rev,
        t_start, t_len, t_rev, band, ...)."""
        return cls(band=int(row[7]), is_global=is_global, read_idx=int(row[0]),
                   q_off=int(row[1]), q_len=int(row[2]), q_rev=int(row[3]),
                   t_start=int(row[4]), t_len=int(row[5]), t_rev=int(row[6]))


class NWConfig:
    def __init__(self, pset=None):
        get = (lambda n: pset.get(n)) if pset is not None else (lambda n: None)
        self.padding = get("Padding") or 1000
        self.band_ext = get("Bandwidth for Extensions") or 512
        self.min_band_gap = get("Minimal Bandwidth in Gaps") or 20
        self.zdrop = get("Z Drop") or 200
        self.max_gap_area = get("Maximal Gap Size") or 20
        self.params = DPParams(
            match=get("Match Score") or 2,
            mismatch=get("Mismatch Penalty") or 4,
            gap_open=get("Gap penalty") or 4,
            gap_extend=get("Extend Penalty") or 2,
            gap_open2=get("Second Gap Penalty") or 24,
            gap_extend2=get("Second Extend Penalty") or 1,
        )
        self.sv_penalty = 100


class NWAligner:
    """Per-batch DP state: the configuration, the device genome text and
    read batch the descriptors point into, and the batch's overflow flags."""

    def __init__(self, config: NWConfig, text_dev: torch.Tensor, seqs_dev: torch.Tensor):
        self.cfg = config
        self.text_dev = text_dev
        self.seqs_dev = seqs_dev
        self.overflow_flags: Optional[np.ndarray] = None

    def redo_one(self, p: DPProblem) -> List[Tuple[int, int]]:
        """Re-run one problem whose runs overflowed the fused kernel's run
        buffer, on the same device and through the same fused DP, with a
        run capacity no path can exceed (R = M + N + 1). Returns its
        forward-order cigar [(op, len)]."""
        from ma_tpu_torch.ops.dp_fused import banded_align_runs

        M, N = max(p.q_len, 1), max(p.t_len, 1)
        desc = torch.tensor(
            [[p.read_idx], [p.q_off], [p.q_len], [p.q_rev], [p.t_start], [p.t_len],
             [p.t_rev], [p.band]], dtype=torch.int32, device=self.seqs_dev.device,
        )
        q, t, q_len, t_len, band = _desc_operands(self.text_dev, self.seqs_dev, desc, M, N)
        runs, meta = banded_align_runs(
            q, t, q_len, t_len, band, M=M, N=N, params=self.cfg.params,
            zdrop=-1 if p.is_global else self.cfg.zdrop, is_global=p.is_global,
            R=M + N + 1,
        )
        runs = runs[0].cpu().numpy()
        meta = meta[:, 0].cpu().numpy()
        if meta[5]:
            raise RuntimeError("DP run buffer overflowed at full capacity")
        return [(int(v) & 3, int(v) >> 2) for v in runs[: int(meta[0])][::-1]]
