"""Banded 2-piece affine-gap DP: constants, scoring parameters and the
descriptor-mode entry of the fused kernel (port of the parts of
ma_tpu/ops/dp.py the native finish path uses).

Direction byte layout (shared by every DP formulation):
    bits 0..2: source of H (0=diag/match, 1=E1, 2=F1, 3=E2, 4=F2)
    bit 3/4/5/6: E1/F1/E2/F2 continuation (gap extends rather than opens)
E gaps consume the reference (CIGAR 'D'), F gaps the query ('I').
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -(2**30)

SRC_MASK = 0x07
SRC_DIAG, SRC_E1, SRC_F1, SRC_E2, SRC_F2 = 0, 1, 2, 3, 4
CONT_E1, CONT_F1, CONT_E2, CONT_F2 = 0x08, 0x10, 0x20, 0x40

OP_M, OP_I, OP_D = 0, 1, 2
OP_NONE = 255

RUNS_HEAD = 12  # packed runs carried in the first rows of `comb`


class DPParams(NamedTuple):
    match: int = 2
    mismatch: int = 4  # positive penalty
    gap_open: int = 4
    gap_extend: int = 2
    gap_open2: int = 24
    gap_extend2: int = 1


def run_capacity(M: int) -> int:
    """Runs per problem of the fused kernel for query bucket M: 256-base
    problems on noisy reads carry ~2 runs per indel event."""
    return 32 if M <= 64 else 96


def _desc_operands(text: torch.Tensor, seqs: torch.Tensor, desc: torch.Tensor,
                   M: int, N: int):
    """[P, M] query / [P, N] target code windows (int32, 4 = N past the
    lengths) from int32 descriptors [8, P] (read, q_off, q_len, q_rev,
    t_start, t_len, t_rev, band) against the device genome text [T] and read
    batch [B, L]."""
    b, q_off, q_len, q_rev, t_start, t_len, t_rev, band = desc.long()
    L = seqs.shape[1]
    T = text.shape[0]
    dev = seqs.device
    mi = torch.arange(M, device=dev)[None, :]
    qidx = torch.where(q_rev[:, None] == 1, q_off[:, None] + q_len[:, None] - 1 - mi,
                       q_off[:, None] + mi)
    q = seqs.reshape(-1)[b[:, None] * L + qidx.clamp(0, L - 1)]
    q = torch.where(mi < q_len[:, None], q, torch.full_like(q, 4)).to(torch.int32)
    nj = torch.arange(N, device=dev)[None, :]
    tidx = torch.where(t_rev[:, None] == 1, t_start[:, None] + t_len[:, None] - 1 - nj,
                       t_start[:, None] + nj)
    t = text[tidx.clamp(0, T - 1)]
    t = torch.where(nj < t_len[:, None], t, torch.full_like(t, 4)).to(torch.int32)
    return q, t, desc[2], desc[5], desc[7]


def _dp_desc_runs_fused(text, seqs, desc, M: int, N: int, params: DPParams,
                        zdrop: int, is_global: bool, tb_last=None):
    """Descriptor-mode DP through the fused kernel (ops/dp_fused.py):
    forward + traceback on the device; only packed runs + meta leave it.

    Returns (comb [8 + RUNS_HEAD, P] int32, runs_t [R, P] int32): comb rows
    0-7 are the meta (n_runs, score, max_i, max_j, zdropped, run_overflow,
    lastrow_max, lastrow_arg) and rows 8.. the first RUNS_HEAD packed runs
    (op | len << 2, back to front). R = run_capacity(M)."""
    from ma_tpu_torch.ops.dp_fused import banded_align_runs

    q, t, q_len, t_len, band = _desc_operands(text, seqs, desc, M, N)
    runs, meta = banded_align_runs(
        q, t, q_len, t_len, band, M=M, N=N, params=params, zdrop=zdrop,
        is_global=is_global, tb_last=tb_last, R=run_capacity(M),
    )
    runs_t = runs.transpose(0, 1).contiguous()
    return torch.cat([meta, runs_t[:RUNS_HEAD]], 0), runs_t


def packed_runs_to_cigars(runs_t: np.ndarray, n_runs: np.ndarray):
    """Decode packed runs ([R', P] back-to-front, op + 4*len) into
    forward-order cigars; rows with more runs than R' give None."""
    Rp = runs_t.shape[0]
    out = []
    for p in range(len(n_runs)):
        nr = int(n_runs[p])
        if nr > Rp:
            out.append(None)
            continue
        out.append([(int(runs_t[k, p]) & 3, int(runs_t[k, p]) >> 2)
                    for k in range(nr - 1, -1, -1)])
    return out
