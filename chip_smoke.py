#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ma_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. card: name and power limit, as nvidia-smi reports them;
  2. build: nvcc compiles ma_tpu_torch/csrc/*.cu for sm_90a into
     ma_tpu_torch/_build/;
  3. kernels A, B, C, C': each against its plain PyTorch version on the
     same CUDA inputs at main-path shapes (exact equality), with both times
     (CUDA events) and the bound (below); B sorts and sweeps unsorted dense
     rows at R = 65,536, M = 64 and R = 512, M = 2048, and the short-read
     path's own first sweep of a batch, its plain version being the
     stable sort plus the plain sweep; C' (the DP kernel MA_TPU_DP_V2=1
     selects) also against C at the five fused buckets, both modes, P =
     4096, and against the plain version alone at (256, 4096) extension,
     which C cannot take;
  4. wavefront kernels: kernel D against its plain version at an extension
     bucket (P = 256, M = 1024, N = 4096, band 512, z-drop 200) and a global
     inversion-like bucket (P = 128, M = N = 512, band 512), exact on every
     output, with both times; the traceback kernel against its plain version
     on D's output; the problems that overflowed kernel C's run buffer in
     phase 3 redone through D + traceback on the card and on the CPU (the
     cigars must agree);
  5. short reads: the bench.py workload at E. coli K-12 size (random
     4,641,652 bp genome, 16,384 x 150 bp reads at 1% substitutions, half
     reverse complemented, batch 4096) through
     Aligner(device="cuda").align_to_sam: reads/s (median of 3 passes after a
     warm-up), the launches of kernels A, B, C in those passes (and C's
     launches and problems per (M, N, mode) bucket), and the share
     of reads placed at their simulated position and strand (must be
     >= 99%); then the first 512 reads through the same port on
     device="cpu" must give byte-identical SAM;
  6. FMD seeding: the same workload through Aligner(device="cuda") with the
     Default preset (maxSpan): reads/s (median of 3 passes after a warm-up),
     placement (>= 99%), the launches of A, B, C and the host-clock stages;
     one pass under MA_TPU_DP_V2=1 (C' launches, C does not, SAM identical
     to the C pass); one pass of the Illumina preset (SMEMs, placement >=
     99%); the first 512 reads of both presets on device="cpu" must give
     byte-identical SAM;
  7. long reads: scripts/long_read_bench.py's workload (256 reads of 20 kb
     over a random 10 Mbp genome, 1% substitutions, 2% insertions, 2%
     deletions, odd reads reverse complemented, default_rng(4242)) with a
     200 bp inverted stretch planted in the middle of every fourth read,
     PacBio preset, minimizers, "Detect Small Inversions" on: reads/s and
     Mbases/s (median of 3 passes after a warm-up), placement (primary
     records within 200 bp of the simulated start, must be >= 98%),
     inversion windows and records, host-clock stages, and each kernel's
     launches in those passes (all five must launch); then the first 4 long
     reads on device="cpu" must give byte-identical SAM;
  8. long-read overflow rescue: 5 kb and 10 kb reads across a tandem repeat
     overflow their SoC windows; the rescue's stage sweeps rows of 4,096 and
     8,192 seeds through kernel B, held against its plain version there, and
     each read's primary record must overlap the interval it came from.

The bound of a kernel (`bound_ms`) is the larger of the bytes it must move
(each input read once, each output written once) over the card's memory rate
(3.35 TB/s, the H100 SXM's published HBM3 rate) and its int32 operations
over the int32 peak, 64 lanes per SM x the SMs x the card's maximum SM
clock (nvidia-smi clocks.max.sm); `bound_by` names the larger. The DP
kernels' operations are DP_OPS_PER_CELL per in-band cell of this run's
problems. No single PyTorch call computes any of these kernels' functions,
so `library_ms` is null.

The line before the last is the kernels' JSON record (each kernel's
launches summed over the counted main-path passes of phases 5-7, each read
with the counts set to 0 just before it); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Neither JAX nor any module of the JAX package ma_tpu is imported (checked at
the end).
"""
from __future__ import annotations

import argparse
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PLACE_TOL = 10  # bp between the primary record's POS and the simulated start
GENOME_BP = 4_641_652  # E. coli K-12 MG1655
N_READS, READ_LEN, BATCH = 16_384, 150, 4096  # bench.py's workload
CHECK_READS = 512  # reads cross-checked against the CPU port
PASSES = 3
# scripts/long_read_bench.py 256 20000 10, with a planted inversion
LONG_READS, LONG_LEN, LONG_GENOME_BP, LONG_BATCH = 256, 20_000, 10_000_000, 8192
INV_LEN, INV_EVERY = 200, 4
LONG_PLACE_TOL = 200
LONG_CHECK_READS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT32_LANES_PER_SM = 64
# int32 operations that one in-band cell of ma_tpu_torch/ops/dp_rows.py's
# recurrence needs, one per add, max, compare, select or bit op, with row and
# column constants (gap costs, the N flags of q[i] and t[j]) hoisted and no
# band masks (only in-band cells are counted): F1 and F2 4 each (two
# subtractions, max, the continuation compare); E1 and E2 4 each, the same
# over the left neighbour; score 4 (or of the N flags, equality, two
# selects); diagonal + score 1; H~ 2 (two max); source select 12 (four times
# compare, select, max); direction byte 8 (four selects, four ors); row
# maximum 3 (compare, two selects)
DP_OPS_PER_CELL = 46


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def card_clock_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(res.stdout.strip().splitlines()[0])


class Roof:
    """The card's two rates: HBM bytes/s and int32 operations/s."""

    def __init__(self):
        import torch

        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clock_mhz = card_clock_mhz()
        self.int32_ops_per_s = self.sms * INT32_LANES_PER_SM * self.clock_mhz * 1e6

    def bound(self, nbytes: float, ops: float) -> dict:
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / self.int32_ops_per_s * 1e3
        return dict(bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
                    library_ms=None)


def inband_cells(qlen, tlen, band, M: int, N: int) -> int:
    """Cells (i, j) with i < min(m, M), j < min(n, N), |i - j| <= band."""
    m = np.minimum(np.asarray(qlen, np.int64), M)[:, None]
    n = np.minimum(np.asarray(tlen, np.int64), N)[:, None]
    w = np.asarray(band, np.int64)[:, None]
    i = np.arange(M)[None, :]
    lo, hi = np.maximum(0, i - w), np.minimum(n - 1, i + w)
    return int(np.where(i < m, np.clip(hi - lo + 1, 0, None), 0).sum())


def nbytes(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def simulate(genome_len: int, n_reads: int, read_len: int, seed: int = 1234):
    """The bench.py workload: random genome, reads at 1% substitutions,
    odd reads reverse complemented. Returns (pack, reads, starts)."""
    from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes
    from ma_tpu_torch.containers.pack import Pack

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    pack = Pack.empty()
    pack.append("bench", genome)
    reads, starts = [], []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_len - read_len))
        codes = genome[p : p + read_len].copy()
        for j in np.nonzero(rng.random(read_len) < 0.01)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"r{i}"))
        starts.append(p)
    return pack, reads, np.asarray(starts)


def time_ms(fn, reps: int) -> float:
    """Mean wall time of fn() on the card, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching integer/bool outputs (0 = equal)."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def reset_launches() -> None:
    from ma_tpu_torch import kernels

    for k in kernels.KERNELS:
        k.reset()


def read_launches(ks) -> dict:
    return {k.name: k.launches for k in ks}


def soc_inputs(aligner, reads, dev):
    """Kernel A's operands from the first batch of the slice (minimizer
    seeds -> lumping -> min length -> SoC candidate table)."""
    import torch

    from ma_tpu_torch.index.minimizer import minimizer_seeding
    from ma_tpu_torch.ops.filters import min_length, seed_lump
    from ma_tpu_torch.ops.soc import soc_candidates
    from ma_tpu_torch.pipeline.aligner import DeviceStageConfig, _soc_min_score

    seqs, lens = aligner._pad_batch(reads, len(reads))
    cfg = DeviceStageConfig.from_params(aligner.pset, seqs.shape[1])
    seqs_d = torch.as_tensor(seqs, device=dev)
    lens_d = torch.as_tensor(lens, device=dev)
    L = aligner.pack.unpacked_size_forward_strand
    seeds = minimizer_seeding(aligner.mmi_dev(cfg), seqs_d, lens_d, aligner.contig_starts,
                              L, k=cfg.mm_k, w=cfg.mm_w, max_occ=cfg.max_ambiguity,
                              max_seeds=cfg.max_seeds, rectangular=cfg.rectangular)
    seeds = min_length(seed_lump(seeds), cfg.min_seed_len)
    sd, cand, min_score = soc_candidates(
        seeds, lens_d, aligner.contig_starts, cfg.match, cfg.extend, cfg.gap,
        cfg.fixed_soc_width, cfg.rectangular, _soc_min_score(cfg, lens_d, 2 * L),
    )
    return cand, sd.n_seeds.contiguous(), min_score, cfg.max_socs_collect


def linesweep_inputs(rng, R: int, M: int, dev):
    """Kernel B's operands: R rows of M shadow elements in no order (start,
    end with ties), float32 distances with ties, ~10% invalid."""
    import torch

    starts = rng.integers(0, 150, (R, M))
    ends = starts + rng.integers(15, 60, (R, M))
    dist = (rng.integers(0, 16, (R, M)) * 0.25 + (rng.random((R, M)) < 0.3)
            * rng.random((R, M))).astype(np.float32)
    valid = rng.random((R, M)) > 0.1
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return (t(starts, torch.int32), t(ends, torch.int32), t(dist, torch.float32),
            t(valid, torch.bool))


def linesweep_main_inputs(aligner, reads):
    """Kernel B's operands as the main path gives them: the first sweep of a
    batch of `reads` through the aligner (R = reads x SoCs x strands rows of
    M = 64 seeds, mostly invalid slots)."""
    from ma_tpu_torch.ops import harmonize

    seen, orig = [], harmonize.linesweep

    def spy(*args):
        if not seen:
            seen.append(tuple(a.clone() for a in args))
        return orig(*args)

    harmonize.linesweep = spy
    try:
        aligner.align_to_sam(iter(reads), io.StringIO(), batch_size=len(reads))
    finally:
        harmonize.linesweep = orig
    return seen[0]


def dp_inputs(rng, P: int, M: int, N: int, is_global: bool, dev):
    """Kernel C's operands: P problems of one (M, N) bucket. Targets are
    mutated copies of the queries (3% substitutions, 1% indels, 1% N) with
    random flanks; extension problems use the 512 extension band and flag
    every eighth problem for a last-row traceback."""
    import torch

    q = np.full((P, M), 4, np.int32)
    t = np.full((P, N), 4, np.int32)
    qlen = rng.integers(1, M + 1, P)
    tlen = np.zeros(P, np.int64)
    for p in range(P):
        qs = rng.integers(0, 4, qlen[p])
        qs[rng.random(qlen[p]) < 0.01] = 4
        q[p, : qlen[p]] = qs
        r = rng.random(qlen[p])
        keep = r >= 0.005  # the rest are deleted from the target
        ts = np.where(r < 0.035, rng.integers(0, 4, qlen[p]), qs)[keep]
        ins = np.flatnonzero((r > 0.995)[keep]) + 1
        ts = np.insert(ts, ins, rng.integers(0, 4, len(ins)))  # insertions
        ts = np.concatenate([ts, rng.integers(0, 4, rng.integers(0, N))]).astype(np.int32)
        n = max(1, min(N, len(ts) if not is_global else int(rng.integers(1, N + 1))))
        t[p, : min(n, len(ts))] = ts[:n]
        tlen[p] = n
    band = (np.maximum(20, np.abs(tlen - qlen) + 10) if is_global
            else np.full(P, 512))
    tb_last = np.where(is_global, 0, (np.arange(P) % 8) == 0)
    tt = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)
    return tt(q), tt(t), tt(qlen), tt(tlen), tt(band), tt(tb_last)


def kernel_phase(aligner, reads, dev, records, roof):
    """Kernels A, B, C and C' against their plain versions (C' also against
    C). Returns kernel C's run-overflow problems as host arrays (q, t, qlen,
    tlen, band, is_global) for the redo check of wavefront_phase."""
    import torch

    from ma_tpu_torch.ops.dp import DPParams, run_capacity
    from ma_tpu_torch.ops.dp_fused import (
        banded_align_runs, banded_align_runs_plain, banded_align_runs_v2,
    )
    from ma_tpu_torch.ops.harmonize_cuda import linesweep, linesweep_plain
    from ma_tpu_torch.ops.soc_cuda import soc_sweep, soc_sweep_plain

    rng = np.random.default_rng(7)
    # ---- A: SoC sweep at S = 256, B = 4096, K = 32
    cand, n, min_score, K = soc_inputs(aligner, reads, dev)
    got = soc_sweep(cand, n, min_score, K)
    ref = soc_sweep_plain(cand, n, min_score, K)
    err = max_abs_err(got, ref)
    ms = time_ms(lambda: soc_sweep(cand, n, min_score, K), 10)
    pms = time_ms(lambda: soc_sweep_plain(cand, n, min_score, K), 1)
    bd = roof.bound(nbytes(cand, n, min_score) + nbytes(*got), 0)
    print(f"kernel soc_sweep: cand {tuple(cand.shape)} K={K} max_abs_err={err} "
          f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})", flush=True)
    if err:
        raise AssertionError(f"soc_sweep differs from its plain version: {err}")
    records["soc_sweep"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bd)

    # ---- B: sort + line sweep on dense rows (90% valid) at the short-read
    # path's shape, R = 4096 reads x 8 SoCs x 2 strands, M = 64 (the record,
    # as in earlier runs), and at R = 512, M = 2048 (long reads); then on the
    # short-read path's own first sweep of a batch, whose slots are mostly
    # invalid: there the bound counts the bytes its data needs (every valid
    # flag and output byte, start, end and dist of the valid elements only)
    for case in ((65536, 64), (512, 2048), "main"):
        ops = (linesweep_main_inputs(aligner, reads) if case == "main"
               else linesweep_inputs(rng, *case, dev))
        R, M = ops[0].shape
        n_valid = int(ops[3].sum())
        got = linesweep(*ops)
        err = max_abs_err([got], [linesweep_plain(*ops)])
        ms = time_ms(lambda: linesweep(*ops), 10)
        pms = time_ms(lambda: linesweep_plain(*ops), 1)
        need = (2 * R * M + 12 * n_valid if case == "main" else nbytes(*ops) + nbytes(got))
        bd = roof.bound(need, 0)
        print(f"kernel linesweep ({'main path' if case == 'main' else 'dense'}, "
              f"{n_valid} valid): R={R} M={M} max_abs_err={err} kernel {ms:.4f} ms "
              f"plain {pms:.3f} ms bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), "
              f"{bd['bound_ms'] / ms:.1%} of the bound", flush=True)
        if err:
            raise AssertionError(f"linesweep differs from its plain version (M={M})")
        if case == (65536, 64):
            records["linesweep"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bd)

    # ---- C and C': fused DP at every (M, N) bucket, P = 4096, both modes
    params = DPParams()
    total_err, ms_sum, pms_sum, bound_sum = 0, 0.0, 0.0, 0.0
    v2_err, v2_ms, v2_pms = 0, 0.0, 0.0
    overflowed = []

    def keep_overflows(meta, q, t, ql, tl, bd, is_global, cap=256):
        rows = torch.nonzero(meta[5]).flatten()[:cap]
        if len(rows):
            overflowed.append(tuple(a[rows].cpu().numpy() for a in (q, t, ql, tl, bd))
                              + (is_global,))
        return len(rows)

    for M, N in ((32, 128), (64, 128), (256, 128), (64, 768), (256, 768)):
        for is_global in (True, False):
            q, t, ql, tl, bd, tb = dp_inputs(rng, 4096, M, N, is_global, dev)
            kw = dict(M=M, N=N, params=params, zdrop=-1 if is_global else 200,
                      is_global=is_global, tb_last=tb, R=run_capacity(M))
            got = banded_align_runs(q, t, ql, tl, bd, **kw)
            got2 = banded_align_runs_v2(q, t, ql, tl, bd, **kw)
            ref = banded_align_runs_plain(q, t, ql, tl, bd, **kw)
            err = max_abs_err(got, ref)
            err2 = max_abs_err(got2, ref)
            err_c = max_abs_err(got2, got)
            ms = time_ms(lambda: banded_align_runs(q, t, ql, tl, bd, **kw), 5)
            ms2 = time_ms(lambda: banded_align_runs_v2(q, t, ql, tl, bd, **kw), 5)
            pms = time_ms(lambda: banded_align_runs_plain(q, t, ql, tl, bd, **kw), 1)
            over = int(got[1][5].sum())
            keep_overflows(got[1], q, t, ql, tl, bd, is_global)
            cells = inband_cells(ql.cpu().numpy(), tl.cpu().numpy(), bd.cpu().numpy(), M, N)
            bnd = roof.bound(nbytes(q, t, ql, tl, bd, tb) + nbytes(*got),
                             cells * DP_OPS_PER_CELL)
            print(f"kernel dp_fused: P=4096 M={M} N={N} global={is_global} "
                  f"run_overflows={over} max_abs_err={err} kernel {ms:.3f} ms "
                  f"plain {pms:.3f} ms; {cells} in-band cells, bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                  f"{bnd['bound_ms'] / ms:.1%} of it", flush=True)
            print(f"kernel dp_fused_v2: P=4096 M={M} N={N} global={is_global} "
                  f"max_abs_err={err2} (vs dp_fused {err_c}) kernel {ms2:.3f} ms "
                  f"dp_fused {ms:.3f} ms plain {pms:.3f} ms", flush=True)
            if err:
                raise AssertionError(f"dp_fused differs from its plain version at {M}x{N}")
            if err2 or err_c:
                raise AssertionError(f"dp_fused_v2 differs from its plain version or from "
                                     f"dp_fused at {M}x{N}")
            total_err = max(total_err, err)
            ms_sum += ms
            pms_sum += pms
            bound_sum += bnd["bound_ms"]
            v2_err = max(v2_err, err2)
            v2_ms += ms2
            v2_pms += pms
    print(f"kernel dp_fused / dp_fused_v2: record ms / plain_ms / bound_ms are sums over the "
          f"10 bucket x mode cases: C {ms_sum:.3f} ms, C' {v2_ms:.3f} ms, bound "
          f"{bound_sum:.4f} ms", flush=True)
    rec_bound = dict(bound_ms=bound_sum, bound_by="operations", library_ms=None)
    records["dp_fused"] = dict(max_abs_err=total_err, ms=ms_sum, plain_ms=pms_sum, **rec_bound)
    records["dp_fused_v2"] = dict(max_abs_err=v2_err, ms=v2_ms, plain_ms=v2_pms, **rec_bound)
    # C' at the widest fused bucket, (256, 4096) extension: the plain version only
    q4, t4, ql4, tl4, bd4, tb4 = dp_inputs(rng, 4096, 256, 4096, False, dev)
    kw4 = dict(M=256, N=4096, params=params, zdrop=200, is_global=False, tb_last=tb4,
               R=run_capacity(256))
    got2 = banded_align_runs_v2(q4, t4, ql4, tl4, bd4, **kw4)
    err2 = max_abs_err(got2, banded_align_runs_plain(q4, t4, ql4, tl4, bd4, **kw4))
    ms2 = time_ms(lambda: banded_align_runs_v2(q4, t4, ql4, tl4, bd4, **kw4), 3)
    pms = time_ms(lambda: banded_align_runs_plain(q4, t4, ql4, tl4, bd4, **kw4), 1)
    print(f"kernel dp_fused_v2: P=4096 M=256 N=4096 global=False "
          f"run_overflows={int(got2[1][5].sum())} max_abs_err={err2} kernel {ms2:.3f} ms "
          f"plain {pms:.3f} ms", flush=True)
    if err2:
        raise AssertionError("dp_fused_v2 differs from its plain version at 256x4096")
    del q4, t4, got2
    # the last case again with R = 8 runs: overflows to redo whatever the
    # main-path capacity gave above
    _, meta = banded_align_runs(q, t, ql, tl, bd, **dict(kw, R=8))
    forced = keep_overflows(meta, q, t, ql, tl, bd, is_global)
    print(f"kernel dp_fused: {forced} problems overflow R=8 at M={M} N={N}", flush=True)
    return overflowed


def wavefront_phase(dev, records, overflowed, roof):
    """Kernel D and the traceback kernel against their plain versions, and
    kernel C's run-overflow problems redone through both on the card and
    on the CPU."""
    import torch

    from ma_tpu_torch.ops.dp import DPParams, banded_align_traceback_packed, rle_ops
    from ma_tpu_torch.ops.dp_wavefront import (
        banded_align_wavefront,
        banded_align_wavefront_plain,
        traceback_dirs,
        traceback_dirs_plain,
    )

    rng = np.random.default_rng(11)
    params = DPParams()
    sums = {"dp_wavefront": [0, 0.0, 0.0, 0.0, []], "dp_traceback": [0, 0.0, 0.0, 0.0, []]}
    for P, M, N, is_global in ((256, 1024, 4096, False), (128, 512, 512, True)):
        q, t, ql, tl, _, _ = dp_inputs(rng, P, M, N, is_global, dev)
        bd = torch.full_like(ql, 512)
        args = (q, t, ql, tl, bd, params, -1 if is_global else 200, is_global)
        got = banded_align_wavefront(*args)
        err = max_abs_err(got, banded_align_wavefront_plain(*args))
        ms = time_ms(lambda: banded_align_wavefront(*args), 5)
        pms = time_ms(lambda: banded_align_wavefront_plain(*args), 1)
        cells = inband_cells(ql.cpu().numpy(), tl.cpu().numpy(), bd.cpu().numpy(), M, N)
        bnd = roof.bound(nbytes(q, t, ql, tl, bd) + nbytes(*got), cells * DP_OPS_PER_CELL)
        print(f"kernel dp_wavefront: P={P} M={M} N={N} global={is_global} band=512 "
              f"zdropped={int(got.zdropped.sum())} max_abs_err={err} kernel {ms:.3f} ms "
              f"plain {pms:.3f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})",
              flush=True)
        if err:
            raise AssertionError(f"dp_wavefront differs from its plain version at {M}x{N}")
        si, sj = (ql - 1, tl - 1) if is_global else (got.max_i, got.max_j)
        tb = traceback_dirs(got.dirs, si, sj)
        terr = max_abs_err(tb, traceback_dirs_plain(got.dirs, si, sj))
        tms = time_ms(lambda: traceback_dirs(got.dirs, si, sj), 5)
        tpms = time_ms(lambda: traceback_dirs_plain(got.dirs, si, sj), 1)
        # the walk reads one direction byte per step of each path
        tbnd = roof.bound(int(tb[1].clamp(min=0).sum()) + nbytes(si, sj) + nbytes(*tb), 0)
        print(f"kernel dp_traceback: P={P} M={M} N={N} longest path {int(tb[1].max())} "
              f"max_abs_err={terr} kernel {tms:.3f} ms plain {tpms:.3f} ms; bound "
              f"{tbnd['bound_ms']:.5f} ms ({tbnd['bound_by']})", flush=True)
        if terr:
            raise AssertionError(f"dp_traceback differs from its plain version at {M}x{N}")
        for name, e, a, b, c in (("dp_wavefront", err, ms, pms, bnd),
                                 ("dp_traceback", terr, tms, tpms, tbnd)):
            s = sums[name]
            sums[name] = [max(s[0], e), s[1] + a, s[2] + b, s[3] + c["bound_ms"],
                          s[4] + [c]]
        del got, tb
    print("kernel dp_wavefront / dp_traceback: record ms / plain_ms / bound_ms are sums over "
          "the 2 cases, bound_by the larger case's", flush=True)
    for name, (e, a, b, c, cases) in sums.items():
        by = max(cases, key=lambda x: x["bound_ms"])["bound_by"]
        records[name] = dict(max_abs_err=e, ms=a, plain_ms=b, bound_ms=c, bound_by=by,
                             library_ms=None)

    # ---- run-overflow redo: kernel D + traceback on the card vs the CPU
    n_redo = 0
    for q, t, ql, tl, bd, is_global in overflowed:
        kw = dict(params=params, zdrop=-1 if is_global else 200, is_global=is_global)
        g_ops, g_meta = banded_align_traceback_packed(q, t, ql, tl, bd, device=dev, **kw)
        c_ops, c_meta = banded_align_traceback_packed(q, t, ql, tl, bd, device="cpu", **kw)
        cig = lambda ops, meta, k: rle_ops(ops[k], *(int(v) for v in meta[:3, k]))
        if not np.array_equal(g_meta, c_meta) or any(
                cig(g_ops, g_meta, k) != cig(c_ops, c_meta, k) for k in range(len(ql))):
            raise AssertionError("redo cigars differ between the card and the CPU")
        n_redo += len(ql)
    print(f"redo: {n_redo} run-overflow problems of kernel C redone through dp_wavefront + "
          f"dp_traceback, cigars identical on the card and the CPU", flush=True)
    if not n_redo:
        raise AssertionError("no run-overflow problem to redo")


def placement(sam: str, starts: np.ndarray) -> float:
    """Share of reads whose primary record is at the simulated start
    (within PLACE_TOL) on the simulated strand."""
    placed = 0
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        flag = int(f[1])
        if flag & 0x904:
            continue
        i = int(f[0][1:])
        if abs(int(f[3]) - 1 - int(starts[i])) <= PLACE_TOL and bool(flag & 16) == bool(i % 2):
            placed += 1
    return placed / len(starts)


def simulate_long(n_reads: int = LONG_READS, read_len: int = LONG_LEN,
                  genome_len: int = LONG_GENOME_BP, seed: int = 4242):
    """scripts/long_read_bench.py's workload, its generator call for call
    (random genome; reads at 1% substitutions, 2% insertions, 2% deletions;
    odd reads reverse complemented), with INV_LEN bases in the middle of
    every INV_EVERY-th read inverted. Returns (pack, reads, starts)."""
    from ma_tpu_torch.containers.nucseq import NucSeq, revcomp_codes
    from ma_tpu_torch.containers.pack import Pack

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrL", genome)

    def simulate(p, L):
        out, i = [], p
        while len(out) < L and i < genome_len:
            r = rng.random()
            if r < 0.02:
                out.append(int(rng.integers(0, 4)))  # insertion
                continue
            if r < 0.04:
                i += 1  # deletion
                continue
            c = int(genome[i])
            if r < 0.05:
                c = (c + int(rng.integers(1, 4))) % 4
            out.append(c)
            i += 1
        return np.asarray(out[:L], np.uint8)

    reads, starts = [], []
    for i in range(n_reads):
        p = int(rng.integers(0, genome_len - 2 * read_len))
        codes = simulate(p, read_len)
        if i % INV_EVERY == 0:
            mid = len(codes) // 2
            codes[mid : mid + INV_LEN] = revcomp_codes(codes[mid : mid + INV_LEN]).copy()
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq(codes, name=f"L{i}_{p}"))
        starts.append(p)
    return pack, reads, np.asarray(starts)


def long_params():
    """The PacBio preset with minimizer seeding and small inversions on."""
    from ma_tpu_torch.config.parameters import ParameterSetManager

    mgr = ParameterSetManager()
    mgr.set_selected("PacBio")
    mgr.selected.set("Seeding Technique", "minimizers")
    mgr.selected.set("Detect Small Inversions", True)
    return mgr


def long_placement(sam: str, starts: np.ndarray):
    """long_read_bench.py's count: (primary records within LONG_PLACE_TOL of
    the simulated start, primary records)."""
    ok = n_prim = 0
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        if int(f[1]) & 0x900:
            continue
        n_prim += 1
        if abs(int(f[3]) - 1 - int(starts[int(f[0][1:].split("_")[0])])) <= LONG_PLACE_TOL:
            ok += 1
    return ok, n_prim


def long_phase(dev, pack, reads, starts, check_reads: int = LONG_CHECK_READS) -> dict:
    """The long-read main path on `dev`: warm-up, PASSES counted passes, one
    pass under the stage timer, and the first check_reads reads against the
    CPU port. Returns each kernel's launches in the counted passes."""
    import torch

    from ma_tpu_torch.utils.profile import AnalyzeRuntimes
    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner

    def run(al, rs):
        buf = io.StringIO()
        n = al.align_to_sam(iter(rs), buf, batch_size=LONG_BATCH)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if n != len(rs):
            raise AssertionError(f"align_to_sam returned {n} of {len(rs)} reads")
        return buf.getvalue()

    aligner = Aligner(pack, long_params(), device=dev)
    t0 = time.perf_counter()
    run(aligner, reads[:8])
    print(f"long warm-up: {time.perf_counter() - t0:.1f} s", flush=True)
    reset_launches()
    aligner.n_inversion_windows = aligner.n_inversions = 0
    walls, sam = [], ""
    for _ in range(PASSES):
        t0 = time.perf_counter()
        sam = run(aligner, reads)
        walls.append(time.perf_counter() - t0)
    launches = read_launches(kernels.KERNELS)
    wall = statistics.median(walls)
    ok, n_prim = long_placement(sam, starts)
    inv_recs = sum(1 for r in sam.splitlines() if not r.startswith("@")
                   and int(r.split("\t", 2)[1]) & 0x800 and r.split("\t", 5)[4] == "0")
    print(f"long: {len(reads)} reads x {LONG_LEN} bp, walls {['%.3f' % w for w in walls]} s, "
          f"{len(reads) / wall:.2f} reads/s, {len(reads) * LONG_LEN / wall / 1e6:.3f} Mbases/s "
          f"(median); placement {ok}/{n_prim} primary records within {LONG_PLACE_TOL} bp "
          f"({ok / len(reads):.2%} of reads); per pass: inversion windows "
          f"{aligner.n_inversion_windows // PASSES}, inversion alignments "
          f"{aligner.n_inversions // PASSES}, supplementary MAPQ-0 records {inv_recs}; "
          f"overflow reads {aligner.n_overflow_reads}, rescued {aligner.n_rescued_reads}",
          flush=True)
    print(f"long launches: {json.dumps(launches)}", flush=True)
    path = {k: v for k, v in launches.items() if k != "dp_fused_v2"}
    if min(path.values()) == 0 or launches["dp_fused_v2"]:
        raise AssertionError(f"the long-read path did not run kernels A, B, C, D and the "
                             f"traceback (and not C'): {launches}")
    if ok < 0.98 * len(reads):
        raise AssertionError(f"long-read placement {ok}/{len(reads)} < 98%")

    # ---- host-clock stage breakdown of one more pass (not counted above)
    aligner.profiler = AnalyzeRuntimes()
    run(aligner, reads)
    print(aligner.profiler.analyze())
    aligner.profiler = None

    # ---- cross-check against the CPU port
    sub = reads[:check_reads]
    t0 = time.perf_counter()
    cpu_sam = run(Aligner(pack, long_params(), device=torch.device("cpu")), sub)
    dev_sam = run(aligner, sub)
    inv = sum(1 for r in cpu_sam.splitlines() if not r.startswith("@")
              and int(r.split("\t", 2)[1]) & 0x800 and r.split("\t", 5)[4] == "0")
    print(f"long cross-check: {len(sub)} reads, CPU port {time.perf_counter() - t0:.1f} s, "
          f"SAM {len(cpu_sam)} bytes, {inv} supplementary MAPQ-0 records, "
          f"identical={dev_sam == cpu_sam}", flush=True)
    if dev_sam != cpu_sam:
        a, b = dev_sam.splitlines(), cpu_sam.splitlines()
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise AssertionError(f"long-read SAM differs between the card and the CPU at line {diff}")
    if not inv:
        raise AssertionError("the long-read cross-check holds no inversion record")
    return launches


def repeat_workload(read_len: int):
    """Two reads of read_len (one reverse complemented) across a 6 kb block
    of 60 copies of a 100 bp unit (2% substitutions each) between random
    30 kb flanks: their SoC windows hold more seeds than seeds_per_soc, so
    they re-align through the overflow rescue. Returns (pack, reads,
    starts)."""
    from ma_tpu_torch.containers.nucseq import NucSeq, revcomp_codes
    from ma_tpu_torch.containers.pack import Pack

    rng = np.random.default_rng(99)
    copies = np.tile(rng.integers(0, 4, 100), (60, 1))
    mut = rng.random(copies.shape) < 0.02
    copies[mut] = (copies[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    genome = np.concatenate([rng.integers(0, 4, 30_000), copies.ravel(),
                             rng.integers(0, 4, 30_000)]).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrT", genome)
    starts = np.asarray([28_000, 28_500])
    reads = [NucSeq(genome[p : p + read_len].copy(), name=f"L{k}_{p}")
             for k, p in enumerate(starts)]
    reads[1] = NucSeq(revcomp_codes(reads[1].codes), name=reads[1].name)
    return pack, reads, starts


def at_locus(sam: str, starts, read_len: int) -> int:
    """Reads whose primary record is mapped and overlaps the reference
    interval the read was taken from (the read's name holds its index)."""
    n = 0
    for line in sam.splitlines():
        f = line.split("\t")
        if line.startswith("@") or int(f[1]) & 0x904:
            continue
        span = sum(int(k) for k, op in re.findall(r"(\d+)([MDN=X])", f[5]))
        p = int(starts[int(f[0][1:].split("_")[0])])
        n += int(f[3]) - 1 < p + read_len and p < int(f[3]) - 1 + span
    return n


def rescue_phase(dev) -> None:
    """Long reads of 5 and 10 kb across a tandem repeat on `dev`: their SoC
    windows overflow and the rescue's boosted stage sweeps rows of 4,096 and
    8,192 seeds through kernel B. The first such sweep of each is held
    against the plain version, and every read's primary record must overlap
    the interval it was taken from. (Inside the repeat the primary record
    leaves parts of the read clipped, on the CPU port as on the card, so
    its POS is not the read's start.)"""
    import torch

    from ma_tpu_torch.ops import harmonize
    from ma_tpu_torch.ops.harmonize_cuda import linesweep_plain
    from ma_tpu_torch.pipeline.aligner import Aligner

    orig = harmonize.linesweep
    for read_len, want in ((5000, 4096), (10_000, 8192)):
        pack, reads, starts = repeat_workload(read_len)
        widths, first = set(), []

        def spy(*args):
            out = orig(*args)
            if args[0].shape[1] > 2048:
                widths.add(args[0].shape[1])
                if not first:
                    first.append((tuple(a.clone() for a in args), out.clone()))
            return out

        al = Aligner(pack, long_params(), device=dev)
        buf = io.StringIO()
        t0 = time.perf_counter()
        harmonize.linesweep = spy
        try:
            al.align_to_sam(iter(reads), buf, batch_size=len(reads))
            torch.cuda.synchronize()
        finally:
            harmonize.linesweep = orig
        wall = time.perf_counter() - t0
        sam = buf.getvalue()
        ok = at_locus(sam, starts, read_len)
        err = max_abs_err([first[0][1]], [linesweep_plain(*first[0][0])]) if first else -1
        recs = [f[:5] + [f[5][:60]] for f in (r.split("\t") for r in sam.splitlines()
                                             if not r.startswith("@"))]
        print(f"rescue: {len(reads)} reads x {read_len} bp across a tandem repeat, {wall:.1f} s; "
              f"overflow reads {al.n_overflow_reads}, rescued {al.n_rescued_reads}; rescue "
              f"sweep widths {sorted(widths)}, max_abs_err={err}; at their locus {ok}; "
              f"records (name, flag, contig, pos, mapq, cigar) {recs}", flush=True)
        if not al.n_rescued_reads or al.n_rescued_reads != al.n_overflow_reads:
            raise AssertionError("the repeat reads did not go through the overflow rescue")
        if widths != {want} or err:
            raise AssertionError(f"rescue sweeps {sorted(widths)} (want {want}) or linesweep "
                                 f"differs from its plain version there ({err})")
        if ok != len(reads):
            raise AssertionError(f"{ok} of {len(reads)} rescued reads at their locus")


def first_diff(a: str, b: str) -> int:
    """Index of the first line where two SAM texts differ."""
    x, y = a.splitlines(), b.splitlines()
    return next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), min(len(x), len(y)))


def fmd_stage_split(al, reads) -> str:
    """Host-clock split of the FMD device stage on one batch, each part
    ended by a device synchronize: seeding (with its state-machine steps),
    seed extraction, and SoC + harmonization + packing."""
    import torch

    from ma_tpu_torch.ops import seeding
    from ma_tpu_torch.ops.extract import extract_seeds
    from ma_tpu_torch.pipeline.aligner import DeviceStageConfig, _stage_tail

    seqs, lens = al._pad_batch(reads, len(reads))
    cfg = DeviceStageConfig.from_params(al.pset, seqs.shape[1])
    fmd, cs = al.fmd_dev(), al.contig_starts
    seqs_d = torch.as_tensor(seqs, device=al.device)
    lens_d = torch.as_tensor(lens, device=al.device)
    steps = [0]
    run = seeding._run

    def counted(step, st, done_phase, iter_cap):
        def one(x):
            steps[0] += 1
            return step(x)
        return run(one, st, done_phase, iter_cap)

    seed_fn = seeding.smem_seeding if cfg.seeding_technique == "SMEMs" else \
        seeding.max_spanning_seeding
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeding._run = counted
    try:
        segs = seed_fn(fmd, seqs_d, lens_d, max_segs=cfg.max_segs,
                       min_ambiguity=cfg.min_ambiguity, max_ambiguity=cfg.max_ambiguity)
    finally:
        seeding._run = run
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seeds = extract_seeds(fmd, segs, lens_d, cs, max_seeds=cfg.max_seeds,
                          max_ambiguity=cfg.max_ambiguity, min_seed_len=cfg.min_seed_len,
                          skip_ambiguous=cfg.skip_ambiguous, rectangular=cfg.rectangular)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _stage_tail(cfg, seeds, lens_d, cs, fmd.n)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (f"{cfg.seeding_technique} device stage on {len(reads)} reads: seeding "
            f"{t1 - t0:.3f} s ({steps[0]} steps, {(t1 - t0) / max(steps[0], 1) * 1e3:.2f} ms "
            f"per step), extraction {t2 - t1:.3f} s ({int(seeds.n_seeds.sum())} seeds), SoC + "
            f"harmonization + packing {t3 - t2:.3f} s")


def fmd_phase(dev, pack, reads, starts) -> dict:
    """The FMD seeding path on `dev`: the Default preset (maxSpan) counted
    over PASSES passes after a warm-up, one pass under the stage timer, one
    pass under MA_TPU_DP_V2=1 (C' instead of C, same SAM), one pass of the
    Illumina preset (SMEMs), and the first CHECK_READS reads of both presets
    against the CPU port. Returns each kernel's launches in the counted
    passes and the two single passes."""
    import os

    import torch

    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.utils.profile import AnalyzeRuntimes
    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner

    t0 = time.perf_counter()
    fmd = FMDIndex.build(pack)
    print(f"fmd: index of {fmd.n} text positions built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def aligner(preset, device):
        mgr = ParameterSetManager()
        mgr.set_selected(preset)
        return Aligner(pack, mgr, device=device, fmd=fmd)

    def run(al, rs):
        buf = io.StringIO()
        t0 = time.perf_counter()
        n = al.align_to_sam(iter(rs), buf, batch_size=BATCH)
        if al.device.type == "cuda":
            torch.cuda.synchronize()
        if n != len(rs):
            raise AssertionError(f"align_to_sam returned {n} of {len(rs)} reads")
        return buf.getvalue(), time.perf_counter() - t0

    total: dict = {k.name: 0 for k in kernels.KERNELS}

    def count(launches):
        for name, v in launches.items():
            total[name] += v

    al = aligner("Default", dev)
    _, wall = run(al, reads[:BATCH])
    print(f"fmd warm-up (index upload, one batch): {wall:.1f} s", flush=True)
    reset_launches()
    walls, sam = [], ""
    for _ in range(PASSES):
        sam, wall = run(al, reads)
        walls.append(wall)
    launches = read_launches(kernels.KERNELS)
    count(launches)
    rps = len(reads) / statistics.median(walls)
    share = placement(sam, starts)
    print(f"fmd maxSpan: walls {['%.3f' % w for w in walls]} s, {rps:.1f} reads/s (median), "
          f"placed {share:.4%}, overflow reads {al.n_overflow_reads}, "
          f"rescued {al.n_rescued_reads}", flush=True)
    print(f"fmd launches: {json.dumps(launches)}", flush=True)
    path = ("soc_sweep", "linesweep", "dp_fused")
    if min(launches[k] for k in path) == 0 or launches["dp_fused_v2"]:
        raise AssertionError(f"the FMD path did not run kernels A, B, C (and not C'): "
                             f"{launches}")
    if share < 0.99:
        raise AssertionError(f"fmd placement {share:.4%} < 99%")

    al.profiler = AnalyzeRuntimes()
    run(al, reads)
    print(al.profiler.analyze())
    al.profiler = None
    print("fmd split:", fmd_stage_split(al, reads[:BATCH]), flush=True)

    # ---- one pass with C' as the fused DP
    os.environ["MA_TPU_DP_V2"] = "1"
    try:
        reset_launches()
        sam2, wall = run(al, reads)
        launches = read_launches(kernels.KERNELS)
    finally:
        del os.environ["MA_TPU_DP_V2"]
    count(launches)
    print(f"fmd maxSpan, MA_TPU_DP_V2=1: {wall:.3f} s, {len(reads) / wall:.1f} reads/s, "
          f"launches {json.dumps(launches)}, SAM identical to the C pass: {sam2 == sam}",
          flush=True)
    if not launches["dp_fused_v2"] or launches["dp_fused"]:
        raise AssertionError(f"MA_TPU_DP_V2=1 did not take C' instead of C: {launches}")
    if sam2 != sam:
        raise AssertionError(f"SAM under C' differs from C's at line {first_diff(sam2, sam)}")

    # ---- SMEMs: the Illumina preset
    al_i = aligner("Illumina", dev)
    run(al_i, reads[:BATCH])
    reset_launches()
    sam_i, wall = run(al_i, reads)
    launches = read_launches(kernels.KERNELS)
    count(launches)
    share = placement(sam_i, starts)
    print(f"fmd SMEMs (Illumina): {wall:.3f} s, {len(reads) / wall:.1f} reads/s, placed "
          f"{share:.4%}, launches {json.dumps(launches)}", flush=True)
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"the SMEM path did not run kernels A, B, C: {launches}")
    if share < 0.99:
        raise AssertionError(f"SMEM placement {share:.4%} < 99%")
    print("fmd split:", fmd_stage_split(al_i, reads[:BATCH]), flush=True)

    # ---- both presets against the CPU port
    sub = reads[:CHECK_READS]
    for preset, gpu in (("Default", al), ("Illumina", al_i)):
        gpu_sam, _ = run(gpu, sub)
        cpu_sam, wall = run(aligner(preset, torch.device("cpu")), sub)
        print(f"fmd cross-check {preset}: {len(sub)} reads, CPU port {wall:.1f} s, SAM "
              f"{len(cpu_sam)} bytes, identical={gpu_sam == cpu_sam}", flush=True)
        if gpu_sam != cpu_sam:
            raise AssertionError(f"{preset}: GPU and CPU SAM differ at line "
                                 f"{first_diff(gpu_sam, cpu_sam)}")
    return total


def profile_pass(aligner, reads, wall_s: float) -> None:
    """One more pass under torch.profiler: the ops by device time, and the
    device's busy time against `wall_s`, the median unprofiled pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        aligner.align_to_sam(iter(reads), io.StringIO(), batch_size=BATCH)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    # the device's own events (kernels, copies, sets), as the table's total
    # counts them: this includes kernels launched outside any torch op
    busy_ms = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"profile: device busy {busy_ms:.1f} ms per pass = {busy_ms / (wall_s * 1e3):.1%} "
          f"of the {wall_s * 1e3:.1f} ms unprofiled pass (idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.1%})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also run one pass under torch.profiler")
    args = ap.parse_args()

    import torch

    from ma_tpu_torch.utils.profile import AnalyzeRuntimes
    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    roof = Roof()
    print(f"roof: {roof.sms} SMs x {INT32_LANES_PER_SM} int32 lanes x {roof.clock_mhz:.0f} MHz "
          f"(clocks.max.sm) = {roof.int32_ops_per_s / 1e12:.2f} T int32 op/s; "
          f"HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    t0 = time.perf_counter()
    pack, reads, starts = simulate(GENOME_BP, N_READS, READ_LEN)
    print(f"workload: genome {GENOME_BP} bp, {len(reads)} reads "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    aligner = Aligner(pack, device=dev)
    aligner.pset.set("Seeding Technique", "minimizers")

    # ---- warm-up: index build + upload, the native libraries, one batch
    t0 = time.perf_counter()
    aligner.align_to_sam(iter(reads[:BATCH]), io.StringIO(), batch_size=BATCH)
    torch.cuda.synchronize()
    print(f"warm-up: {time.perf_counter() - t0:.1f} s", flush=True)

    records: dict = {}
    overflowed = kernel_phase(aligner, reads[:BATCH], dev, records, roof)
    wavefront_phase(dev, records, overflowed, roof)

    # ---- short reads: the native path, counted
    reset_launches()
    walls, sam = [], ""
    for _ in range(PASSES):
        buf = io.StringIO()
        t0 = time.perf_counter()
        n = aligner.align_to_sam(iter(reads), buf, batch_size=BATCH)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sam = buf.getvalue()
        if n != len(reads):
            raise AssertionError(f"align_to_sam returned {n} of {len(reads)} reads")
    launches = read_launches(kernels.KERNELS)
    total = dict(launches)
    rps = len(reads) / statistics.median(walls)
    share = placement(sam, starts)
    print(f"slice: walls {['%.3f' % w for w in walls]} s, {rps:.1f} reads/s (median), "
          f"placed {share:.4%}, overflow reads {aligner.n_overflow_reads}, "
          f"rescued {aligner.n_rescued_reads}", flush=True)
    print(f"slice launches: {json.dumps(launches)}", flush=True)
    tally = sorted(kernels.DP_FUSED.tally.items())
    print("slice dp_fused per (M, N, mode), per pass: " + "; ".join(
        f"{M}x{N} {mode}: {n / PASSES:g} launches, {k / PASSES:g} problems"
        for (M, N, mode), (n, k) in tally), flush=True)
    if min(launches[k.name] for k in (kernels.SOC_SWEEP, kernels.LINESWEEP,
                                      kernels.DP_FUSED)) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if share < 0.99:
        raise AssertionError(f"placement {share:.4%} < 99%")

    # ---- host-clock stage breakdown of one more pass (not counted above)
    aligner.profiler = AnalyzeRuntimes()
    aligner.align_to_sam(iter(reads), io.StringIO(), batch_size=BATCH)
    torch.cuda.synchronize()
    print(aligner.profiler.analyze())
    aligner.profiler = None
    if args.profile:
        profile_pass(aligner, reads, statistics.median(walls))

    # ---- cross-check against the CPU port
    sub = reads[:CHECK_READS]
    gpu_sam = io.StringIO()
    aligner.align_to_sam(iter(sub), gpu_sam, batch_size=BATCH)
    t0 = time.perf_counter()
    cpu = Aligner(pack, device="cpu")
    cpu.pset.set("Seeding Technique", "minimizers")
    cpu_sam = io.StringIO()
    cpu.align_to_sam(iter(sub), cpu_sam, batch_size=BATCH)
    same = gpu_sam.getvalue() == cpu_sam.getvalue()
    print(f"cross-check: {len(sub)} reads, CPU port {time.perf_counter() - t0:.1f} s, "
          f"SAM {len(cpu_sam.getvalue())} bytes, identical={same}", flush=True)
    if not same:
        raise AssertionError(f"GPU and CPU SAM differ at line "
                             f"{first_diff(gpu_sam.getvalue(), cpu_sam.getvalue())}")

    # ---- FMD seeding (Default and Illumina presets), counted
    for name, v in fmd_phase(dev, pack, reads, starts).items():
        total[name] += v

    # ---- long reads with small inversions: the Python NW path, counted
    t0 = time.perf_counter()
    pack_l, reads_l, starts_l = simulate_long()
    print(f"long workload: genome {LONG_GENOME_BP} bp, {len(reads_l)} reads x {LONG_LEN} bp, "
          f"inversions of {INV_LEN} bp in every {INV_EVERY}th read "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, v in long_phase(dev, pack_l, reads_l, starts_l).items():
        total[name] += v
    rescue_phase(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    reference = sorted(m for m in sys.modules if m == "ma_tpu" or m.startswith("ma_tpu."))
    if reference:
        raise AssertionError(f"modules of the JAX package were imported: {reference}")
    print("isolation: no jax and no ma_tpu module loaded", flush=True)
    if min(total.values()) == 0:
        raise AssertionError(f"a kernel never launched on the main paths: {total}")

    out = []
    for k in kernels.KERNELS:
        out.append(dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
                        launches=total[k.name], **records[k.name]))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
