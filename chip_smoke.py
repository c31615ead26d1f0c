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
     (CUDA events) and the bound (below); A on the short path's first
     batch (S = 256, B = 4096, K = 32), with a second bound for the bytes
     its data needs (the first min(n, S) candidate records of each read);
     B sorts and sweeps unsorted dense
     rows at R = 65,536, M = 64 and R = 512, M = 2048, and the short-read
     path's own first sweep of a batch, its plain version being the
     stable sort plus the plain sweep; C' (the DP kernel MA_TPU_DP_V2=1
     selects) also against C at the five fused buckets, both modes, P =
     4096, and against the plain version alone at (256, 4096) extension,
     which C cannot take, with its bound; each kernel's times before its
     redesign are printed beside the times now;
  4. wavefront kernels: kernel D against its plain version at an extension
     bucket (P = 256, M = 1024, N = 4096, band 512, z-drop 200) and a global
     inversion-like bucket (P = 128, M = N = 512, band 512), exact on every
     output, with both times, the times before D's redesign, both bound
     terms (every cell's operations, not only the in-band ones: the
     contract writes every byte) and D's time at 4 and at 2 lanes a
     thread (the outputs must agree); the traceback kernel against its
     plain version on D's output, timed by CUDA events and by graph replay;
     the problems that overflowed kernel C's run buffer in phase 3 redone
     through D + traceback on the card and on the CPU (the cigars must
     agree);
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
  7. paired reads: 4,096 FR pairs of 2 x 150 bp over the same genome
     (insert 400 +- 30, 1% substitutions, default_rng(2718)) through
     PairedAligner(Aligner(device="cuda")) under the Illumina Paired preset
     (SMEMs) and under Default with "Use Paired Reads" (maxSpan, the
     command line's -m): pairs/s (median of 3 passes at a batch of 4,096
     pairs after a warm-up, then one pass of 1,024 pairs at the command
     line's batch of 256), the share of pairs with both primary records
     within 10 bp of their simulated starts, the share of primary records
     flagged properly paired, and the launches of A, B, C in the counted
     passes (none may be 0); the first 256 pairs on device="cpu" must give
     byte-identical SAM;
  8. command line: the genome as FASTA; `python -m ma_tpu_torch.cli
     --Create_Index` in a subprocess (timed), then three runs in
     subprocesses on the card: -m on 512 pairs (Default preset), minimizers
     with "Minimizers - SDUST Threshold" 20 on 512 reads with low-complexity
     spans planted in a quarter of them, and minimizers with NGMLR tags on
     the same reads; each run's SAM must equal the in-process CPU port's on
     the same files and index (the @PG line included, `--Device` left out
     of it), and no subprocess may load a jax or ma_tpu module (python -X
     importtime lists every import); then, in this process on the card,
     4,096 reads without planted spans: the minimizer pass, the SDUST pass
     and the NGMLR (object path) pass, reads/s each (median of 3 after a
     warm-up) with the launches of A, B, C (none may be 0);
  9. long reads: scripts/long_read_bench.py's workload (256 reads of 20 kb
     over a random 10 Mbp genome, 1% substitutions, 2% insertions, 2%
     deletions, odd reads reverse complemented, default_rng(4242)) with a
     200 bp inverted stretch planted in the middle of every fourth read,
     PacBio preset, minimizers, "Detect Small Inversions" on: kernel A on
     the first batch's table (S = 8,192, B = 256; record "soc_sweep_long",
     the plain version timed once), then reads/s and
     Mbases/s (median of 3 passes after a warm-up), placement (primary
     records within 200 bp of the simulated start, must be >= 98%),
     inversion windows and records, host-clock stages, and each kernel's
     launches in those passes (all five must launch; D's per (P, M, N,
     mode)); kernel D on the inputs of its launches in the stage pass, at 4
     and at 2 lanes a thread (the outputs must agree, and equal its plain
     version's, which is timed there), and the traceback
     kernel on the inputs of its launches there; then the first 4 long
     reads on device="cpu" must give byte-identical SAM;
 10. long-read overflow rescue: 5 kb and 10 kb reads across a tandem repeat
     overflow their SoC windows; the rescue's stage sweeps rows of 4,096 and
     8,192 seeds through kernel B, held against its plain version there, and
     each read's primary record must overlap the interval it came from;
 11. wide fused problems: 40 reads of 500 bp ending in 256-base extensions,
     Bandwidth for Extensions 768 and Padding 1,100, so the Python NW path's
     fused bucket runs 1,152 columns wide, then 4,000 and 4,400, so it runs
     4,352 wide: with MA_TPU_DP_V2 unset, C' must launch past 1,024 (then
     4,096) columns (its per (M, N, mode) tally), and the SAM must equal the
     CPU port's;
 12. the SV caller (msv): scripts/sv_bench.py 50 50000 1000's workload,
     drawn as that script draws it (seed 20260821, a 50 Mbp reference, 100
     deletions, insertions and inversions of 100-2,000 bp, 50,000 reads of
     1 kb at 0.2% substitutions, every second one reverse complemented):
     the minimizer index build (host) and its CHD + upload timed apart, a
     warm-up on 512 reads, then compute_sv_jumps_batch(device="cuda") and
     sweep_sv_jumps: jumps, calls, sv_recall (implanted sites with a call
     within 1,000 bp), reads/s and jumps/s, the sweep's jumps/s, the
     MA_TPU_SV_PROFILE phase split and kernel A's launches per pass (one a
     chunk of 512; the median of 3 passes when the first takes under 45 s,
     else that one pass, as printed); jumps, calls, recall and A's launches
     must not be 0; the first 2,048 reads on device="cpu" must give the
     same JumpBatch column for column and the same calls; kernel A on the
     first chunk's table (B = 512, S = 2,048, K = 64, non-rectangular;
     record "soc_sweep_msv"); the last pass's jumps through an SvDb file
     (msv/sv_db.py, SQLite; insert, R*Tree index and load timed, jumps/s):
     the loaded jumps must equal the stored ones field by field, their
     sweep the in-memory sweep's calls (supporting jump ids mapped to row
     ids), jumps_in_section a brute filter on 6 windows, and the calls
     must come back from insert_calls / load_calls / calls_overlapping;
     connector_pattern_filter on the pass's calls
     on the card: kernel D must launch, its scores equal its plain
     version's, the kept calls the CPU port's, and D is timed at that shape
     (record "dp_wavefront_connector"); then a 2 Mbp slice of the reference
     as FASTA, `--Create_Index` and `--Sv` in subprocesses (no jax or
     ma_tpu import) on 2,000 reads crossing the slice's SVs: calls.tsv,
     .html and .view.html must equal the in-process CPU port's byte for
     byte. `--only msv` runs this phase alone;
 13. the web console (gui): ma_tpu_torch/gui.py served from this process on
     127.0.0.1 at an ephemeral port, three actions posted through HTTP, all
     on cuda: index the bench genome as FASTA; align 512 reads (Default
     preset), with kernels A, B and C's launches in the action printed
     (each must be > 0; not summed into the kernels record); `--Sv` on the
     msv phase's 2 Mbp slice and its 2,000 reads. Each action must log
     rc 0, and its SAM, or its calls.tsv, .html and .view.html, must equal
     cli.main's in this process with the same arguments on cuda, byte for
     byte; both SAM files are read back through io/sam_reader.py. `--only
     gui` runs this phase alone (drawing the bench genome and the msv
     workload first);
 14. multi-process (ma_tpu_torch/parallel/): ranks are processes of
     `python -m ma_tpu_torch.parallel.worker`, each run under a rendezvous
     and collective timeout of PAR_TIMEOUT s and a wall limit. NCCL as one
     rank on cuda:0 (init, all_reduce, all_gather); then two ranks sharing
     cuda:0 over gloo with CUDA tensors (with two cards or more, a card a
     rank over NCCL, and the line says so), on the earlier phases' indexes
     stored once: the sum over the ranks and a probe of the collectives and
     dtypes the backend takes; the msv phase's 50 Mbp minimizer index in two
     hash-range shards, 4,096 msv reads seeded (one all_reduce a batch),
     each read's seeds equal to the single-device lookup's on the card but
     for reads over a hash where sharding changes ma_tpu's seeds (counted),
     and the first 1,024 reads equal to the same ranks' on the CPU; the
     bench genome's FMD index in two row shards, 512 bench reads under SMEMs
     and maxSpan, equal field for field to the single-device path on the
     card, with both times and the collectives a batch (the same on both
     ranks); the 16,384 bench reads in two FASTQ files, one a rank
     (shard_paths), aligned with minimizers: the merged SAM must equal one
     process's on the same reads, A, B and C must launch on each rank, and
     the two ranks' reads/s is printed beside one process's (median of 3).
     One JSON line {"parallel": ...} holds every check and number. `--only
     parallel` runs this phase alone (building its inputs first).

The bound of a kernel (`bound_ms`) is the larger of the bytes it must move
(each input read once, each output written once) over the card's memory rate
(3.35 TB/s, the H100 SXM's published HBM3 rate) and its int32 operations
over the int32 peak, 64 lanes per SM x the SMs x the card's maximum SM
clock (nvidia-smi clocks.max.sm); `bound_by` names the larger. The fused
DP kernels' operations are DP_OPS_PER_CELL per in-band cell of this run's
problems, kernel D's DP_OPS_PER_CELL per cell of its direction tensor. No
single PyTorch call computes any of these kernels' functions,
so `library_ms` is null.

The line before the last is the kernels' JSON record (each kernel's
launches summed over the counted main-path passes of phases 5-9 and 12, each
read with the counts set to 0 just before it, and A, B and C's launches in
the aligning ranks of phase 14, each rank's set to 0 before its timed pass; "soc_sweep_long" and
"soc_sweep_msv", A's other timed cases, with the long and the MSV passes'
launches of A; "dp_wavefront_connector", D at the connector's shape, with
its launches in the connector's run); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Neither JAX nor any module of the JAX package ma_tpu is imported (checked at
the end).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
PAIRS, INSERT, INSERT_SD = 4096, 400, 30  # 2 x READ_LEN bp FR pairs
PAIRED_BATCH = 4096  # pairs a flush in the timed passes
CLI_BATCH = 256  # the command line's batch (ma_tpu's default: it sets the SAM's order)
CLI_READS = 512  # reads (and pairs) of each command-line run
SDUST_T = 20
LONG_CHECK_READS = 4
# scripts/sv_bench.py 50 50000 1000: its seed, a 50 Mbp reference with
# max(20, G // 500,000) = 100 SVs, 50,000 reads of 1 kb; the MSV chunk
SV_SEED, SV_GENOME_BP, SV_READS, SV_READ_LEN, SV_BATCH = 20260821, 50_000_000, 50_000, 1000, 512
SV_RECALL_TOL = 1000  # bp between a call and an implanted site (sv_bench.py's count)
SV_CHECK_READS = 2048  # reads cross-checked against the CPU port
SV_THREE_PASSES_BELOW_S = 45  # a first pass this fast keeps the phase near 3 min with 3
SV_CLI_BP, SV_CLI_READS = 2_000_000, 2000  # the --Sv command line's slice and reads
# the parallel phase: ranks, the sharded minimizer batch (msv reads over the
# 50 Mbp index; ma_tpu's sharded_minimizer_seeding defaults: max_occ 50, 256
# slots a shard), the reads re-run with the ranks on the CPU, the sharded FMD
# batch (bench reads), the warm-up reads, and each run's limits in seconds
PAR_WORLD, PAR_MM_READS, PAR_MM_SLOTS, PAR_MAX_OCC = 2, 4096, 256, 50
PAR_CPU_MM_READS, PAR_FMD_READS, PAR_WARMUP = 1024, 512, 16
PAR_TECHNIQUES = ("SMEMs", "maxSpan")
PAR_TIMEOUT, PAR_WALL = 60, 300  # a rendezvous or collective; a run of ranks
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
# kernel D's times before its redesign (commit 79e2d9b) on the two timed
# cases (P, M, N), as PERF.md records them: NVIDIA H100 80GB HBM3, 700.00 W
D_BEFORE_MS = {(256, 1024, 4096): 20.870, (128, 512, 512): 1.203}
# the traceback kernel's and C''s times before their redesign (commit
# c77ad29), as PERF.md records them: NVIDIA H100 80GB HBM3, 700.00 W. The
# traceback on D's output at the two cases above (P, M, N); C' summed over
# the 10 bucket cases and at (256, 4096) extension, P = 4096
TB_BEFORE_MS = {(256, 1024, 4096): 1.016, (128, 512, 512): 0.247}
V2_BEFORE_MS = {"buckets": 13.714, (256, 4096): 19.750}


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Mean device time of one fn() call: `calls` calls captured in one CUDA
    graph, replayed `reps` times between CUDA events. Where a call's host
    work (checks, allocations, the launch) outlasts its kernels, time_ms
    measures the host; the replay leaves only the device's work."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps) / calls


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


def soc_case(name: str, cand, n, min_score, K: int, records, roof, plain_reps: int) -> None:
    """Kernel A against its plain version on one batch's table, timed from
    a CUDA graph (`ms`) and called one by one (`eager_ms`), with two
    bounds: the whole [S, B, 7] table (the record's earlier bound, kept
    as `table_bound_ms`) and the bytes this batch's data needs (`bound_ms`:
    the first min(n, S) records of each read, n and min_score, the
    outputs)."""
    import torch

    from ma_tpu_torch.ops.soc_cuda import soc_sweep, soc_sweep_plain

    S, B, _ = cand.shape
    got = soc_sweep(cand, n, min_score, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = soc_sweep_plain(cand, n, min_score, K)
    torch.cuda.synchronize()
    first_plain_s = time.perf_counter() - t0
    err = max_abs_err(got, ref)
    eager_ms = time_ms(lambda: soc_sweep(cand, n, min_score, K), 20)
    ms = graph_ms(lambda: soc_sweep(cand, n, min_score, K))
    pms = (time_ms(lambda: soc_sweep_plain(cand, n, min_score, K), plain_reps) if plain_reps
           else first_plain_s * 1e3)
    table = roof.bound(nbytes(cand, n, min_score) + nbytes(*got), 0)
    read = int(n.clamp(0, S).sum())
    bd = roof.bound(28 * read + 8 * B + B * K * 32 + 5 * B, 0)
    print(f"kernel {name}: cand {tuple(cand.shape)} K={K} candidate records read {read} "
          f"(longest read {int(n.max())}), stack overflows {int(got[2].sum())} max_abs_err={err} "
          f"kernel {ms:.4f} ms (graph replay; {eager_ms:.4f} ms called one by one) "
          f"plain {pms:.3f} ms; bound, whole table {table['bound_ms']:.4f} "
          f"ms ({table['bound_ms'] / ms:.1%} of the time), the bytes its data needs "
          f"{bd['bound_ms']:.5f} ms ({bd['bound_ms'] / ms:.1%})", flush=True)
    if err:
        raise AssertionError(f"{name} differs from its plain version: {err}")
    records[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bd,
                         table_bound_ms=table["bound_ms"], eager_ms=eager_ms)


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
    C; fused_phase). Returns kernel C's run-overflow problems as host arrays
    (q, t, qlen, tlen, band, is_global) for the redo check of
    wavefront_phase."""
    from ma_tpu_torch.ops.harmonize_cuda import linesweep, linesweep_plain

    rng = np.random.default_rng(7)
    # ---- A: SoC sweep at S = 256, B = 4096, K = 32 (the short path's first batch)
    soc_case("soc_sweep", *soc_inputs(aligner, reads, dev), records, roof, plain_reps=1)

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

    return fused_phase(rng, dev, records, roof)


def fused_phase(rng, dev, records, roof):
    """Kernels C and C' against the plain version (C' also against C) at the
    five fused buckets, both modes, P = 4096, and C' alone at (256, 4096)
    extension, with their bounds. Returns kernel C's run-overflow problems as
    host arrays (q, t, qlen, tlen, band, is_global) for the redo check of
    wavefront_phase."""
    import torch

    from ma_tpu_torch.ops.dp import DPParams, run_capacity
    from ma_tpu_torch.ops.dp_fused import (
        banded_align_runs, banded_align_runs_plain, banded_align_runs_v2,
    )

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
          f"10 bucket x mode cases: C {ms_sum:.3f} ms, C' {v2_ms:.3f} ms (before its "
          f"redesign: {V2_BEFORE_MS['buckets']:.3f} ms), bound {bound_sum:.4f} ms; C' at "
          f"{bound_sum / v2_ms:.1%} of the bound", flush=True)
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
    cells = inband_cells(ql4.cpu().numpy(), tl4.cpu().numpy(), bd4.cpu().numpy(), 256, 4096)
    bnd = roof.bound(nbytes(q4, t4, ql4, tl4, bd4, tb4) + nbytes(*got2),
                     cells * DP_OPS_PER_CELL)
    print(f"kernel dp_fused_v2: P=4096 M=256 N=4096 global=False "
          f"run_overflows={int(got2[1][5].sum())} zdropped={int(got2[1][4].sum())} "
          f"max_abs_err={err2} kernel {ms2:.3f} ms (before its redesign: "
          f"{V2_BEFORE_MS[(256, 4096)]:.3f} ms) plain {pms:.3f} ms; {cells} in-band cells "
          f"of {4096 * 256 * 4096}, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
          f"{bnd['bound_ms'] / ms2:.1%} of it", flush=True)
    records["dp_fused_v2"].update(wide_ms=ms2, wide_plain_ms=pms, wide_bound_ms=bnd["bound_ms"])
    if err2:
        raise AssertionError("dp_fused_v2 differs from its plain version at 256x4096")
    del q4, t4, got2
    # the last case again with R = 8 runs: overflows to redo whatever the
    # main-path capacity gave above
    _, meta = banded_align_runs(q, t, ql, tl, bd, **dict(kw, R=8))
    forced = keep_overflows(meta, q, t, ql, tl, bd, is_global)
    print(f"kernel dp_fused: {forced} problems overflow R=8 at M={M} N={N}", flush=True)
    return overflowed


def wavefront_lanes(args, reps: int = 5):
    """Kernel D at 4 and at 2 lanes a thread on the same inputs (the two
    outputs must be equal). Returns (the kernel's default, "4 lanes x ms, 2
    lanes y ms")."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront

    P, M = args[0].shape
    want, times = None, []
    for lanes in (4, 2):
        got = banded_align_wavefront(*args, lanes=lanes)
        if want is not None and max_abs_err(got, want):
            raise AssertionError(f"dp_wavefront differs between 4 and 2 lanes a thread at "
                                 f"P={P} M={M}")
        want = got
        ms = time_ms(lambda: banded_align_wavefront(*args, lanes=lanes), reps)
        times.append(f"{lanes} lanes {ms:.3f} ms")
    return kernels.query("ma_dp_wavefront_lanes", P, M), ", ".join(times)


def wavefront_cases(dev):
    """Kernel D's two timed cases, (P, M, N, is_global, args): an extension
    bucket (P = 256, 1024 x 4096, band 512, z-drop 200) and a global
    inversion-like bucket (P = 128, 512 x 512, band 512), codes as uint8."""
    import torch

    from ma_tpu_torch.ops.dp import DPParams

    rng = np.random.default_rng(11)
    for P, M, N, is_global in ((256, 1024, 4096, False), (128, 512, 512, True)):
        q, t, ql, tl, _, _ = dp_inputs(rng, P, M, N, is_global, dev)
        q, t = q.to(torch.uint8), t.to(torch.uint8)  # codes as the main path gives them
        bd = torch.full_like(ql, 512)
        yield P, M, N, is_global, (q, t, ql, tl, bd, DPParams(), -1 if is_global else 200,
                                   is_global)


def traceback_case(label: str, dirs, si, sj, roof, before_ms=None, plain_reps: int = 1) -> dict:
    """The traceback kernel against its plain version on one launch's
    inputs (exact on every output), timed by CUDA events around the wrapper
    and by graph replay (the device alone; the plain version `plain_reps`
    times, 0: not timed), with its bound: one direction byte read per step
    of each path, the start cells, the outputs."""
    from ma_tpu_torch.ops.dp_wavefront import traceback_dirs, traceback_dirs_plain

    P, D, M = dirs.shape
    got = traceback_dirs(dirs, si, sj)
    err = max_abs_err(got, traceback_dirs_plain(dirs, si, sj))
    ms = time_ms(lambda: traceback_dirs(dirs, si, sj), 5)
    replay = graph_ms(lambda: traceback_dirs(dirs, si, sj), calls=10)
    pms = time_ms(lambda: traceback_dirs_plain(dirs, si, sj), plain_reps) if plain_reps else None
    steps = int(got[1].clamp(min=0).sum())
    bnd = roof.bound(steps + nbytes(si, sj) + nbytes(*got), 0)
    before = "" if before_ms is None else f" (before its redesign: {before_ms:.3f} ms)"
    plain = "not timed" if pms is None else f"{pms:.3f} ms"
    print(f"{label} dp_traceback: P={P} M={M} N={D + 1 - M} longest path {int(got[1].max())} "
          f"steps {steps} max_abs_err={err} kernel {ms:.4f} ms by events, {replay:.4f} ms by "
          f"graph replay{before} plain {plain}; bound {bnd['bound_ms']:.5f} ms "
          f"({bnd['bound_by']}), {bnd['bound_ms'] / replay:.2%} of the replay time",
          flush=True)
    if err:
        raise AssertionError(f"dp_traceback differs from its plain version ({label}, P={P} "
                             f"M={M})")
    return dict(max_abs_err=err, ms=ms, replay_ms=replay, plain_ms=pms, **bnd)


def wavefront_phase(dev, records, overflowed, roof):
    """Kernel D and the traceback kernel against their plain versions, and
    kernel C's run-overflow problems redone through both on the card and
    on the CPU."""
    from ma_tpu_torch.ops.dp import DPParams, banded_align_traceback_packed, rle_ops
    from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront, banded_align_wavefront_plain

    params = DPParams()
    sums = {"dp_wavefront": [0, 0.0, 0.0, 0.0, []], "dp_traceback": [0, 0.0, 0.0, 0.0, []]}
    for P, M, N, is_global, args in wavefront_cases(dev):
        q, t, ql, tl, bd = args[:5]
        got = banded_align_wavefront(*args)
        err = max_abs_err(got, banded_align_wavefront_plain(*args))
        ms = time_ms(lambda: banded_align_wavefront(*args), 5)
        pms = time_ms(lambda: banded_align_wavefront_plain(*args), 1)
        lanes, by_lanes = wavefront_lanes(args)
        # the contract writes every (diagonal, lane) byte, and every byte
        # needs the recurrence, in band or not
        cells = P * (M + N - 1) * M
        inband = inband_cells(ql.cpu().numpy(), tl.cpu().numpy(), bd.cpu().numpy(), M, N)
        moved = nbytes(q, t, ql, tl, bd) + nbytes(*got)
        bnd = roof.bound(moved, cells * DP_OPS_PER_CELL)
        b_ms = roof.bound(moved, 0)["bound_ms"]
        o_ms = roof.bound(0, cells * DP_OPS_PER_CELL)["bound_ms"]
        print(f"kernel dp_wavefront: P={P} M={M} N={N} global={is_global} band=512 "
              f"({lanes} lanes a thread; {by_lanes}) "
              f"zdropped={int(got.zdropped.sum())} max_abs_err={err} kernel {ms:.3f} ms "
              f"(before its redesign: {D_BEFORE_MS[(P, M, N)]:.3f} ms) plain {pms:.3f} ms; "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}): bytes {moved / 1e9:.4f} GB "
              f"-> {b_ms:.4f} ms, every cell {cells} x {DP_OPS_PER_CELL} ops -> {o_ms:.4f} ms "
              f"({inband} in band); {bnd['bound_ms'] / ms:.1%} of the bound", flush=True)
        if err:
            raise AssertionError(f"dp_wavefront differs from its plain version at {M}x{N}")
        si, sj = (ql - 1, tl - 1) if is_global else (got.max_i, got.max_j)
        tb = traceback_case("kernel", got.dirs, si, sj, roof, TB_BEFORE_MS[(P, M, N)])
        for name, e, a, b, c in (("dp_wavefront", err, ms, pms, bnd),
                                 ("dp_traceback", tb["max_abs_err"], tb["ms"], tb["plain_ms"],
                                  tb)):
            s = sums[name]
            sums[name] = [max(s[0], e), s[1] + a, s[2] + b, s[3] + c["bound_ms"],
                          s[4] + [c]]
        del got
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


def spied_pass(run_pass):
    """run_pass() with the wrappers of kernel D and of the traceback kernel
    spied on. Returns the arguments of each of their calls, tensors cloned:
    (D's, the traceback's)."""
    import torch

    from ma_tpu_torch.ops import dp_wavefront

    seen: tuple = ([], [])
    orig = dp_wavefront.banded_align_wavefront, dp_wavefront.traceback_dirs

    def spy(k):
        def call(*args, **kw):
            seen[k].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return orig[k](*args, **kw)
        return call

    dp_wavefront.banded_align_wavefront, dp_wavefront.traceback_dirs = spy(0), spy(1)
    try:
        run_pass()
    finally:
        dp_wavefront.banded_align_wavefront, dp_wavefront.traceback_dirs = orig
    return seen


def long_phase(dev, pack, reads, starts, records, roof,
               check_reads: int = LONG_CHECK_READS) -> dict:
    """The long-read main path on `dev`: warm-up, kernel A on the first
    batch's candidate table (record "soc_sweep_long"), PASSES counted
    passes, one pass under the stage timer, and the first check_reads reads
    against the CPU port. Returns each kernel's launches in the counted
    passes."""
    import torch

    from ma_tpu_torch.utils.profile import AnalyzeRuntimes
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront, banded_align_wavefront_plain
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
    # ---- A on the long path's first batch: S = max_seeds = 8192, B = 256
    soc_case("soc_sweep_long", *soc_inputs(aligner, reads[:LONG_BATCH], dev), records, roof,
             plain_reps=0)
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
    print(f"long launches: {json.dumps(launches)}; dp_fused per (M, N, mode): "
          f"{sorted(kernels.DP_FUSED.tally.items())}; dp_fused_v2: "
          f"{sorted(kernels.DP_FUSED_V2.tally.items())}; dp_wavefront per (P, M, N, mode): "
          f"{sorted(kernels.DP_WAVEFRONT.tally.items())}", flush=True)
    path = {k: v for k, v in launches.items() if k != "dp_fused_v2"}
    if min(path.values()) == 0 or launches["dp_fused_v2"]:
        raise AssertionError(f"the long-read path did not run kernels A, B, C, D and the "
                             f"traceback (and not C'): {launches}")
    if ok < 0.98 * len(reads):
        raise AssertionError(f"long-read placement {ok}/{len(reads)} < 98%")

    # ---- host-clock stage breakdown of one more pass (not counted above),
    # keeping kernel D's and the traceback kernel's inputs to time them
    aligner.profiler = AnalyzeRuntimes()
    seen, tb_seen = spied_pass(lambda: run(aligner, reads))
    print(aligner.profiler.analyze())
    aligner.profiler = None
    for args in seen:
        P, M = args[0].shape
        lanes, by_lanes = wavefront_lanes(args)
        # the device alone, by graph replay (8-bit codes: wider ones make the
        # wrapper read their minimum back, which a graph cannot capture)
        replay = (f"{graph_ms(lambda: banded_align_wavefront(*args), calls=10):.3f} ms"
                  if args[0].dtype == args[1].dtype == torch.uint8 else "not measured")
        N = args[1].shape[1]
        cells = P * (M + N - 1) * M
        bnd = roof.bound(nbytes(*args[:5]) + cells + 4 * 4 * P, cells * DP_OPS_PER_CELL)
        err = max_abs_err(banded_align_wavefront(*args), banded_align_wavefront_plain(*args))
        pms = time_ms(lambda: banded_align_wavefront_plain(*args), 1)
        print(f"long pass dp_wavefront: P={P} M={M} N={N} "
              f"{'global' if args[7] else 'extension'} (codes {args[0].dtype}): {lanes} lanes "
              f"a thread by default; {by_lanes}; by graph replay at {lanes} lanes {replay}; "
              f"max_abs_err={err} plain {pms:.3f} ms; bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}, every cell {cells} x {DP_OPS_PER_CELL} ops)", flush=True)
        if err:
            raise AssertionError(f"dp_wavefront differs from its plain version at {M}x{N}")
    for dirs, si, sj in tb_seen:
        traceback_case("long pass", dirs, si, sj, roof)

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


def wide_workload():
    """tests/test_torch_long.py's wide fixture, all 40 draws: a 30 kbp random
    genome and 500 bp reads whose first 248-256 bases are random, so each
    ends in a left extension of about 256 query bases. Returns (pack,
    reads)."""
    from ma_tpu_torch.containers.nucseq import NucSeq
    from ma_tpu_torch.containers.pack import Pack

    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, 30_000).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrW", genome)
    reads = []
    for i in range(40):
        p = int(rng.integers(2_000, 28_000))
        codes = genome[p : p + 500].copy()
        k = 256 - int(rng.integers(0, 8))
        codes[:k] = rng.integers(0, 4, k)
        reads.append(NucSeq(codes, name=f"w{i}_{p}"))
    return pack, reads


# (Bandwidth for Extensions, Padding, width C' must pass) of the wide phase:
# a 256-base extension window of 1,025 columns (C' past C's 1,024) and one
# of 4,257 (C' past 4,096 columns)
WIDE_CASES = ((768, 1100, 1024), (4000, 4400, 4096))


def wide_phase(dev) -> None:
    """Fused problems wider than kernel C's 1,024 columns on the card:
    minimizers with each WIDE_CASES setting of Bandwidth for Extensions and
    Padding, so a 256-base extension spans 1,025 (4,257) reference columns
    and the Python NW path's fused bucket runs 1,152 (4,352) wide. With
    MA_TPU_DP_V2 unset, C' must launch past the case's width, C never past
    1,024, and the SAM must equal the CPU port's."""
    import os

    import torch

    from ma_tpu_torch import kernels
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.pipeline.aligner import Aligner

    if os.environ.get("MA_TPU_DP_V2"):
        raise AssertionError("the wide phase runs with MA_TPU_DP_V2 unset")
    pack, reads = wide_workload()

    for band, padding, past in WIDE_CASES:
        def sam(device):
            mgr = ParameterSetManager()
            mgr.selected.set("Seeding Technique", "minimizers")
            mgr.selected.set("Bandwidth for Extensions", band)
            mgr.selected.set("Padding", padding)
            buf = io.StringIO()
            Aligner(pack, mgr, device=device).align_to_sam(iter(reads), buf, batch_size=64)
            return buf.getvalue()

        reset_launches()
        t0 = time.perf_counter()
        gpu_sam = sam(dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wide = {k: v for k, v in kernels.DP_FUSED_V2.tally.items() if k[1] > past}
        c_widths = sorted({k[1] for k in kernels.DP_FUSED.tally})
        cpu_sam = sam("cpu")
        print(f"wide (band {band}, padding {padding}): {len(reads)} reads x 500 bp, {wall:.1f} s "
              f"on the card; dp_fused_v2 per (M, N, mode) past {past:,} columns: {wide}; "
              f"dp_fused widths {c_widths}; SAM {len(cpu_sam)} bytes, identical to the CPU "
              f"port's: {gpu_sam == cpu_sam}", flush=True)
        if not wide or max(c_widths, default=0) > 1024:
            raise AssertionError(f"the wide phase did not launch C' past {past:,} columns")
        if gpu_sam != cpu_sam:
            raise AssertionError(f"wide: GPU and CPU SAM differ at line "
                                 f"{first_diff(gpu_sam, cpu_sam)}")


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


def fmd_phase(dev, pack, fmd, reads, starts) -> dict:
    """The FMD seeding path on `dev`: the Default preset (maxSpan) counted
    over PASSES passes after a warm-up, one pass under the stage timer, one
    pass under MA_TPU_DP_V2=1 (C' instead of C, same SAM), one pass of the
    Illumina preset (SMEMs), and the first CHECK_READS reads of both presets
    against the CPU port. Returns each kernel's launches in the counted
    passes and the two single passes."""
    import os

    import torch

    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.utils.profile import AnalyzeRuntimes
    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner

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


def simulate_pairs(pack, n_pairs: int, seed: int):
    """FR pairs over the pack's (one-contig) genome: 2 x READ_LEN bp, insert
    N(INSERT, INSERT_SD) clipped to 300-500, 1% substitutions, mate 2
    reverse complemented. Returns (pairs, starts, inserts)."""
    from ma_tpu_torch.containers.nucseq import NucSeq, revcomp_codes

    genome = np.asarray(pack.codes, np.uint8)
    rng = np.random.default_rng(seed)

    def mutate(codes):
        codes = codes.copy()
        for j in np.nonzero(rng.random(len(codes)) < 0.01)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        return codes

    pairs, starts, inserts = [], [], []
    for i in range(n_pairs):
        ins = int(np.clip(rng.normal(INSERT, INSERT_SD), 300, 500))
        p = int(rng.integers(0, len(genome) - ins))
        m1 = mutate(genome[p : p + READ_LEN])
        m2 = revcomp_codes(mutate(genome[p + ins - READ_LEN : p + ins]))
        pairs.append((NucSeq(m1, name=f"q{i}"), NucSeq(m2, name=f"q{i}")))
        starts.append(p)
        inserts.append(ins)
    return pairs, np.asarray(starts), np.asarray(inserts)


def paired_placement(sam: str, starts: np.ndarray, inserts: np.ndarray):
    """(share of pairs whose two primary records are both within PLACE_TOL
    of their simulated starts, share of primary records flagged properly
    paired)."""
    near = set()
    proper = n_primary = 0
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        flag = int(f[1])
        if flag & 0x904:
            continue
        n_primary += 1
        proper += bool(flag & 0x2)
        i, first = int(f[0][1:]), bool(flag & 0x40)
        want = starts[i] if first else starts[i] + inserts[i] - READ_LEN
        if abs(int(f[3]) - 1 - int(want)) <= PLACE_TOL:
            near.add((i, first))
    both = sum((i, True) in near and (i, False) in near for i in range(len(starts)))
    return both / len(starts), proper / max(n_primary, 1)


def paired_params(preset: str):
    """The Illumina Paired preset, or Default with "Use Paired Reads" (the
    command line's -m)."""
    from ma_tpu_torch.config.parameters import ParameterSetManager

    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    mgr.selected.set("Use Paired Reads", True)
    return mgr


def run_pairs(pa, pairs, batch: int):
    """PairedAligner `pa` over `pairs` at `batch` pairs a flush: (SAM, host
    seconds, ending in a device synchronize)."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    n = pa.align_to_sam(iter(pairs), buf, batch_size=batch)
    if pa.aligner.device.type == "cuda":
        torch.cuda.synchronize()
    if n != 2 * len(pairs):
        raise AssertionError(f"PairedAligner.align_to_sam returned {n} of {2 * len(pairs)} reads")
    return buf.getvalue(), time.perf_counter() - t0


def paired_phase(dev, pack, fmd) -> dict:
    """Paired reads on `dev` under Illumina Paired (SMEMs) and Default + -m
    (maxSpan): pairs/s at PAIRED_BATCH (median of PASSES after a warm-up)
    and at CLI_BATCH, placement, proper-pair flags, launches of A, B, C per
    pass; the first CLI_BATCH pairs against the CPU port. Returns each
    kernel's launches in the counted passes."""
    import torch

    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.paired import PairedAligner

    t0 = time.perf_counter()
    pairs, starts, inserts = simulate_pairs(pack, PAIRS, seed=2718)
    print(f"paired workload: {len(pairs)} pairs of 2 x {READ_LEN} bp, insert {INSERT} +- "
          f"{INSERT_SD} ({time.perf_counter() - t0:.1f} s)", flush=True)
    total: dict = {k.name: 0 for k in kernels.KERNELS}
    path = ("soc_sweep", "linesweep", "dp_fused")
    for label, preset in (("Illumina Paired (SMEMs)", "IlluminaPaired"),
                          ("Default + -m (maxSpan)", "Default")):
        def paired(device):
            return PairedAligner(Aligner(pack, paired_params(preset), device=device, fmd=fmd))

        pa = paired(dev)
        _, wall = run_pairs(pa, pairs[:CLI_BATCH], PAIRED_BATCH)
        print(f"paired {label} warm-up: {wall:.1f} s", flush=True)
        reset_launches()
        walls, sam = [], ""
        for _ in range(PASSES):
            sam, wall = run_pairs(pa, pairs, PAIRED_BATCH)
            walls.append(wall)
        launches = read_launches(kernels.KERNELS)
        for name, v in launches.items():
            total[name] += v
        pps = len(pairs) / statistics.median(walls)
        both, proper = paired_placement(sam, starts, inserts)
        per_pass = {k: launches[k] / PASSES for k in path}
        sub = pairs[:1024]
        _, wall = run_pairs(pa, sub, CLI_BATCH)
        print(f"paired {label}: walls {['%.3f' % w for w in walls]} s, {pps:.1f} pairs/s "
              f"(median, {PAIRED_BATCH} pairs a flush), {len(sub) / wall:.1f} pairs/s on "
              f"{len(sub)} pairs at the command line's {CLI_BATCH} a flush; both mates placed "
              f"{both:.4%}, properly paired flag {proper:.4%}; launches per pass "
              f"{json.dumps(per_pass)}", flush=True)
        if min(pps, both, proper, *per_pass.values()) == 0:
            raise AssertionError(f"paired {label}: a zero among pairs/s {pps}, placement {both}, "
                                 f"proper-pair rate {proper}, launches {per_pass}")
        sub = pairs[:CLI_BATCH]
        gpu_sam, _ = run_pairs(pa, sub, CLI_BATCH)
        cpu_sam, wall = run_pairs(paired(torch.device("cpu")), sub, CLI_BATCH)
        print(f"paired cross-check {label}: {len(sub)} pairs, CPU port {wall:.1f} s, SAM "
              f"{len(cpu_sam)} bytes, identical={gpu_sam == cpu_sam}", flush=True)
        if gpu_sam != cpu_sam:
            raise AssertionError(f"paired {label}: GPU and CPU SAM differ at line "
                                 f"{first_diff(gpu_sam, cpu_sam)}")
    return total


def low_complexity_reads(pack, n_reads: int, seed: int, every: int):
    """Reads of READ_LEN bp from the genome at 1% substitutions, odd ones
    reverse complemented; with every > 0, every `every`th has a
    low-complexity span (a 1-4 base unit repeated over 30-60 bases) planted
    in its middle. The host's SDUST takes 0.01-0.4 s for such a read
    (ops/sdust.py, ma_tpu's Python), 0.2 ms for one without."""
    from ma_tpu_torch.containers.nucseq import NucSeq, revcomp_codes

    genome = np.asarray(pack.codes, np.uint8)
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, len(genome) - READ_LEN))
        codes = genome[p : p + READ_LEN].copy()
        for j in np.nonzero(rng.random(READ_LEN) < 0.01)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if every and i % every == 0:
            ln = int(rng.integers(30, 61))
            s0 = int(rng.integers(20, READ_LEN - ln - 20))
            codes[s0 : s0 + ln] = np.resize(rng.integers(0, 4, int(rng.integers(1, 5))), ln)
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq(codes, name=f"s{i}"))
    return reads


def write_fastq(path: str, reads) -> None:
    from ma_tpu_torch.containers.nucseq import decode_seq

    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{decode_seq(r.codes)}\n+\n{'I' * len(r)}\n")


def run_cli(args, timeout: int = 600):
    """`python -X importtime -m ma_tpu_torch.cli *args` in a subprocess:
    (seconds, stderr without the import lines). Fails on a non-zero exit
    or a jax or ma_tpu module among its imports."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-X", "importtime", "-m", "ma_tpu_torch.cli", *args],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = res.stderr.splitlines()
    mods = [ln.rsplit("|", 1)[1].strip() for ln in lines if ln.startswith("import time:")]
    rest = "\n".join(ln for ln in lines if not ln.startswith("import time:"))
    if res.returncode != 0:
        raise AssertionError(f"ma_tpu_torch.cli {args[:2]} exited {res.returncode}:\n"
                             f"{rest[-3000:]}")
    bad = sorted({m for m in mods if m.split(".")[0] in ("jax", "ma_tpu")})
    if bad:
        raise AssertionError(f"ma_tpu_torch.cli {args[:2]} imported {bad}")
    if "ma_tpu_torch.config.parameters" not in mods:
        raise AssertionError("python -X importtime listed none of the port's imports")
    return wall, rest


def flag_params(flags):
    """The Default preset with `flags` (--Name value pairs, a bare last
    --Name for a boolean) set on it."""
    from ma_tpu_torch.config.parameters import ParameterSetManager

    mgr = ParameterSetManager()
    for i in range(0, len(flags), 2):
        mgr.selected[flags[i][2:]].set(flags[i + 1] if i + 1 < len(flags) else True)
    return mgr


def cli_phase(dev, pack) -> dict:
    """The command line in subprocesses (index, paired -m, SDUST, NGMLR
    tags), each SAM against the in-process CPU port's; then the minimizer,
    SDUST and NGMLR passes on the card in this process. Returns each
    kernel's launches in the counted passes."""
    import torch

    from ma_tpu_torch import kernels
    from ma_tpu_torch.containers.nucseq import decode_seq
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.io.fasta import read_reads, zip_paired
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.paired import PairedAligner

    pairs, _, _ = simulate_pairs(pack, CLI_READS, seed=1618)
    reads = low_complexity_reads(pack, BATCH, seed=37, every=0)
    total: dict = {k.name: 0 for k in kernels.KERNELS}
    with tempfile.TemporaryDirectory() as d:
        fa, idx = os.path.join(d, "genome.fa"), os.path.join(d, "bench")
        seq = decode_seq(np.asarray(pack.codes, np.uint8))
        with open(fa, "w") as f:
            f.write(">bench\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80))
                    + "\n")
        write_fastq(os.path.join(d, "r1.fq"), [p[0] for p in pairs])
        write_fastq(os.path.join(d, "r2.fq"), [p[1] for p in pairs])
        write_fastq(os.path.join(d, "s.fq"), low_complexity_reads(pack, CLI_READS, seed=31,
                                                                  every=4))
        wall, _ = run_cli(["--Create_Index", f"{fa},{d},bench"])
        print(f"cli --Create_Index: {wall:.1f} s for {len(seq)} bp (subprocess, start-up "
              f"included)", flush=True)

        sdust = ["--Seeding_Technique", "minimizers", "--Minimizers_-_SDUST_Threshold",
                 str(SDUST_T)]
        ngmlr = ["--Seeding_Technique", "minimizers", "--Emulate_NGMLR's_tag_output"]
        runs = {
            "paired": (["-x", idx, "-i", f"{d}/r1.fq", "-m", f"{d}/r2.fq"], []),
            "sdust": (["-p", "Default", "-x", idx, "-i", f"{d}/s.fq"], sdust),
            "ngmlr": (["-x", idx, "-i", f"{d}/s.fq"], ngmlr),
        }
        pack_i, fmd_i = Pack.load(idx), FMDIndex.load(idx)
        for name, (io_flags, flags) in runs.items():
            args = io_flags + ["-o", f"{d}/{name}.sam"] + flags
            wall, err = run_cli(args + ["--Device", "cuda"])
            with open(f"{d}/{name}.sam") as f:
                card = f.read()
            mgr = flag_params(flags)
            mgr.selected.set("Use Paired Reads", name == "paired")  # -m sets it
            al = Aligner(pack_i, mgr, device="cpu", fmd=fmd_i, index_prefix=idx)
            buf = io.StringIO()
            t0 = time.perf_counter()
            cmd = "ma-tpu " + " ".join(args)  # the @PG command, --Device left out
            if name == "paired":
                PairedAligner(al).align_to_sam(
                    zip_paired(read_reads(f"{d}/r1.fq"), read_reads(f"{d}/r2.fq")), buf, cmd=cmd)
            else:
                al.align_to_sam(read_reads(f"{d}/s.fq"), buf, cmd=cmd)
            cpu_wall = time.perf_counter() - t0
            done = re.search(r"done\. .*", err)
            print(f"cli {name}: subprocess {wall:.1f} s ({done.group(0) if done else err[-200:]}), "
                  f"CPU port in process {cpu_wall:.1f} s, SAM {len(card)} bytes, "
                  f"identical={card == buf.getvalue()}", flush=True)
            if card != buf.getvalue():
                raise AssertionError(f"cli {name}: the card's SAM differs from the CPU port's at "
                                     f"line {first_diff(card, buf.getvalue())}")

        # ---- the SDUST and NGMLR passes on the card, against the plain
        # minimizer pass, on BATCH reads without planted spans, counted
        rates = {}
        for name, flags in (("minimizers", ["--Seeding_Technique", "minimizers"]),
                            ("sdust", sdust), ("ngmlr", ngmlr)):
            al = Aligner(pack_i, flag_params(flags), device=dev, index_prefix=idx)
            al.align_to_sam(iter(reads[:CLI_BATCH]), io.StringIO(), batch_size=BATCH)
            reset_launches()
            walls = []
            for _ in range(PASSES):
                t0 = time.perf_counter()
                n = al.align_to_sam(iter(reads), io.StringIO(), batch_size=BATCH)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if n != len(reads):
                    raise AssertionError(f"cli {name}: {n} of {len(reads)} reads")
            launches = read_launches(kernels.KERNELS)
            for k, v in launches.items():
                total[k] += v
            rates[name] = len(reads) / statistics.median(walls)
            per_pass = {k: launches[k] / PASSES for k in ("soc_sweep", "linesweep", "dp_fused")}
            print(f"cli pass {name}: walls {['%.3f' % w for w in walls]} s, {rates[name]:.1f} "
                  f"reads/s (median), launches per pass {json.dumps(per_pass)}", flush=True)
            if min(per_pass.values()) == 0:
                raise AssertionError(f"cli pass {name} did not run kernels A, B, C: {per_pass}")
        print(f"cli rates: SDUST {rates['sdust'] / rates['minimizers']:.3f} and NGMLR "
              f"{rates['ngmlr'] / rates['minimizers']:.3f} of the minimizer pass", flush=True)
    return total


def simulate_sv():
    """scripts/sv_bench.py's workload, drawn as that script draws it: a
    random reference, max(20, G // 500,000) deletions, insertions and
    inversions of 100-2,000 bp at sorted sites in its middle 80%, and
    reads of the donor at 0.2% substitutions, every second one reverse
    complemented. Returns (ref codes, svs as (kind, ref pos, size, donor
    pos), reads)."""
    from ma_tpu_torch.containers.nucseq import NucSeq

    rng = np.random.default_rng(SV_SEED)
    G, n_reads, read_len = SV_GENOME_BP, SV_READS, SV_READ_LEN
    ref = rng.integers(0, 4, size=G).astype(np.uint8)
    n_sv = max(20, G // 500_000)
    sites = np.sort(rng.choice(np.arange(G // 10, G - G // 10), n_sv, replace=False))
    parts, svs, cur, dpos = [], [], 0, 0
    for p in sites:
        p = int(p)
        kind = rng.choice(["del", "ins", "inv"])
        size = int(rng.integers(100, 2000))
        parts.append(ref[cur:p])
        dpos += p - cur
        svs.append((str(kind), p, size, dpos))
        if kind == "del":
            cur = p + size
        elif kind == "ins":
            parts.append(rng.integers(0, 4, size=size).astype(np.uint8))
            dpos += size
            cur = p
        else:
            parts.append((3 - ref[p : p + size])[::-1])
            dpos += size
            cur = p + size
    parts.append(ref[cur:])
    donor = np.concatenate(parts)
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, len(donor) - read_len))
        codes = donor[p : p + read_len].copy()
        err = rng.random(read_len) < 0.002
        codes[err] = (codes[err] + rng.integers(1, 4, err.sum())) % 4
        if i % 2:
            codes = (3 - codes)[::-1]
        reads.append(NucSeq(codes.astype(np.uint8), name=f"r{i}"))
    return ref, svs, donor, reads


def sv_recall(calls, svs) -> int:
    """Implanted SVs with a call within SV_RECALL_TOL bp (sv_bench.py's count)."""
    pts = (np.asarray([(c.from_pos, c.to_pos) for c in calls], np.int64) if calls
           else np.zeros((0, 2), np.int64))
    return sum(1 for (_, p, _, _) in svs if len(pts) and (np.abs(pts - p) < SV_RECALL_TOL).any())


def sv_pass(reads, pack, mmi, dev):
    """One compute_sv_jumps_batch pass on `dev` under MA_TPU_SV_PROFILE,
    ending in a synchronize: (JumpBatch, wall s, its phase line)."""
    import torch

    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch

    err = io.StringIO()
    os.environ["MA_TPU_SV_PROFILE"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            jb = compute_sv_jumps_batch(reads, pack, mmi, batch=SV_BATCH, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del os.environ["MA_TPU_SV_PROFILE"]
    phases = [ln for ln in err.getvalue().splitlines() if ln.startswith("# sv phases:")]
    return jb, wall, phases[-1][len("# sv phases: "):]


def jump_columns_equal(a, b) -> bool:
    cols = ("from_pos", "to_pos", "query_from", "query_to", "from_forward", "to_forward",
            "num_supporting_nt", "read_id", "was_mirrored", "id")
    return len(a) == len(b) and all(np.array_equal(getattr(a, c), getattr(b, c)) for c in cols)


def call_rows(calls):
    return [(c.from_pos, c.to_pos, c.from_size, c.to_size, c.from_forward, c.to_forward,
             c.supp_reads, c.supp_nt, tuple(c.supporting_jump_ids)) for c in calls]


SV_WINDOWS = 6  # genome sections of jumps_in_section held against a brute filter


def db_bytes(d: str) -> int:
    """Bytes of the SQLite files in d (the database and its write-ahead log)."""
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def every_field(calls):
    """Every field of each SvCall, the inserted sequence as a list."""
    import dataclasses

    return [tuple(v.tolist() if isinstance(v, np.ndarray) else v
                  for v in dataclasses.astuple(c)) for c in calls]


def svdb_case(jb, calls) -> None:
    """The pass's jumps through an SvDb file (msv/sv_db.py, SQLite): insert,
    the R*Tree index, load, and the sweep of the loaded jumps, each timed.
    The loaded jumps must equal the stored ones in every field but the id
    (the row's, in insertion order), their calls the in-memory sweep's
    `calls` with each supporting jump id mapped to its row; jumps_in_section
    must equal a brute filter of the columns on a few windows; the calls
    must come back from insert_calls / load_calls / calls_overlapping."""
    import dataclasses

    from ma_tpu_torch.msv.pipeline import sweep_sv_jumps
    from ma_tpu_torch.msv.sv_db import SvDb

    t0 = time.perf_counter()
    stored = jb.to_jumps()
    t_obj = time.perf_counter() - t0
    fields = ("from_pos", "to_pos", "query_from", "query_to", "from_forward", "to_forward",
              "num_supporting_nt", "read_id", "was_mirrored")
    row = lambda j: tuple(getattr(j, f) for f in fields)  # noqa: E731
    with tempfile.TemporaryDirectory() as d, SvDb(os.path.join(d, "sv.db")) as sv:
        run = sv.new_run("msv pass")
        t0 = time.perf_counter()
        sv.insert_jumps(run, stored)
        t_ins = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv.create_jump_indices(run)
        t_idx = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = sv.load_jumps(run, params=jb.params)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        db_calls = sweep_sv_jumps(loaded)
        t_sweep = time.perf_counter() - t0
        n = len(stored)
        print(f"msv svdb: {n} jumps, insert {t_ins:.3f} s ({n / t_ins:.1f} jumps/s), R*Tree "
              f"index {t_idx:.3f} s ({n / t_idx:.1f} jumps/s), load {t_load:.3f} s "
              f"({n / t_load:.1f} jumps/s), {db_bytes(d)} bytes on disk; JumpBatch.to_jumps "
              f"{t_obj:.3f} s; sweep of the loaded jumps "
              f"{t_sweep:.3f} s", flush=True)
        if len(loaded) != n or any(row(a) != row(b) for a, b in zip(stored, loaded)):
            raise AssertionError("msv svdb: the loaded jumps differ from the stored ones")
        to_row = {j.id: r.id for j, r in zip(stored, loaded)}
        if len(to_row) != n or sorted(to_row.values()) != list(range(1, n + 1)):
            raise AssertionError("msv svdb: the row ids are not 1..N in insertion order")
        want = [dataclasses.replace(c, supporting_jump_ids=[to_row[i] for i in
                                                            c.supporting_jump_ids])
                for c in calls]
        if every_field(db_calls) != every_field(want):
            raise AssertionError("msv svdb: the loaded jumps' calls differ from the in-memory "
                                 "sweep's")

        lo = np.minimum(jb.from_pos, jb.to_pos)
        hi = np.maximum(jb.from_pos, jb.to_pos)
        rows_of = np.asarray([to_row[int(i)] for i in jb.id], np.int64)
        rng = np.random.default_rng(SV_SEED + 2)
        counts = []
        for a in rng.integers(0, SV_GENOME_BP - 100_000, SV_WINDOWS):
            a, b = int(a), int(a) + int(rng.integers(1_000, 100_000))
            sel = np.flatnonzero((lo < b) & (hi >= a))
            brute = sorted(zip(lo[sel].tolist(), rows_of[sel].tolist()))
            got = [(min(j.from_pos, j.to_pos), j.id) for j in sv.jumps_in_section(run, a, b)]
            if got != brute:
                raise AssertionError(f"msv svdb: jumps_in_section({a}, {b}) differs from the "
                                     f"brute filter ({len(got)} against {len(brute)})")
            counts.append(len(got))

        ids = sv.insert_calls(run, db_calls)
        sv.create_call_indices(run)
        back = sv.load_calls(run)
        sorted_support = [dataclasses.replace(c, supporting_jump_ids=sorted(
            c.supporting_jump_ids)) for c in db_calls]  # load_calls sorts them (ma_tpu's)
        with_ids = [dataclasses.replace(c, id=i) for c, i in zip(sorted_support, ids)]
        if every_field(back) != every_field(with_ids):
            raise AssertionError("msv svdb: insert_calls / load_calls changed the calls")
        for c, i in zip(db_calls, ids):
            hit = sv.calls_overlapping(run, c.from_pos, c.from_pos + c.from_size + 1, c.to_pos,
                                       c.to_pos + c.to_size + 1)
            if i not in [h.id for h in hit]:
                raise AssertionError(f"msv svdb: calls_overlapping misses call {i}")
        print(f"msv svdb: {len(db_calls)} calls equal the in-memory sweep's; jumps_in_section on "
              f"{SV_WINDOWS} windows ({counts} jumps) equal the brute filter; the calls came back "
              f"from load_calls and calls_overlapping", flush=True)


def msv_soc_inputs(reads, pack, mmi, dev):
    """Kernel A's operands as the MSV seed stage gives them on its first
    chunk (B = 512, S = 2,048 seed slots, K = 64, non-rectangular)."""
    import torch

    from ma_tpu_torch.index.minimizer import minimizer_seeding
    from ma_tpu_torch.msv.pipeline import MAX_SEEDS, MAX_SOCS
    from ma_tpu_torch.ops.filters import min_length, seed_lump
    from ma_tpu_torch.ops.soc import soc_candidates

    chunk = reads[:SV_BATCH]
    seqs = np.full((len(chunk), 1024), 4, np.uint8)
    for i, r in enumerate(chunk):
        seqs[i, : len(r)] = r.codes
    seqs = torch.as_tensor(seqs, device=dev)
    lens = torch.as_tensor([len(r) for r in chunk], dtype=torch.int32, device=dev)
    cst = torch.as_tensor(np.asarray(pack.starts, np.int32), device=dev)
    seeds = minimizer_seeding(mmi.to_device(dev), seqs, lens, cst,
                              pack.unpacked_size_forward_strand, k=mmi.k, w=mmi.w,
                              max_occ=10000, max_seeds=MAX_SEEDS, rectangular=False)
    seeds = min_length(seed_lump(seeds), 18)
    sd, cand, min_score = soc_candidates(seeds, lens, cst, rectangular=False)
    return cand, sd.n_seeds.contiguous(), min_score, MAX_SOCS


def connector_case(calls, jumps, reads, pack, dev, records, roof) -> int:
    """connector_pattern_filter on the card over `calls`: kernel D's scores
    against its plain version on the same inputs, D's time at that shape
    against its bound (every cell of the direction tensor at
    DP_OPS_PER_CELL ops), the kept calls against the CPU port's. Returns
    D's launches in the filter's run."""
    import ma_tpu_torch.msv.connector as conn
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront_plain

    seen, orig = [], conn.banded_align

    def spy(*a, **kw):
        res = orig(*a, **kw)
        seen.append((a, kw, res))
        return res

    conn.banded_align = spy
    try:
        before = kernels.DP_WAVEFRONT.launches
        t0 = time.perf_counter()
        kept = conn.connector_pattern_filter(calls, jumps, reads, pack, device=dev)
        wall = time.perf_counter() - t0
        launches = kernels.DP_WAVEFRONT.launches - before
        cpu = conn.connector_pattern_filter(calls, jumps, reads, pack, device="cpu")
    finally:
        conn.banded_align = orig
    (args, kw, res), = seen[:1]
    q, t, ql, tl, bd, params = args
    plain = banded_align_wavefront_plain(q, t, ql, tl, bd, params, kw["zdrop"], kw["is_global"])
    err = max_abs_err([res.score, res.max_i, res.max_j, res.zdropped],
                      [plain.score, plain.max_i, plain.max_j, plain.zdropped])
    run = lambda: orig(q, t, ql, tl, bd, params, **kw)  # noqa: E731
    ms = time_ms(run, 10)
    replay = graph_ms(run, calls=5)
    pms = time_ms(lambda: banded_align_wavefront_plain(q, t, ql, tl, bd, params, kw["zdrop"],
                                                       kw["is_global"]), 1)
    P, M = q.shape
    N = t.shape[1]
    cells = P * (M + N - 1) * M
    bnd = roof.bound(nbytes(q, t, ql, tl, bd) + nbytes(*res), cells * DP_OPS_PER_CELL)
    print(f"msv connector: {len(calls)} calls -> {len(kept)} kept in {wall:.2f} s (card), the "
          f"CPU port's equal: {call_rows(kept) == call_rows(cpu)}; dp_wavefront launches "
          f"{launches}, P={P} M={M} N={N} local z-drop {kw['zdrop']} band 100, scores "
          f"max_abs_err={err} against the plain version; kernel {ms:.4f} ms by events, "
          f"{replay:.4f} ms by graph replay, plain {pms:.3f} ms; bound {bnd['bound_ms']:.5f} ms "
          f"({bnd['bound_by']}, {cells} cells x {DP_OPS_PER_CELL} ops), "
          f"{bnd['bound_ms'] / replay:.1%} of the replay time", flush=True)
    if err or call_rows(kept) != call_rows(cpu):
        raise AssertionError("msv connector: the card's D scores or kept calls differ")
    if not launches:
        raise AssertionError("msv connector: kernel D never launched")
    records["dp_wavefront_connector"] = dict(max_abs_err=err, ms=replay, eager_ms=ms,
                                             plain_ms=pms, **bnd)
    return launches


def sv_cli_files(ref, svs, donor, d: str):
    """A SV_CLI_BP slice of the SV reference, from 100 kb before the first
    SV past its middle, as FASTA (d/sv.fa), and SV_CLI_READS reads of the
    donor, each crossing the left breakpoint of an SV inside the slice
    (d/sv.fq). Returns the number of SVs inside."""
    from ma_tpu_torch.containers.nucseq import decode_seq

    at = next(p for _, p, _, _ in svs if p >= len(ref) // 2) - 100_000
    inside = [sv for sv in svs if at + 5_000 <= sv[1] <= at + SV_CLI_BP - 5_000]
    seq = decode_seq(ref[at : at + SV_CLI_BP])
    with open(os.path.join(d, "sv.fa"), "w") as f:
        f.write(">chrS\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
    rng = np.random.default_rng(SV_SEED + 1)
    with open(os.path.join(d, "sv.fq"), "w") as f:
        for i in range(SV_CLI_READS):
            _, _, _, dp = inside[i % len(inside)]
            p = dp - int(rng.integers(100, SV_READ_LEN - 100))
            codes = donor[p : p + SV_READ_LEN].copy()
            if i % 2:
                codes = (3 - codes)[::-1]
            f.write(f"@c{i}\n{decode_seq(codes)}\n+\n{'I' * SV_READ_LEN}\n")
    return len(inside)


def msv_phase(dev, records, roof):
    """The MSV caller at scripts/sv_bench.py's size on the card; returns
    each kernel's launches in the counted passes (A) and in the connector's
    run (D), the workload (reference, SVs, donor) for the gui phase, and
    (pack, minimizer index, reads) for the parallel phase."""
    import torch

    from ma_tpu_torch import kernels
    from ma_tpu_torch.cli import main as cli_main
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch, sweep_sv_jumps

    t0 = time.perf_counter()
    ref, svs, donor, reads = simulate_sv()
    print(f"msv workload: reference {SV_GENOME_BP} bp, {len(svs)} SVs implanted "
          f"({', '.join(f'{k} {sum(s[0] == k for s in svs)}' for k in ('del', 'ins', 'inv'))}), "
          f"{len(reads)} reads x {SV_READ_LEN} bp ({time.perf_counter() - t0:.1f} s)", flush=True)
    pack = Pack.empty()
    pack.append("chrS", ref)
    t0 = time.perf_counter()
    mmi = MinimizerIndex.build(pack)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    mmi.to_device(dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    print(f"msv index: {len(mmi.hash_sorted)} minimizers, build {t_build:.2f} s (host), CHD + "
          f"upload {t_up:.2f} s", flush=True)

    t0 = time.perf_counter()
    compute_sv_jumps_batch(reads[:SV_BATCH], pack, mmi, device=dev)
    torch.cuda.synchronize()
    print(f"msv warm-up: {SV_BATCH} reads in {time.perf_counter() - t0:.2f} s", flush=True)

    reset_launches()
    runs = [sv_pass(reads, pack, mmi, dev)]
    if runs[0][1] < SV_THREE_PASSES_BELOW_S:
        runs += [sv_pass(reads, pack, mmi, dev) for _ in range(PASSES - 1)]
    launches = read_launches(kernels.KERNELS)
    jb = runs[-1][0]
    walls = [w for _, w, _ in runs]
    wall = statistics.median(walls)
    t0 = time.perf_counter()
    calls = sweep_sv_jumps(jb)
    t_sweep = time.perf_counter() - t0
    hit = sv_recall(calls, svs)
    a_per_pass = launches["soc_sweep"] / len(runs)
    how = (f"median of {len(runs)} passes" if len(runs) > 1 else
           f"1 timed pass (the first took {walls[0]:.1f} s, past {SV_THREE_PASSES_BELOW_S} s)")
    print(f"msv: walls {['%.2f' % w for w in walls]} s ({how}); jumps={len(jb)} "
          f"calls={len(calls)} sv_recall {hit}/{len(svs)}; {len(reads) / wall:.1f} reads/s and "
          f"{len(jb) / wall:.1f} jumps/s (jumps), {len(reads) / (wall + t_sweep):.1f} reads/s "
          f"and {len(jb) / (wall + t_sweep):.1f} jumps/s end to end with the sweep "
          f"({t_sweep:.2f} s, {len(jb) / max(t_sweep, 1e-9):.1f} jumps/s)", flush=True)
    for i, (_, w, ph) in enumerate(runs):
        print(f"msv pass {i}: {w:.2f} s, phases: {ph}", flush=True)
    svdb_case(jb, calls)
    print(f"msv launches per pass: soc_sweep {a_per_pass:g} (chunks of {SV_BATCH}: "
          f"{-(-len(reads) // SV_BATCH)}); {json.dumps(launches)}", flush=True)
    if not (len(jb) and calls and hit and a_per_pass):
        raise AssertionError(f"msv: jumps {len(jb)}, calls {len(calls)}, recall {hit}, "
                             f"kernel A launches {a_per_pass}")

    # ---- the first SV_CHECK_READS reads on the card against the CPU port
    sub = reads[:SV_CHECK_READS]
    t0 = time.perf_counter()
    cpu_jb = compute_sv_jumps_batch(sub, pack, mmi, device="cpu")
    cpu_wall = time.perf_counter() - t0
    gpu_jb = compute_sv_jumps_batch(sub, pack, mmi, device=dev)
    same_j = jump_columns_equal(gpu_jb, cpu_jb)
    same_c = call_rows(sweep_sv_jumps(gpu_jb, min_reads=1)) == call_rows(
        sweep_sv_jumps(cpu_jb, min_reads=1))
    print(f"msv cross-check: {len(sub)} reads, {len(cpu_jb)} jumps, CPU port {cpu_wall:.1f} s; "
          f"JumpBatch identical={same_j}, calls identical={same_c}", flush=True)
    if not (same_j and same_c and len(cpu_jb)):
        raise AssertionError("msv: the card's jumps or calls differ from the CPU port's")

    # ---- kernel A at the MSV shape; the connector's DP (kernel D) on the card
    soc_case("soc_sweep_msv", *msv_soc_inputs(reads, pack, mmi, dev), records, roof,
             plain_reps=1)
    d_launches = connector_case(calls, jb.to_jumps(), reads, pack, dev, records, roof)

    # ---- --Sv from the command line, in a subprocess, against the CPU port
    with tempfile.TemporaryDirectory() as d:
        n_in = sv_cli_files(ref, svs, donor, d)
        wall, _ = run_cli(["--Create_Index", f"{d}/sv.fa,{d},sv"])
        print(f"msv cli --Create_Index: {wall:.1f} s for {SV_CLI_BP} bp", flush=True)
        flags = ["-x", f"{d}/sv", "-i", f"{d}/sv.fq", "--Sv"]
        wall, err = run_cli(flags + ["-o", f"{d}/card.tsv", "--Device", "cuda"])
        done = re.search(r"done\. .*", err)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(flags + ["-o", f"{d}/cpu.tsv", "--Device", "cpu"])
        cpu_wall = time.perf_counter() - t0
        same = [open(f"{d}/card.tsv{s}", "rb").read() == open(f"{d}/cpu.tsv{s}", "rb").read()
                for s in ("", ".html", ".view.html")]
        n_calls = len(open(f"{d}/card.tsv").read().splitlines()) - 1
        print(f"msv cli --Sv: {SV_CLI_READS} reads over {n_in} SVs, subprocess {wall:.1f} s "
              f"({done.group(0) if done else err[-200:]}), CPU port in process {cpu_wall:.1f} s "
              f"(rc {rc}); {n_calls} calls; tsv/html/view.html identical {same}", flush=True)
        if rc or not all(same) or n_calls < 1:
            raise AssertionError("msv cli: the card's --Sv files differ from the CPU port's")
    return ({"soc_sweep": launches["soc_sweep"], "dp_wavefront": d_launches},
            (ref, svs, donor), (pack, mmi, reads))


class GuiServer:
    """The port's web console (ma_tpu_torch/gui.py) served from this process
    on 127.0.0.1 at an ephemeral port; `act` posts one action and returns
    (wall s, its log lines) once the action's worker thread is done."""

    def __enter__(self):
        import threading
        from http.server import ThreadingHTTPServer

        from ma_tpu_torch import gui

        self.gui = gui
        gui._state.update(mgr=None, log=[], busy=False)
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), gui._Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()
        return False

    def act(self, form: dict, timeout: float = 600):
        import urllib.parse
        import urllib.request

        gui = self.gui
        with gui._lock:
            if gui._state["busy"]:
                raise AssertionError("gui: an action is still running")
            gui._state["log"] = []
        t0 = time.perf_counter()
        urllib.request.urlopen(self.url + "/run", data=urllib.parse.urlencode(form).encode(),
                               timeout=60).read()
        while True:
            with gui._lock:
                if not gui._state["busy"]:
                    break
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"gui: {form['action']} still running after {timeout} s")
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        with gui._lock:
            log = list(gui._state["log"])
        # _run_action swallows exceptions so the server stays up: the rc is
        # read from the log, and anything but [done rc=0] fails the phase
        if not log or log[-1] != "[done rc=0]":
            raise AssertionError(f"gui: {form['action']} did not end with rc 0:\n"
                                 + "\n".join(log[-20:]))
        return wall, log


def same_files(a: str, b: str, suffixes) -> list:
    return [open(a + s, "rb").read() == open(b + s, "rb").read() for s in suffixes]


def gui_phase(dev, pack, sv_work) -> None:
    """Three actions posted to the port's web console, all on cuda: index
    the bench genome, align CLI_READS single-end reads (Default preset), and
    call SVs (--Sv) on the msv phase's 2 Mbp slice and its reads. Each must
    log rc 0, and its files must equal those of cli.main run in this process
    with the same arguments and `--Device cuda`. Kernels A, B and C must
    launch in the align action (their counts are printed, not summed into
    the kernels record); both SAM files are read back through
    io/sam_reader.py."""
    import torch

    from ma_tpu_torch import kernels
    from ma_tpu_torch.cli import main as cli_main
    from ma_tpu_torch.containers.nucseq import decode_seq
    from ma_tpu_torch.io.sam_reader import read_sam

    ref, svs, donor = sv_work
    with tempfile.TemporaryDirectory() as d, GuiServer() as server:
        fa = os.path.join(d, "genome.fa")
        seq = decode_seq(np.asarray(pack.codes, np.uint8))
        with open(fa, "w") as f:
            f.write(">bench\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80))
                    + "\n")
        write_fastq(os.path.join(d, "r.fq"), low_complexity_reads(pack, CLI_READS, seed=43,
                                                                  every=0))
        wall, _ = server.act({"action": "index", "device": "cuda", "fasta": fa, "outdir": d,
                              "name": "gui"})
        print(f"gui index: {wall:.1f} s for {len(seq)} bp", flush=True)

        idx = os.path.join(d, "gui")
        form = {"action": "align", "preset": "Default", "device": "cuda", "index": idx,
                "reads": os.path.join(d, "r.fq"), "out": os.path.join(d, "gui.sam")}
        reset_launches()
        wall, log = server.act(form)
        torch.cuda.synchronize()
        launches = read_launches((kernels.SOC_SWEEP, kernels.LINESWEEP, kernels.DP_FUSED))
        print(f"gui align launches (not in the kernels record): {json.dumps(launches)}",
              flush=True)
        if min(launches.values()) == 0:
            raise AssertionError(f"gui align did not run kernels A, B, C: {launches}")
        args = log[0][len("$ ma_tpu "):].split(" ")
        want = ["-x", idx, "-i", form["reads"], "-o", form["out"], "--Device", "cuda"]
        if args != want:
            raise AssertionError(f"gui align ran {args}, not {want}")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(want[:5] + [os.path.join(d, "cli.sam")] + want[6:])
        cli_wall = time.perf_counter() - t0
        same = same_files(os.path.join(d, "gui"), os.path.join(d, "cli"), (".sam",))
        n_gui = sum(1 for _ in read_sam(os.path.join(d, "gui.sam")))
        n_cli = sum(1 for _ in read_sam(os.path.join(d, "cli.sam")))
        print(f"gui align: {CLI_READS} reads, action {wall:.1f} s, cli.main {cli_wall:.1f} s "
              f"(rc {rc}); SAM identical {same[0]}; sam_reader: {n_gui} mapped records "
              f"({n_cli} in cli.main's)", flush=True)
        if rc or not same[0] or n_gui != n_cli or n_gui < CLI_READS * 0.99:
            raise AssertionError("gui align: the SAM differs from cli.main's")

        n_in = sv_cli_files(ref, svs, donor, d)
        with contextlib.redirect_stderr(io.StringIO()):
            if cli_main(["--Create_Index", f"{d}/sv.fa,{d},sv"]):
                raise AssertionError("gui: --Create_Index of the SV slice failed")
        form = {"action": "sv", "device": "cuda", "index": f"{d}/sv", "reads": f"{d}/sv.fq",
                "out": f"{d}/gui.tsv"}
        wall, log = server.act(form)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["--Sv", "-x", f"{d}/sv", "-i", f"{d}/sv.fq", "-o", f"{d}/cli.tsv",
                           "--Device", "cuda"])
        cli_wall = time.perf_counter() - t0
        same = same_files(f"{d}/gui.tsv", f"{d}/cli.tsv", ("", ".html", ".view.html"))
        n_calls = len(open(f"{d}/gui.tsv").read().splitlines()) - 1
        print(f"gui sv: {SV_CLI_READS} reads over {n_in} SVs, action {wall:.1f} s, cli.main "
              f"{cli_wall:.1f} s (rc {rc}); {n_calls} calls; tsv/html/view.html identical "
              f"{same}", flush=True)
        if rc or not all(same) or n_calls < 1:
            raise AssertionError("gui sv: the files differ from cli.main's")


def seed_keys(sb) -> np.ndarray:
    """[B, S] int64: each read's valid seeds as sortable keys (reference
    position, strand, query position, length), sorted, invalid slots last:
    equal rows are equal seed multisets."""
    key = ((sb["ref_start"].astype(np.int64) * 2 + sb["on_forward"]) * 2048
           + sb["q_start"]) * 64 + sb["length"]
    return np.sort(np.where(sb["valid"], key, np.iinfo(np.int64).max), axis=1)


def mm_fault_hashes(mmi, world: int, max_occ: int) -> list:
    """The hashes where hash-range sharding changes ma_tpu's seeds (ROADMAP
    Queue 3): the last entry's, which the last shard's pads repeat, and any
    hash whose occurrences straddle a shard boundary while the whole index
    holds more than max_occ of them."""
    hs = mmi.hash_sorted
    n = len(hs)
    per = -(-n // world)
    out = [int(hs[-1])] if world * per > n else []
    for b in range(per, n, per):
        if hs[b - 1] == hs[b]:
            occ = int(np.searchsorted(hs, hs[b], "right") - np.searchsorted(hs, hs[b], "left"))
            if occ > max_occ:
                out.append(int(hs[b]))
    return out


def parallel_phase(dev, bench, fmd, sv_index) -> dict:
    """ma_tpu_torch/parallel/ on the card, every rank a process of
    `python -m ma_tpu_torch.parallel.worker` under its own time limits:
    NCCL as one rank on cuda:0; then PAR_WORLD ranks, sharing cuda:0 over
    gloo (a card each over NCCL where there are enough cards), for the
    cross-rank sum and a probe of what the backend takes, sharded minimizer
    seeding of PAR_MM_READS msv reads over the msv phase's 50 Mbp index
    (its seeds against the single-device lookup's on the card and, for the
    first PAR_CPU_MM_READS reads, the same worker's on the CPU), sharded FMD
    seeding of PAR_FMD_READS bench reads over the FMD phase's index (both
    techniques, against the single-device path on the card), and the
    data-parallel alignment of the bench reads, split in two FASTQ files by
    shard_paths (the merged SAM against one process's, reads/s of both).
    Prints one JSON line {"parallel": ...}; raises on any failed check after
    it. Returns kernels A, B and C's launches in the ranks' alignment."""
    import torch

    from ma_tpu_torch.index.minimizer import MinimizerIndex, _sketch_arrays, minimizer_seeding
    from ma_tpu_torch.io.fasta import read_reads
    from ma_tpu_torch.ops.extract import extract_seeds
    from ma_tpu_torch.ops.occ import FMDDev
    from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding
    from ma_tpu_torch.parallel.multihost import merge_sam_shards
    from ma_tpu_torch.parallel.worker import run_ranks

    pack, reads, aligner = bench
    sv_pack, sv_mmi, sv_reads = sv_index
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards >= PAR_WORLD:
        devices, backend = [f"cuda:{r}" for r in range(PAR_WORLD)], "nccl"
    else:
        devices, backend = ["cuda:0"] * PAR_WORLD, "gloo"
    print(f"parallel: {PAR_WORLD} ranks on {devices} over {backend} ({n_cards} card(s)); "
          f"NCCL first as one rank on cuda:0", flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    run = dict(timeout=PAR_TIMEOUT, env=env)
    checks: dict = {}
    line: dict = {"backend": backend, "world": PAR_WORLD, "devices": devices,
                  "device_count": n_cards, "checks": checks}
    with tempfile.TemporaryDirectory() as d, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        # ---- 1. NCCL, one rank on cuda:0: init, all_reduce, all_gather,
        # while this process stores the inputs of the ranks below
        os.mkdir(f"{d}/nccl")
        t_nccl = time.perf_counter()
        nccl = pool.submit(run_ranks, 1, f"{d}/nccl", "psum", devices=["cuda:0"],
                           backend="nccl", wall_timeout=120, **run)

        # ---- the earlier phases' indexes, stored once for the ranks
        t0 = time.perf_counter()
        w = f"{d}/ranks"
        os.mkdir(w)
        pack.store(f"{w}/g")
        MinimizerIndex.build(pack).store(f"{w}/g")  # the short phase keeps only its device form
        fmd.store(f"{w}/f")
        sv_mmi.store(f"{w}/sv")
        half = len(reads) // PAR_WORLD
        for r_ in range(PAR_WORLD):
            write_fastq(f"{w}/reads{r_}.fq", reads[r_ * half:(r_ + 1) * half])
        mm_seqs = np.stack([r_.codes for r_ in sv_reads[:PAR_MM_READS]])
        mm_lens = np.full(len(mm_seqs), mm_seqs.shape[1], np.int32)
        mm_case = dict(contig_starts=np.asarray(sv_pack.starts, np.int32),
                       ref_len_forward=sv_pack.unpacked_size_forward_strand, k=15, w=10,
                       max_occ=PAR_MAX_OCC, max_seeds_per_shard=PAR_MM_SLOTS)
        np.savez(f"{w}/seed-mm-sv.npz", index="sv", seqs=mm_seqs, lens=mm_lens, **mm_case)
        f_seqs = np.stack([r_.codes for r_ in reads[:PAR_FMD_READS]])
        f_lens = np.full(len(f_seqs), f_seqs.shape[1], np.int32)
        np.savez(f"{w}/seed-fmd-bench.npz", index="f", seqs=f_seqs, lens=f_lens,
                 contig_starts=np.asarray(pack.starts, np.int32),
                 techniques=np.array(PAR_TECHNIQUES))
        line["store_s"] = time.perf_counter() - t0
        print(f"parallel inputs: bench pack, minimizer and FMD index, the msv index "
              f"({len(sv_mmi.hash_sorted)} minimizers), {len(reads)} reads in {PAR_WORLD} "
              f"FASTQ files, stored in {line['store_s']:.1f} s", flush=True)
        r = nccl.result()[0]["results"]["psum"]
        checks["nccl_one_rank"] = r["sum"] == 1 and set(r["probe"].values()) == {"ok"}
        line["nccl_one_rank"] = {"probe": r["probe"], "s": time.perf_counter() - t_nccl}
        print(f"parallel nccl, one rank: {r['probe']} ({line['nccl_one_rank']['s']:.1f} s "
              f"with the process start, beside the store)", flush=True)

        # ---- 2-5. the ranks: sum, sharded minimizers, sharded FMD, alignment
        t0 = time.perf_counter()
        res = run_ranks(PAR_WORLD, w, "psum,seed-mm,seed-fmd,align", devices=devices,
                        backend=backend, wall_timeout=PAR_WALL,
                        extra=("--batch-size", str(BATCH), "--warmup", str(PAR_WARMUP)), **run)
        line["ranks_s"] = time.perf_counter() - t0
        print(f"parallel ranks: {line['ranks_s']:.1f} s with the process starts; per rank "
              + "; ".join(", ".join(f"{m} {r_['results'][m + '_s']:.1f} s"
                                    for m in ("psum", "seed-mm", "seed-fmd", "align"))
                          for r_ in res), flush=True)
        psum = [r_["results"]["psum"] for r_ in res]
        want = PAR_WORLD * (PAR_WORLD + 1) // 2
        checks["sum"] = all(p["sum"] == want for p in psum)
        line["probe"] = psum[0]["probe"]
        print(f"parallel sum over {PAR_WORLD} ranks: {[p['sum'] for p in psum]} (want {want}); "
              f"{backend} on {devices[0]} takes {psum[0]['probe']}", flush=True)

        # ---- 3. sharded minimizers against the single-device lookup on the card
        mm = [r_["results"]["seed-mm"][0] for r_ in res]
        got = dict(np.load(f"{w}/seed-mm-sv.out.npz"))
        sdev = sv_mmi.to_device(dev)
        args = (torch.as_tensor(mm_seqs, device=dev), torch.as_tensor(mm_lens, device=dev),
                torch.as_tensor(mm_case["contig_starts"], device=dev),
                mm_case["ref_len_forward"])
        single = lambda: minimizer_seeding(  # noqa: E731
            sdev, *args, max_occ=PAR_MAX_OCC, max_seeds=PAR_WORLD * PAR_MM_SLOTS)
        single()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sb = single()
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        one = {k: v.cpu().numpy() for k, v in sb._asdict().items()}
        over = got["overflow"] | one["overflow"]
        differ = (seed_keys(got) != seed_keys(one)).any(1) & ~over
        fault = mm_fault_hashes(sv_mmi, PAR_WORLD, PAR_MAX_OCC)
        sel, h, _, _ = _sketch_arrays(args[0].to(torch.int32), 15, 10)
        L = mm_seqs.shape[1]
        sel &= torch.arange(L, device=dev)[None, :] + 15 <= args[1][:, None]
        touch = (sel & torch.isin(h, torch.tensor(fault, dtype=h.dtype, device=dev))).any(1)
        touch = touch.cpu().numpy()
        n_seeds = int(got["n_seeds"].sum())
        checks["mm_ranks_agree"] = all(m["n_seeds"] == n_seeds for m in mm)
        checks["mm_seed_sets"] = not (differ & ~touch).any()
        line["minimizers"] = {
            "reads": len(mm_seqs), "index_entries": mm[0]["index_entries"],
            "shard_entries": mm[0]["shard_entries"],
            "shard_device_bytes": [m["shard_device_bytes"] for m in mm],
            "bytes_reduced_per_batch": mm[0]["bytes_reduced"],
            "collectives_per_batch": mm[0]["collectives"], "ms": [m["ms"] for m in mm],
            "seeds": n_seeds, "seeds_per_s": n_seeds / (max(m["ms"] for m in mm) / 1e3),
            "single_device_ms": single_ms, "fault_hashes": len(fault),
            "reads_over_fault_hashes": int(touch.sum()), "reads_differing": int(differ.sum()),
            "reads_overflowed": int(over.sum()), "chd_upload_s": [m["chd_upload_s"] for m in mm]}
        print(f"parallel minimizers: {json.dumps(line['minimizers'])}", flush=True)

        # ---- 4. sharded FMD against the single-device path on the card
        fo = dict(np.load(f"{w}/seed-fmd-bench.out.npz"))
        fdev = FMDDev.from_host(fmd, dev)
        fs, fl = torch.as_tensor(f_seqs, device=dev), torch.as_tensor(f_lens, device=dev)
        fc = torch.as_tensor(np.asarray(pack.starts, np.int32), device=dev)
        line["fmd"] = {"reads": len(f_seqs), "slab_device_bytes":
                       [r_["results"]["seed-fmd"][0]["slab_device_bytes"] for r_ in res]}
        for tech in PAR_TECHNIQUES:
            seed_fn = smem_seeding if tech == "SMEMs" else max_spanning_seeding
            seed = lambda n: extract_seeds(fdev, seed_fn(fdev, fs[:n], fl[:n]), fl[:n], fc)  # noqa: E731
            seed(PAR_WARMUP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sb = seed(len(f_seqs))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            st = [r_["results"]["seed-fmd"][0][tech] for r_ in res]
            checks[f"fmd_{tech}_equal"] = all(
                np.array_equal(fo[f"{tech}.{k}"], v.cpu().numpy()) for k, v in sb._asdict().items())
            checks[f"fmd_{tech}_same_collectives"] = len({s_["collectives"] for s_ in st}) == 1
            line["fmd"][tech] = {
                "sharded_ms": [s_["ms"] for s_ in st], "single_device_ms": ms,
                "ratio": max(s_["ms"] for s_ in st) / ms, "collectives": st[0]["collectives"],
                "bytes_reduced": st[0]["bytes_reduced"], "seeds": int(sb.n_seeds.sum())}
            print(f"parallel fmd {tech}: {json.dumps(line['fmd'][tech])}", flush=True)

        # ---- 5. the data-parallel alignment against one process on the card
        parts = sorted(os.path.join(w, r_["results"]["align"]["out"]) for r_ in res)
        n_rec = merge_sam_shards(parts, f"{w}/merged.sam")
        fq_reads = [r_ for i in range(PAR_WORLD) for r_ in read_reads(f"{w}/reads{i}.fq")]
        walls = []
        for _ in range(PASSES):
            buf = io.StringIO()
            t0 = time.perf_counter()
            n = aligner.align_to_sam(iter(fq_reads), buf, batch_size=BATCH)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        one_s = statistics.median(walls)
        with open(f"{w}/merged.sam") as f:
            merged = f.read()
        al = [r_["results"]["align"] for r_ in res]
        launches = [a["launches"] for a in al]
        abc = ("soc_sweep", "linesweep", "dp_fused")
        checks["sam_identical"] = merged == buf.getvalue() and n == len(fq_reads)
        checks["abc_on_every_rank"] = all(la[k] > 0 for la in launches for k in abc)
        two_s = max(al[0]["walls_s"])
        line["align"] = {"reads": len(fq_reads), "records": n_rec, "rank_reads":
                         [a["reads"] for a in al], "walls_s": al[0]["walls_s"],
                         "reads_per_s": len(fq_reads) / two_s, "one_process_s": walls,
                         "one_process_reads_per_s": len(fq_reads) / one_s,
                         "launches": launches}
        print(f"parallel align: {json.dumps(line['align'])}", flush=True)

        # ---- the same sharded minimizer batch's first rows, ranks on the CPU
        c = f"{d}/cpu"
        os.mkdir(c)
        os.symlink(f"{w}/sv.mmi.npz", f"{c}/sv.mmi.npz")
        np.savez(f"{c}/seed-mm-sv.npz", index="sv", seqs=mm_seqs[:PAR_CPU_MM_READS],
                 lens=mm_lens[:PAR_CPU_MM_READS], **mm_case)
        t0 = time.perf_counter()
        run_ranks(PAR_WORLD, c, "seed-mm", devices=["cpu"] * PAR_WORLD, backend="gloo",
                  wall_timeout=PAR_WALL, **run)
        cpu = np.load(f"{c}/seed-mm-sv.out.npz")
        checks["mm_card_equals_cpu"] = all(
            np.array_equal(got[k][:PAR_CPU_MM_READS], cpu[k]) for k in cpu.files)
        line["minimizers"]["cpu_check"] = {"reads": PAR_CPU_MM_READS,
                                           "s": time.perf_counter() - t0}
        print(f"parallel minimizers on the CPU: first {PAR_CPU_MM_READS} reads, equal to the "
              f"card's {checks['mm_card_equals_cpu']} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    line["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"parallel": line}), flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"parallel: checks failed: {failed}")
    return {k: sum(la[k] for la in launches) for k in abc}


def build_fmd(pack):
    from ma_tpu_torch.index.fmd_index import FMDIndex

    t0 = time.perf_counter()
    fmd = FMDIndex.build(pack)
    print(f"fmd: index of {fmd.n} text positions built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return fmd


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
    ap.add_argument("--only", choices=("soc", "dp", "traceback", "paired", "cli", "msv", "gui",
                                       "parallel"),
                    help="only one kernel's timed cases, printed as JSON: kernel A's two "
                         "(soc), kernels C and C' on the inputs of a full run (dp), the "
                         "traceback kernel on kernel D's two cases and the long pass's own "
                         "launches (traceback); or only the paired phase (paired), the "
                         "command-line phase (cli) or the SV caller's phase (msv), with each "
                         "kernel's launches as JSON, or only the web console's phase (gui) or "
                         "the multi-process phase (parallel); run "
                         "a copy of this script from another tree's root to compare two trees")
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

    if args.only == "soc":
        records: dict = {}
        pack, reads, _ = simulate(GENOME_BP, BATCH, READ_LEN)  # the first batch of N_READS
        aligner = Aligner(pack, device=dev)
        aligner.pset.set("Seeding Technique", "minimizers")
        soc_case("soc_sweep", *soc_inputs(aligner, reads, dev), records, roof, plain_reps=1)
        pack_l, reads_l, _ = simulate_long()
        soc_case("soc_sweep_long", *soc_inputs(Aligner(pack_l, long_params(), device=dev),
                                               reads_l[:LONG_BATCH], dev),
                 records, roof, plain_reps=0)
        print(json.dumps(records))
        return 0

    if args.only == "dp":
        records = {}
        rng = np.random.default_rng(7)
        for shape in ((65536, 64), (512, 2048)):  # kernel_phase's draws before fused_phase
            linesweep_inputs(rng, *shape, dev)
        fused_phase(rng, dev, records, roof)
        print(json.dumps({k: records[k] for k in ("dp_fused", "dp_fused_v2")}))
        return 0

    if args.only == "traceback":
        from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront

        cases = []
        for P, M, N, is_global, wargs in wavefront_cases(dev):
            got = banded_align_wavefront(*wargs)
            si, sj = (wargs[2] - 1, wargs[3] - 1) if is_global else (got.max_i, got.max_j)
            cases.append(traceback_case("kernel", got.dirs, si, sj, roof,
                                        TB_BEFORE_MS[(P, M, N)], plain_reps=0))
            del got
        pack_l, reads_l, _ = simulate_long()
        al = Aligner(pack_l, long_params(), device=dev)
        al.align_to_sam(iter(reads_l[:8]), io.StringIO(), batch_size=LONG_BATCH)
        _, tb_seen = spied_pass(lambda: al.align_to_sam(iter(reads_l), io.StringIO(),
                                                        batch_size=LONG_BATCH))
        cases += [traceback_case("long pass", *a, roof, plain_reps=0) for a in tb_seen]
        print(json.dumps(cases))
        return 0

    if args.only == "msv":
        records = {}
        launches, _, _ = msv_phase(dev, records, roof)
        print(json.dumps({"launches": launches, "records": records}))
        return 0

    if args.only == "gui":
        pack, _, _ = simulate(GENOME_BP, 1, READ_LEN)  # the bench genome
        ref, svs, donor, _ = simulate_sv()
        gui_phase(dev, pack, (ref, svs, donor))
        return 0

    if args.only == "parallel":
        from ma_tpu_torch.containers.pack import Pack
        from ma_tpu_torch.index.minimizer import MinimizerIndex

        pack, reads, _ = simulate(GENOME_BP, N_READS, READ_LEN)
        aligner = Aligner(pack, device=dev)
        aligner.pset.set("Seeding Technique", "minimizers")
        aligner.align_to_sam(iter(reads[:BATCH]), io.StringIO(), batch_size=BATCH)
        ref, _, _, sv_reads = simulate_sv()
        sv_pack = Pack.empty()
        sv_pack.append("chrS", ref)
        sv_mmi = MinimizerIndex.build(sv_pack)
        print(json.dumps(parallel_phase(dev, (pack, reads, aligner), build_fmd(pack),
                                        (sv_pack, sv_mmi, sv_reads))))
        return 0

    if args.only in ("paired", "cli"):
        pack, _, _ = simulate(GENOME_BP, 1, READ_LEN)  # the bench genome
        if args.only == "paired":
            launches = paired_phase(dev, pack, build_fmd(pack))
        else:
            launches = cli_phase(dev, pack)
        print(json.dumps(launches))
        return 0

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
    fmd = build_fmd(pack)
    for name, v in fmd_phase(dev, pack, fmd, reads, starts).items():
        total[name] += v

    # ---- paired reads (Illumina Paired and Default + -m), counted
    for name, v in paired_phase(dev, pack, fmd).items():
        total[name] += v

    # ---- the command line in subprocesses; SDUST and NGMLR passes, counted
    for name, v in cli_phase(dev, pack).items():
        total[name] += v

    # ---- long reads with small inversions: the Python NW path, counted
    t0 = time.perf_counter()
    pack_l, reads_l, starts_l = simulate_long()
    print(f"long workload: genome {LONG_GENOME_BP} bp, {len(reads_l)} reads x {LONG_LEN} bp, "
          f"inversions of {INV_LEN} bp in every {INV_EVERY}th read "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    long_launches = long_phase(dev, pack_l, reads_l, starts_l, records, roof)
    for name, v in long_launches.items():
        total[name] += v
    rescue_phase(dev)
    wide_phase(dev)

    # ---- the SV caller at sv_bench.py's size: A in the counted passes, D
    # in the connector's run
    msv_launches, sv_work, sv_index = msv_phase(dev, records, roof)
    for name, v in msv_launches.items():
        total[name] += v
    # ---- the web console: index, align and --Sv actions on the card
    gui_phase(dev, pack, sv_work)
    del sv_work
    # ---- multi-process: NCCL, gloo, the sharded indexes, two aligning
    # ranks; A, B and C's launches in the ranks' alignment, counted
    for name, v in parallel_phase(dev, (pack, reads, aligner), fmd, sv_index).items():
        total[name] += v
    del fmd, sv_index
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
        if k is kernels.SOC_SWEEP:  # A's other timed cases: the long pass's and MSV's tables
            out.append(dict(name="soc_sweep_long", route="cuda", source=k.source,
                            replaces=k.replaces, launches=long_launches[k.name],
                            **records["soc_sweep_long"]))
            out.append(dict(name="soc_sweep_msv", route="cuda", source=k.source,
                            replaces=k.replaces, launches=msv_launches[k.name],
                            **records["soc_sweep_msv"]))
        if k is kernels.DP_WAVEFRONT:  # D at the connector's shape
            out.append(dict(name="dp_wavefront_connector", route="cuda", source=k.source,
                            replaces=k.replaces, launches=msv_launches[k.name],
                            **records["dp_wavefront_connector"]))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
