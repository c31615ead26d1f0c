"""Alignment assembly: chain harmonized seeds, fill gaps and extend ends
with batched device DP (port of ma_tpu/pipeline/nw.py under its reference
setting, the fused DP).

Per harmonized seed set, `plan_set` cuts a reference window (seed span +-
Padding, clamped to the contig strand) and plans DP problems as
descriptors into the device genome text and read batch:
* gaps <= Maximal Gap Size -> banded global DP
* larger gaps -> dual z-drop extension meeting in the middle
* read ends -> one-sided z-drop extension (band Bandwidth for Extensions)
All problems of a read batch are bucketed by shape and solved in a few
device calls: problems with queries of at most 256 go to the fused DP
(runs traced back on the device; kernel C, or C' past 1,024 reference
columns, ops/dp_fused.py `fused_kernel`), one-sided extensions with longer
queries to the chunked z-drop extension over kernel C, the rest to kernel
D + the traceback kernel (ops/dp.py `_dp_tb_desc_runs`). Problems whose runs
overflow kernel C's run buffer are redone through kernel D. `assemble`
turns the plan tokens and cigars into an Alignment on the host.

The native C++ planner/assembler (`ma_tpu_torch.pipeline.finish_native`) covers
batches whose problems all fit the fused buckets; this module is the path
for the rest, and the run-overflow redo of both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ma_tpu_torch.containers.alignment import DELETION, INSERTION, SEED, Alignment
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.utils import profile
from ma_tpu_torch.utils.profile import stage_timer
from ma_tpu_torch.ops.dp import (
    OP_I,
    OP_M,
    RUNS_HEAD,
    DPParams,
    _dp_desc_runs_fused,
    _dp_tb_desc_runs,
    banded_align_traceback_packed,
    packed_runs_to_cigars,
    rle_ops,
    runs_to_cigars,
)


def _next_pow2(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@dataclasses.dataclass
class DPProblem:
    """One DP problem: a descriptor against the device-resident operands,
    or its own host operands (q, t), and its results."""

    band: int
    is_global: bool
    read_idx: int = -1
    q_off: int = 0
    q_len: int = 0
    q_rev: int = 0
    t_start: int = 0
    t_len: int = 0
    t_rev: int = 0
    # host query / reference codes (reversed for a reverse extension) when
    # the problem carries its own operands; None: read them via the descriptor
    q: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    # results
    cigar: Optional[List[Tuple[int, int]]] = None
    max_i: int = -1  # extension: last aligned query index (inclusive)
    max_j: int = -1

    @classmethod
    def from_desc(cls, row, is_global: bool) -> "DPProblem":
        """From a planner descriptor row (read, q_off, q_len, q_rev,
        t_start, t_len, t_rev, band, ...)."""
        return cls(band=int(row[7]), is_global=is_global, read_idx=int(row[0]),
                   q_off=int(row[1]), q_len=int(row[2]), q_rev=int(row[3]),
                   t_start=int(row[4]), t_len=int(row[5]), t_rev=int(row[6]))

    def desc(self) -> Tuple[int, ...]:
        """The descriptor row from_desc reads."""
        return (self.read_idx, self.q_off, self.q_len, self.q_rev, self.t_start, self.t_len,
                self.t_rev, self.band)


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


def _contig_segment(pack: Pack, pos: int) -> Tuple[int, int]:
    """[lo, hi) of the strand-aware contig segment containing pos in [0, 2L)."""
    L = pack.unpacked_size_forward_strand
    c = int(pack.seq_id_for_position(pos))
    lo = int(pack.starts[c])
    hi = lo + int(pack.lengths[c])
    if pos >= L:
        lo, hi = 2 * L - hi, 2 * L - lo
    return lo, hi


class NWAligner:
    """Per-batch DP state: the configuration, the device genome text and
    read batch the descriptors point into (and their host copies, which
    the run-overflow redo reads), the planned problems and the batch's
    overflow flags."""

    def __init__(self, pack: Pack, config: NWConfig, text_dev: torch.Tensor,
                 seqs_dev: torch.Tensor, text_host: np.ndarray, seqs_np: np.ndarray,
                 profiler=None):
        self.pack = pack
        self.cfg = config
        self.text_dev = text_dev
        self.seqs_dev = seqs_dev
        self.text_host = text_host
        self.seqs_np = seqs_np
        self.profiler = profiler
        self.overflow_flags: Optional[np.ndarray] = None
        self._problems: List[DPProblem] = []
        self._read_idx = -1  # set by plan_set
        self._launched = None  # dispatched device calls awaiting collect
        self._chunked_pending: List[int] = []

    @property
    def device(self) -> torch.device:
        return self.seqs_dev.device

    # ------------------------------------------------------------- planning
    def _new_problem(self, band, is_global, q_off=0, q_len=0, q_rev=0, t_start=0,
                     t_len=0, t_rev=0) -> int:
        self._problems.append(DPProblem(
            band=int(band), is_global=is_global, read_idx=self._read_idx, q_off=int(q_off),
            q_len=int(q_len), q_rev=int(q_rev), t_start=int(t_start), t_len=int(t_len),
            t_rev=int(t_rev)))
        return len(self._problems) - 1

    def _plan_dyn_prg(self, plan, fq, tq, fr, tr, local_begin, local_end, begin_ref=0):
        """dynPrg: emit the plan tokens of one stretch between anchors."""
        cfg = self.cfg
        if tr <= fr and tq <= fq:
            return
        if tq <= fq:
            plan.append(("op", DELETION, tr - fr))
            return
        if tr <= fr:
            plan.append(("op", INSERTION, tq - fq))
            return
        if not local_begin and not local_end:
            if tq - fq > cfg.max_gap_area or tr - fr > cfg.max_gap_area:
                # dual z-drop extension. A banded extension never reaches a
                # reference column > qlen + band, so clamping the windows
                # to that is exact.
                cap = (tq - fq) + cfg.band_ext + 1
                trl = min(tr, fr + cap)
                pl = self._new_problem(cfg.band_ext, False, q_off=fq, q_len=tq - fq,
                                       t_start=begin_ref + fr, t_len=trl - fr)
                frr = max(fr, tr - cap)
                pr = self._new_problem(cfg.band_ext, False, q_off=fq, q_len=tq - fq,
                                       q_rev=1, t_start=begin_ref + frr, t_len=tr - frr,
                                       t_rev=1)
                plan.append(("dual", pl, pr, fq, tq, fr, tr))
            else:
                w = cfg.min_band_gap
                if abs((tr - fr) - (tq - fq)) + 10 > w:
                    w = abs((tr - fr) - (tq - fq)) + 10
                p = self._new_problem(w, True, q_off=fq, q_len=tq - fq,
                                      t_start=begin_ref + fr, t_len=tr - fr)
                plan.append(("global", p, fq, tq, fr, tr))
            return
        # one-sided extension; the reference window clamped to qlen + band
        rev = local_begin
        cap = (tq - fq) + cfg.band_ext + 1
        if rev:
            fr2 = max(fr, tr - cap)
            p = self._new_problem(cfg.band_ext, False, q_off=fq, q_len=tq - fq, q_rev=1,
                                  t_start=begin_ref + fr2, t_len=tr - fr2, t_rev=1)
        else:
            tr2 = min(tr, fr + cap)
            p = self._new_problem(cfg.band_ext, False, q_off=fq, q_len=tq - fq,
                                  t_start=begin_ref + fr, t_len=tr2 - fr)
        plan.append(("ext", p, rev, fq, tq, fr, tr))

    def plan_set(self, query: np.ndarray, seeds: Sequence[Tuple[int, int, int]],
                 read_idx: int):
        """Plan one harmonized seed set -> (plan tokens, begin_ref, ref) or
        None. seeds: [(q_start, length, ref_start)] in any order, sorted
        here by (ref, q); read_idx: the read's row in the device batch."""
        cfg = self.cfg
        pack = self.pack
        self._read_idx = read_idx
        qlen = len(query)
        seeds = sorted((s for s in seeds if s[1] > 0), key=lambda s: (s[2], s[0]))
        if not seeds:
            return None
        begin_ref = min(s[2] for s in seeds)
        end_ref = max(s[2] + s[1] for s in seeds)
        if begin_ref >= end_ref or pack.bridging(begin_ref, end_ref + 1):
            return None
        # pad + clamp to the contig segment
        old_lo, old_hi = _contig_segment(pack, begin_ref)
        begin_ref = max(begin_ref - cfg.padding, 0)
        end_ref = min(end_ref + cfg.padding, pack.unpacked_size_forward_plus_reverse - 1)
        begin_ref = max(begin_ref, old_lo)
        if end_ref > old_hi - 1:
            end_ref = old_hi - 1
        ref = pack.extract(begin_ref, end_ref)

        plan: List[tuple] = []
        front = seeds[0]
        self._plan_dyn_prg(plan, 0, front[0], 0, front[2] - begin_ref, True, False,
                           begin_ref=begin_ref)
        plan.append(("op", SEED, front[1]))
        last_q = front[0] + front[1]
        last_r = front[2] + front[1] - begin_ref
        for (sq, sl, sr) in seeds[1:]:
            ov_q = last_q - sq if sq <= last_q else 0
            ov_r = last_r - (sr - begin_ref) if sr - begin_ref <= last_r else 0
            overlap = max(ov_q, ov_r)
            if sl > overlap:
                self._plan_dyn_prg(plan, last_q, sq, last_r, sr - begin_ref, False, False,
                                   begin_ref=begin_ref)
                if ov_q > ov_r:
                    plan.append(("op", DELETION, ov_q - ov_r))
                if ov_r > ov_q:
                    plan.append(("op", INSERTION, ov_r - ov_q))
                plan.append(("op", SEED, sl - overlap))
                if sq + sl > last_q:
                    last_q = sq + sl
                if sr + sl - begin_ref > last_r:
                    last_r = sr + sl - begin_ref
        # right end extension (the reference's endQuery-1 / endRef-1)
        self._plan_dyn_prg(plan, last_q, qlen - 1, last_r, end_ref - begin_ref - 1, False,
                           True, begin_ref=begin_ref)
        return plan, begin_ref, ref

    # (M, N) bucket ladders of the direction-tensor DP; M and N are bucketed
    # independently (read-end extensions pair short queries with ~band-wide
    # reference windows)
    N_LADDER = [64, 256, 768, 4096, 16384, 65536]
    M_LADDER = [16, 64, 256, 1024, 4096, 16384]

    @classmethod
    def _bucket_shape(cls, m: int, n: int):
        M = next((v for v in cls.M_LADDER if m <= v), _next_pow2(m))
        N = next((v for v in cls.N_LADDER if n <= v), _next_pow2(n))
        return (M, N)

    @staticmethod
    def _max_p(M: int, N: int) -> int:
        """Problems per direction-tensor call: the [P, M, N] direction bytes
        stay within ~1 GiB. The cap may fall to 1 (a 16384 x 65536 problem
        is 1 GiB on its own)."""
        cap = 4096
        while cap > 1 and cap * M * N > 2**30:
            cap //= 2
        return cap

    # fused-kernel buckets: glob (32, 128), ext (64, 768), ext/glob (256, 768)
    M_LADDER_FUSED = [32, 64, 256]
    N_LADDER_FUSED = [128, 768]
    MAX_P_FUSED = 4096  # problems per fused-kernel call

    @classmethod
    def _bucket_shape_fused(cls, m: int, n: int):
        if m <= 256 and n <= 768:
            M = next(v for v in cls.M_LADDER_FUSED if m <= v)
            N = next(v for v in cls.N_LADDER_FUSED if n <= v)
            if N == 768:
                M = max(M, 64)
            return (M, N)
        return cls._bucket_shape(m, n)

    # ------------------------------------------------------------ execution
    def dispatch_batches(self):
        """Launch every bucket's device call (torch enqueues them without
        waiting); long one-sided extensions are held for the chunked path,
        which runs in collect_batches."""
        buckets: Dict[tuple, List[int]] = {}
        chunked: List[int] = []
        for i, p in enumerate(self._problems):
            m, n = max(p.q_len, 1), max(p.t_len, 1)
            if not p.is_global and m > 256:
                chunked.append(i)
                continue
            M, N = self._bucket_shape_fused(m, n)
            buckets.setdefault((M, N, p.is_global), []).append(i)
        self._chunked_pending = chunked
        launched = []
        with stage_timer(self.profiler, "dp dispatch"):
            for (M, N, is_global), idxs in buckets.items():
                use_fused = M <= 256
                max_p = self.MAX_P_FUSED if use_fused else self._max_p(M, N)
                # the fused kernel's rows run to each problem's own qlen:
                # sorting by query length keeps blocks homogeneous
                idxs.sort(key=lambda i: self._problems[i].q_len)
                for s in range(0, len(idxs), max_p):
                    part = idxs[s : s + max_p]
                    width = N
                    if use_fused and N > self.N_LADDER_FUSED[-1]:
                        # a fused bucket past the fused ladder (an extension
                        # with m = 256, n = 769) runs as wide as its longest
                        # reference needs, so that up to 1,024 columns stay
                        # on kernel C (banded_align_runs takes C' up to
                        # 4,096); no result depends on the width
                        width = -(-max(self._problems[i].t_len for i in part) // 128) * 128
                    profile.host_sync()  # the upload from pageable memory
                    desc = torch.as_tensor(np.asarray(
                        [self._problems[i].desc() for i in part], np.int32).T.copy(),
                        device=self.device)
                    fn = _dp_desc_runs_fused if use_fused else _dp_tb_desc_runs
                    out = fn(self.text_dev, self.seqs_dev, desc, M=M, N=width,
                             params=self.cfg.params,
                             zdrop=-1 if is_global else self.cfg.zdrop, is_global=is_global)
                    launched.append(((M, N, is_global), part, out, use_fused))
        self._launched = launched

    def collect_batches(self):
        self._collect(self._launched)
        self._launched = None

    def _collect(self, launched):
        """Download the runs (fused) or run boundaries (kernel D) of every
        bucket, run the chunked long extensions, decode cigars, and redo the
        fused problems whose runs overflowed."""
        redo_items: List[int] = []
        chunked = self._chunked_pending
        if chunked:
            with stage_timer(self.profiler, "dp chunked long ext"):
                self._chunked_ext(chunked)
            self._chunked_pending = []
        for (M, N, is_global), idxs, out, use_fused in launched:
            K = len(idxs)
            with stage_timer(self.profiler,
                             f"dp collect {'glob' if is_global else 'ext'} {M}x{N}"):
                if use_fused:
                    comb_d, runs_d = out
                    profile.host_sync()
                    meta = comb_d[:8].cpu().numpy()
                    n_runs = meta[0]
                    smax = max(1, int(n_runs.max(initial=0)))
                    profile.host_sync()
                    runs_t = (runs_d[:smax].cpu().numpy() if smax > RUNS_HEAD
                              else comb_d[8 : 8 + smax].cpu().numpy())
                    cigars = packed_runs_to_cigars(runs_t, n_runs)
                    for k in range(K):
                        if cigars[k] is None or meta[5][k]:
                            redo_items.append(idxs[k])
                            cigars[k] = None
                    max_i, max_j = meta[2], meta[3]
                else:
                    ops_d, meta_d, run_op_d, run_start_d, n_runs_d = out
                    profile.host_sync(4)
                    meta = meta_d.cpu().numpy()
                    n_ops, rem_i, rem_j = meta[0], meta[1], meta[2]
                    cigars = runs_to_cigars(run_op_d.cpu().numpy(), run_start_d.cpu().numpy(),
                                            n_ops, n_runs_d.cpu().numpy(), rem_i, rem_j)
                    for k, cg in enumerate(cigars):
                        if cg is None:  # more than MAX_RUNS runs: decode the ops row
                            n = int(n_ops[k])
                            profile.host_sync()
                            row = ops_d[k, : min(max(128, -(-n // 128) * 128),
                                                 ops_d.shape[1])].cpu().numpy()
                            cigars[k] = rle_ops(row, n, int(rem_i[k]), int(rem_j[k]))
                    max_i, max_j = meta[4], meta[5]
            for k, i in enumerate(idxs):
                p = self._problems[i]
                if is_global:
                    p.max_i, p.max_j = p.q_len - 1, p.t_len - 1
                    p.cigar = cigars[k]
                else:
                    p.max_i, p.max_j = int(max_i[k]), int(max_j[k])
                    p.cigar = cigars[k] if p.max_i >= 0 else []
        if redo_items:
            with stage_timer(self.profiler, "dp redo batched"):
                self._redo_batched(redo_items)

    # --------------------------------------------------- run-overflow redo
    def _host_operands(self, p: DPProblem):
        """The problem's query and reference codes, as the DP sees them."""
        if p.q is not None:
            return p.q, p.t
        q = self.seqs_np[p.read_idx, p.q_off : p.q_off + p.q_len]
        t = self.text_host[p.t_start : p.t_start + p.t_len]
        return (q[::-1] if p.q_rev else q), (t[::-1] if p.t_rev else t)

    def _redo_cigars(self, probs: Sequence[DPProblem]) -> List[List[Tuple[int, int]]]:
        """Cigars of problems whose runs overflowed kernel C's run buffer,
        re-solved through kernel D + the traceback kernel on the batch's
        device, in calls grouped by mode and bounded like _max_p. ma_tpu's
        redo runs `banded_align_traceback`, whose DP MA_TPU_DP picks: under
        the reference setting (fused) the XLA anti-diagonal DP, which D
        matches cell for cell; unset, the XLA row DP."""
        cigars: List[Optional[list]] = [None] * len(probs)
        groups: Dict[bool, List[int]] = {}
        for k, p in enumerate(probs):
            groups.setdefault(p.is_global, []).append(k)
        for is_global, ks in groups.items():
            ops_in = [self._host_operands(probs[k]) for k in ks]
            M = max(max(len(q), 1) for q, _ in ops_in)
            N = max(max(len(t), 1) for _, t in ops_in)
            step = self._max_p(M, N)
            for s in range(0, len(ks), step):
                part = list(range(s, min(s + step, len(ks))))
                qa = np.full((len(part), M), 4, np.uint8)
                ta = np.full((len(part), N), 4, np.uint8)
                for r, x in enumerate(part):
                    q, t = ops_in[x]
                    qa[r, : len(q)] = q
                    ta[r, : len(t)] = t
                lens = [np.asarray([len(ops_in[x][c]) for x in part], np.int32)
                        for c in (0, 1)]
                band = np.asarray([probs[ks[x]].band for x in part], np.int32)
                ops, meta = banded_align_traceback_packed(
                    qa, ta, lens[0], lens[1], band, device=self.device,
                    params=self.cfg.params, zdrop=-1 if is_global else self.cfg.zdrop,
                    is_global=is_global)
                for r, x in enumerate(part):
                    cigars[ks[x]] = rle_ops(ops[r], int(meta[0][r]), int(meta[1][r]),
                                            int(meta[2][r]))
        return cigars

    def redo_one(self, p: DPProblem) -> List[Tuple[int, int]]:
        """The native path's redo of one problem whose runs overflowed
        kernel C's run buffer: its forward-order cigar from kernel D."""
        return self._redo_cigars([p])[0]

    def _redo_batched(self, idxs: Sequence[int]):
        """Redo every fused problem of the batch whose runs overflowed; the
        problems keep the fused forward pass's max_i / max_j, only the cigar
        is recomputed."""
        probs = [self._problems[i] for i in idxs]
        for p, cg in zip(probs, self._redo_cigars(probs)):
            p.cigar = cg if (p.is_global or p.max_i >= 0) else []

    # ------------------------------------------------- chunked long-read ext
    CHUNK_M = 256  # query bases per chunk (a fused-kernel bucket)
    CHUNK_N = 768

    def _chunked_ext(self, idxs):
        """One-sided extensions with query overhangs beyond the fused
        buckets, solved as sequential 256-base chunks of the fused kernel.

        Each round traces the chunk's path through its last row (kernel C's
        tb_last mode) and re-anchors the next chunk at that cell; the best
        cell over all chunks ends the extension, with one final ext-mode
        call on its chunk for the tail path. A round stops a problem when
        its chunk's last row holds no undropped cell (lastrow_max is
        NEG_INF), whatever lastrow_arg holds then."""
        cfg = self.cfg
        CH, CN = self.CHUNK_M, self.CHUNK_N

        @dataclasses.dataclass
        class St:
            pi: int
            q_done: int = 0
            r_done: int = 0
            cum: int = 0
            chunks: list = dataclasses.field(default_factory=list)  # (runs, lr_arg, q_len)
            best_total: int = 0
            best_chunk: int = -1  # -1: the extension start (align nothing)
            best_cell: Tuple[int, int] = (-1, -1)

        states = [St(pi) for pi in idxs]

        def run_round(active, tb_last_flag):
            desc = np.zeros((8, len(active)), np.int32)
            lens = []
            for k, s in enumerate(active):
                p = self._problems[s.pi]
                qc = min(CH, p.q_len - s.q_done)
                tc = min(CN, p.t_len - s.r_done)
                q_off = (p.q_off + p.q_len - s.q_done - qc) if p.q_rev else p.q_off + s.q_done
                t_start = (p.t_start + p.t_len - s.r_done - tc) if p.t_rev \
                    else p.t_start + s.r_done
                desc[:, k] = (p.read_idx, q_off, qc, p.q_rev, t_start, tc, p.t_rev,
                              cfg.band_ext)
                lens.append((qc, tc))
            tb = torch.full((len(active),), tb_last_flag, dtype=torch.int32, device=self.device)
            profile.host_sync()  # desc's upload from pageable memory
            comb_d, runs_full_d = _dp_desc_runs_fused(
                self.text_dev, self.seqs_dev, torch.as_tensor(desc, device=self.device),
                M=CH, N=CN, params=cfg.params, zdrop=cfg.zdrop, is_global=False, tb_last=tb)
            profile.host_sync()
            comb = comb_d.cpu().numpy().astype(np.int64)
            meta = comb[:8]
            smax = max(1, int(meta[0].max(initial=0)))
            if smax > RUNS_HEAD:
                profile.host_sync()
            runs = (runs_full_d[:smax].cpu().numpy().astype(np.int64) if smax > RUNS_HEAD
                    else comb[8 : 8 + smax])
            return meta, runs, lens

        def runs_of(runs, k, n_runs):
            return [(int(runs[j, k]) & 3, int(runs[j, k]) >> 2)
                    for j in range(n_runs - 1, -1, -1)]

        active = [s for s in states if self._problems[s.pi].q_len > 0]
        rounds = 0
        while active and rounds < 512:
            rounds += 1
            meta, runs, lens = run_round(active, 1)
            nxt = []
            for k, s in enumerate(active):
                p = self._problems[s.pi]
                qc, tc = lens[k]
                gmax, gi, gj = int(meta[1][k]), int(meta[2][k]), int(meta[3][k])
                lrmax, lrarg = int(meta[6][k]), int(meta[7][k])
                # global best across chunks (the extension floor stays 0)
                if gi >= 0 and s.cum + gmax > s.best_total:
                    s.best_total = s.cum + gmax
                    s.best_chunk = len(s.chunks)
                    s.best_cell = (gi, gj)
                s.chunks.append((runs_of(runs, k, int(meta[0][k])), lrarg, qc))
                if (lrarg >= 0 and s.q_done + qc < p.q_len
                        and s.r_done + lrarg + 1 < p.t_len
                        and s.cum + lrmax >= s.best_total - cfg.zdrop):
                    s.q_done += qc
                    s.r_done += lrarg + 1
                    s.cum += lrmax
                    nxt.append(s)
            active = nxt

        # final pass: ext-mode traceback of each problem's best chunk
        finals = [s for s in states if s.best_chunk >= 0]
        for s in finals:
            s.q_done = sum(c[2] for c in s.chunks[: s.best_chunk])
            s.r_done = sum(c[1] + 1 for c in s.chunks[: s.best_chunk])
        if finals:
            meta, runs, _ = run_round(finals, 0)
        for s in states:
            if s.best_chunk < 0:
                p = self._problems[s.pi]
                p.max_i, p.max_j = -1, -1
                p.cigar = []
        for k, s in enumerate(finals):
            p = self._problems[s.pi]
            cigar: List[Tuple[int, int]] = []
            parts = [c[0] for c in s.chunks[: s.best_chunk]] + [runs_of(runs, k, int(meta[0][k]))]
            for chunk_runs in parts:
                for op, ln in chunk_runs:
                    if cigar and cigar[-1][0] == op:
                        cigar[-1] = (op, cigar[-1][1] + ln)
                    else:
                        cigar.append((op, ln))
            p.max_i = s.q_done + s.best_cell[0]
            p.max_j = s.r_done + s.best_cell[1]
            p.cigar = cigar

    # ------------------------------------------------------------- assembly
    def _append_cigar(self, aln: Alignment, cigar, query, ref, qpos, rpos):
        for op, ln in cigar:
            if op == OP_M:
                qs = np.asarray(query[qpos : qpos + ln])
                ts = np.asarray(ref[rpos : rpos + ln])
                eq = (qs == ts) & (qs < 4)
                # run-length encode the match / mismatch pattern
                change = np.flatnonzero(eq[1:] != eq[:-1]) + 1
                bounds = np.concatenate(([0], change, [ln]))
                aln.append_mm_runs(bool(eq[0]) if ln else True, np.diff(bounds))
                qpos += ln
                rpos += ln
            elif op == OP_I:
                aln.append(INSERTION, ln)
                qpos += ln
            else:
                aln.append(DELETION, ln)
                rpos += ln
        return qpos, rpos

    def assemble(self, plan, begin_ref: int, ref: np.ndarray, query: np.ndarray) -> Alignment:
        """Build the Alignment from plan tokens + solved problems."""
        cfg = self.cfg
        aln = Alignment(
            begin_on_ref=begin_ref, begin_on_query=0, match=cfg.params.match,
            mismatch=cfg.params.mismatch, gap=cfg.params.gap_open,
            extend=cfg.params.gap_extend, sv_penalty=cfg.sv_penalty,
        )
        for tok in plan:
            kind = tok[0]
            if kind == "op":
                _, op, ln = tok
                aln.append(op, ln)
            elif kind == "global":
                _, pi, fq, tq, fr, tr = tok
                qpos, rpos = self._append_cigar(aln, self._problems[pi].cigar, query, ref,
                                                fq, fr)
                # the DP may stop short: pad the remainder (the reference
                # names these two the other way round; lengths are 0 normally)
                aln.append(DELETION, tq - qpos)
                aln.append(INSERTION, tr - rpos)
            elif kind == "ext":
                _, pi, rev, fq, tq, fr, tr = tok
                p = self._problems[pi]
                if rev:
                    # reverse extension: the cigar is for reversed segments;
                    # un-reverse it and shift the alignment start
                    q0 = tq - p.max_i - 1
                    r0 = tr - p.max_j - 1
                    aln.begin_on_query = q0
                    aln.end_on_query = q0
                    aln.begin_on_ref = begin_ref + r0
                    aln.end_on_ref = begin_ref + r0
                    self._append_cigar(aln, list(reversed(p.cigar)), query, ref, q0, r0)
                else:
                    self._append_cigar(aln, p.cigar, query, ref, fq, fr)
            elif kind == "dual":
                self._assemble_dual(aln, tok, query, ref)
        aln.remove_dangeling()
        return aln

    def _append_op(self, aln, op, ln, query, ref, q, r):
        """Append one cigar op at (q, r); returns the new (q, r)."""
        if op == OP_M:
            self._append_cigar(aln, [(OP_M, ln)], query, ref, q, r)
            return q + ln, r + ln
        if op == OP_I:
            aln.append(INSERTION, ln)
            return q + ln, r
        aln.append(DELETION, ln)
        return q, r + ln

    def _assemble_dual(self, aln: Alignment, tok, query, ref):
        """Stitch the two halves of a dual extension at the centre of their
        reach (ksw_dual_ext)."""
        _, pl, pr, fq, tq, fr, tr = tok
        L = self._problems[pl]
        R = self._problems[pr]
        q_center = max(fq, min(tq, (fq + L.max_i + (tq - R.max_i - 1)) // 2))
        r_center = max(fr, min(tr, (fr + L.max_j + (tr - R.max_j - 1)) // 2))

        qpos, rpos = fq, fr
        if rpos != r_center and qpos != q_center:
            for op, ln in L.cigar:
                if op == OP_M:
                    ln = min(ln, q_center - qpos, r_center - rpos)
                elif op == OP_I:
                    ln = min(ln, q_center - qpos)
                else:
                    ln = min(ln, r_center - rpos)
                qpos, rpos = self._append_op(aln, op, ln, query, ref, qpos, rpos)
                if rpos == r_center or qpos == q_center:
                    break
        # right side: skip cigar ops until past both centres
        rq, rr = tq - R.max_i - 1, tr - R.max_j - 1
        rc = list(reversed(R.cigar))  # forward order
        i = 0
        pending = None  # the part of a cut op that lies past the centre
        while i < len(rc):
            if rr >= r_center and rq >= q_center:
                break
            op, ln = rc[i]
            if op == OP_M:
                if rr + ln >= r_center and rq + ln >= q_center:
                    if rr < r_center and (rq >= q_center or r_center - rr > q_center - rq):
                        cut = r_center - rr
                    else:
                        cut = q_center - rq
                    pending = (op, ln - cut)
                    rq += cut
                    rr += cut
                    i += 1
                    break
                rq += ln
                rr += ln
            elif op == OP_I:
                if rq + ln > q_center and rr >= r_center:
                    cut = q_center - rq
                    pending = (op, ln - cut)
                    rq += cut
                    i += 1
                    break
                rq += ln
            else:
                if rr + ln > r_center and rq >= q_center:
                    cut = r_center - rr
                    pending = (op, ln - cut)
                    rr += cut
                    i += 1
                    break
                rr += ln
            i += 1
        # fill the middle hole with D then I
        if rr > rpos:
            aln.append(DELETION, rr - rpos)
        if rq > qpos:
            aln.append(INSERTION, rq - qpos)
        if pending is not None and pending[1] > 0:
            rq, rr = self._append_op(aln, pending[0], pending[1], query, ref, rq, rr)
        for op, ln in rc[i:]:
            rq, rr = self._append_op(aln, op, ln, query, ref, rq, rr)
