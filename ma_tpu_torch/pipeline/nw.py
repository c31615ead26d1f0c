"""Alignment assembly: chain harmonized seeds, fill gaps and extend ends
with batched device DP (port of ma_tpu/pipeline/nw.py under its reference
setting, the fused DP).

Per harmonized seed set, `plan_set` cuts a reference window (seed span +-
Padding, clamped to the contig strand) and plans DP problems as
descriptors into the device genome text and read batch:
* gaps <= Maximal Gap Size -> banded global DP
* larger gaps -> dual z-drop extension meeting in the middle
* read ends -> one-sided z-drop extension (band Bandwidth for Extensions)
One-sided extensions with queries past 256 bases go to the chunked z-drop
extension over kernel C, the rest to the DP batch protocol. `assemble`
turns the plan tokens and cigars into an Alignment on the host.

The DP batch protocol, `dispatch` and `collect`, serves this planner and
the native C++ planner/assembler (`ma_tpu_torch.pipeline.finish_native`),
which covers the batches whose problems all fit the fused buckets. It
solves a batch's problems in a few device calls by shape: queries of at
most 256 go to the fused DP (runs traced back on the device; kernel C, or
C' past 1,024 reference columns, ops/dp_fused.py `fused_kernel`), the rest
to kernel D + the traceback kernel (ops/dp.py `_dp_tb_desc_runs`).
Problems whose runs overflow kernel C's run buffer are redone through
kernel D.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ma_tpu_torch.containers.alignment import DELETION, INSERTION, SEED, Alignment
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.utils import profile
from ma_tpu_torch.ops.dp import (
    OP_I,
    OP_M,
    RUNS_HEAD,
    DPParams,
    _dp_desc_runs_fused,
    _dp_tb_desc_runs,
    banded_align_traceback_packed,
    rle_ops,
    runs_to_cigars,
)


@dataclasses.dataclass
class DPProblem:
    """One DP problem: a descriptor against the device-resident operands,
    and its results."""

    band: int
    is_global: bool
    read_idx: int = -1
    q_off: int = 0
    q_len: int = 0
    q_rev: int = 0
    t_start: int = 0
    t_len: int = 0
    t_rev: int = 0
    # results
    cigar: Optional[List[Tuple[int, int]]] = None
    max_i: int = -1  # extension: last aligned query index (inclusive)
    max_j: int = -1

    def desc(self) -> Tuple[int, ...]:
        """The descriptor row (read, q_off, q_len, q_rev, t_start, t_len,
        t_rev, band)."""
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


# ------------------------------------------------------ DP batch protocol
# fused-kernel buckets: glob (32, 128), ext (64, 768), ext/glob (256, 768);
# past them kernel D's ladders, M and N bucketed independently (read-end
# extensions pair short queries with ~band-wide reference windows)
M_LADDER_FUSED = (32, 64, 256)
N_LADDER_FUSED = (128, 768)
M_LADDER = (16, 64, 256, 1024, 4096, 16384)
N_LADDER = (64, 256, 768, 4096, 16384, 65536)
MAX_P_FUSED = 4096  # problems per fused-kernel launch


def _rung(ladder, x: np.ndarray) -> np.ndarray:
    """The first rung of `ladder` at least x; past the top, the next power
    of two."""
    lad = np.asarray(ladder, np.int64)
    i = np.searchsorted(lad, x)
    pow2 = np.left_shift(1, np.frexp(x - 1)[1]).astype(np.int64)
    return np.where(i < len(lad), lad[np.minimum(i, len(lad) - 1)], pow2)


def bucket_shapes(m, n) -> Tuple[np.ndarray, np.ndarray]:
    """(M, N) buckets of problems of m query and n reference bases (arrays
    of values >= 1): the fused buckets up to 256 x 768, M at least 64 at N
    = 768; past them, M and N each on kernel D's ladder."""
    m = np.asarray(m, np.int64)
    n = np.asarray(n, np.int64)
    fused = (m <= 256) & (n <= 768)
    Nf = _rung(N_LADDER_FUSED, n)
    Mf = np.maximum(_rung(M_LADDER_FUSED, m), np.where(Nf == 768, 64, 0))
    return np.where(fused, Mf, _rung(M_LADDER, m)), np.where(fused, Nf, _rung(N_LADDER, n))


def _max_p(M: int, N: int) -> int:
    """Problems per kernel-D call: the [P, M, N] direction bytes stay
    within ~1 GiB. The cap may fall to 1 (a 16384 x 65536 problem is 1 GiB
    on its own)."""
    cap = 4096
    while cap > 1 and cap * M * N > 2**30:
        cap //= 2
    return cap


@dataclasses.dataclass
class Dispatched:
    """The DP of one batch in flight: the descriptor rows (columns past the
    eighth are not read), their modes, the configuration, the device and
    each launch as (rows, M, N, is_global, outputs), N the bucket's."""

    desc: np.ndarray
    is_global: np.ndarray
    cfg: NWConfig
    device: torch.device
    launches: list


def dispatch(desc: np.ndarray, is_global, text_dev: torch.Tensor, seqs_dev: torch.Tensor,
             cfg: NWConfig) -> Dispatched:
    """Launch the DP of descriptor rows desc [K, >= 8] int32 with modes
    is_global [K]; torch enqueues the launches without waiting. Each (M, N,
    mode) bucket goes to the fused kernel (M <= 256: `_dp_desc_runs_fused`)
    in launches of at most MAX_P_FUSED problems, or to kernel D
    (`_dp_tb_desc_runs`) in launches of at most `_max_p`, its rows by query
    length: the fused kernel's rows run to each problem's own qlen, so
    sorted rows keep its blocks homogeneous."""
    is_global = np.asarray(is_global, bool)
    m = np.maximum(desc[:, 2], 1)
    Mb, Nb = bucket_shapes(m, np.maximum(desc[:, 5], 1))
    order = np.lexsort((m, is_global, Nb, Mb))
    key = np.stack([Mb, Nb, is_global])[:, order]
    cuts = np.flatnonzero((key[:, 1:] != key[:, :-1]).any(0)) + 1
    launches = []
    with profile.span("dp dispatch"):
        for bucket in np.split(order, cuts) if len(order) else []:
            M, N, g = int(Mb[bucket[0]]), int(Nb[bucket[0]]), bool(is_global[bucket[0]])
            fused = M <= 256
            step = MAX_P_FUSED if fused else _max_p(M, N)
            for s in range(0, len(bucket), step):
                rows = bucket[s : s + step]
                width = N
                if fused and N > N_LADDER_FUSED[-1]:
                    # a fused bucket past the fused ladder (an extension
                    # with m = 256, n = 769) runs as wide as its longest
                    # reference needs, so that up to 1,024 columns stay on
                    # kernel C; no result depends on the width
                    width = -(-int(desc[rows, 5].max()) // 128) * 128
                profile.host_sync()  # the upload from pageable memory
                d8 = torch.as_tensor(np.ascontiguousarray(desc[rows, :8].T),
                                     device=seqs_dev.device)
                fn = _dp_desc_runs_fused if fused else _dp_tb_desc_runs
                out = fn(text_dev, seqs_dev, d8, M=M, N=width, params=cfg.params,
                         zdrop=-1 if g else cfg.zdrop, is_global=g)
                launches.append((rows, M, N, g, out))
    return Dispatched(desc, is_global, cfg, seqs_dev.device, launches)


def fused_results(comb_d: torch.Tensor, runs_d: torch.Tensor):
    """Download a fused launch's results (`_dp_desc_runs_fused`'s comb and
    runs_t) in the fewest waits: comb whole, then runs_t only where a
    problem holds more runs than the RUNS_HEAD that comb carries. Returns
    (meta [8, P] int64, runs [P, S] int64: op | len << 2 in forward order,
    0 past each problem's n_runs; S the most runs of any problem, >= 1)."""
    profile.host_sync()
    comb = comb_d.cpu().numpy().astype(np.int64)
    n_runs = comb[0]
    S = max(1, int(n_runs.max(initial=0)))
    if S > RUNS_HEAD:
        profile.host_sync()
        back = runs_d[:S].cpu().numpy().astype(np.int64)
    else:
        back = comb[8 : 8 + S]
    # stored back to front: a problem's j-th run is its row n_runs - 1 - j
    j = np.arange(S)[None, :]
    fwd = np.take_along_axis(back.T, np.clip(n_runs[:, None] - 1 - j, 0, S - 1), 1)
    return comb[:8], np.where(j < n_runs[:, None], fwd, 0)


def _redo_cigars(desc: np.ndarray, is_global: np.ndarray, text_host: np.ndarray,
                 seqs_np: np.ndarray, cfg: NWConfig, device) -> List[List[Tuple[int, int]]]:
    """Forward-order cigars of descriptor rows desc [k, >= 8] whose runs
    overflowed kernel C's run buffer, re-solved from the host copies of the
    genome text and read batch through kernel D + the traceback kernel on
    `device`, in calls by mode bounded like _max_p. ma_tpu's redo runs
    `banded_align_traceback`, whose DP MA_TPU_DP picks: under the reference
    setting (fused) the XLA anti-diagonal DP, which D matches cell for
    cell; unset, the XLA row DP."""
    cigars: List[Optional[list]] = [None] * len(desc)
    for g in (True, False):
        ks = np.flatnonzero(np.asarray(is_global, bool) == g)
        if not len(ks):
            continue
        ops_in = []
        for read, q_off, q_len, q_rev, t_start, t_len, t_rev in desc[ks, :7].tolist():
            q = seqs_np[read, q_off : q_off + q_len]
            t = text_host[t_start : t_start + t_len]
            ops_in.append((q[::-1] if q_rev else q, t[::-1] if t_rev else t))
        M = max(max(len(q), 1) for q, _ in ops_in)
        N = max(max(len(t), 1) for _, t in ops_in)
        step = _max_p(M, N)
        for s in range(0, len(ks), step):
            part = ops_in[s : s + step]
            qa = np.full((len(part), M), 4, np.uint8)
            ta = np.full((len(part), N), 4, np.uint8)
            for r, (q, t) in enumerate(part):
                qa[r, : len(q)] = q
                ta[r, : len(t)] = t
            lens = [np.asarray([len(x[c]) for x in part], np.int32) for c in (0, 1)]
            ops, meta = banded_align_traceback_packed(
                qa, ta, lens[0], lens[1], desc[ks[s : s + step], 7].astype(np.int32),
                device=device, params=cfg.params, zdrop=-1 if g else cfg.zdrop,
                is_global=g)
            for r, k in enumerate(ks[s : s + step]):
                cigars[k] = rle_ops(ops[r], int(meta[0][r]), int(meta[1][r]), int(meta[2][r]))
    return cigars


def collect(dp: Dispatched, text_host: np.ndarray, seqs_np: np.ndarray):
    """Wait for `dispatch`'s launches and decode them; the problems whose
    runs overflowed kernel C's run buffer are redone together
    (`_redo_cigars`) and keep the fused pass's max_i / max_j. Returns, in
    descriptor-row order, the forward-order runs as a CSR (runs [R, 2]
    int32: op, length; off [K + 1] int64) and meta [max(K, 1), 2] int64:
    max_i, max_j (-1 where the kernel keeps no max-cell book)."""
    K = len(dp.desc)
    n_runs = np.zeros(K, np.int64)
    meta = np.full((max(K, 1), 2), -1, np.int64)
    blocks = []  # (rows, forward runs) of the fused launches
    listed: Dict[int, list] = {}  # row -> cigar: kernel D's rows and the redone rows
    redo: List[int] = []
    for rows, M, N, g, out in dp.launches:
        with profile.span(f"dp collect {'glob' if g else 'ext'} {M}x{N}"):
            if M <= 256:
                m8, fwd = fused_results(*out)
                n_runs[rows] = m8[0]
                meta[rows] = m8[2:4].T
                blocks.append((rows, fwd))
                redo += rows[m8[5] != 0].tolist()
                continue
            ops_d, meta_d, run_op_d, run_start_d, n_runs_d = out
            profile.host_sync(4)
            m7 = meta_d.cpu().numpy()
            n_ops, rem_i, rem_j = m7[0], m7[1], m7[2]
            cigars = runs_to_cigars(run_op_d.cpu().numpy(), run_start_d.cpu().numpy(),
                                    n_ops, n_runs_d.cpu().numpy(), rem_i, rem_j)
            for k, cg in enumerate(cigars):
                if cg is None:  # more than MAX_RUNS runs: decode the ops row
                    n = int(n_ops[k])
                    profile.host_sync()
                    row = ops_d[k, : min(max(128, -(-n // 128) * 128),
                                         ops_d.shape[1])].cpu().numpy()
                    cg = rle_ops(row, n, int(rem_i[k]), int(rem_j[k]))
                listed[int(rows[k])] = cg
            meta[rows] = m7[4:6].T
    if redo:
        with profile.span("dp redo batched"):
            listed.update(zip(redo, _redo_cigars(dp.desc[redo], dp.is_global[redo], text_host,
                                                 seqs_np, dp.cfg, dp.device)))
    own = np.zeros(K, bool)
    own[list(listed)] = True
    for r, cg in listed.items():
        n_runs[r] = len(cg)
    off = np.zeros(K + 1, np.int64)
    np.cumsum(n_runs, out=off[1:])
    runs = np.zeros((int(off[-1]), 2), np.int32)
    for rows, fwd in blocks:
        j = np.arange(fwd.shape[1])[None, :]
        mask = j < np.where(own[rows], 0, n_runs[rows])[:, None]
        dest = (off[rows][:, None] + j)[mask]
        runs[dest, 0] = fwd[mask] & 3
        runs[dest, 1] = fwd[mask] >> 2
    for r, cg in listed.items():
        if cg:
            runs[off[r] : off[r + 1]] = cg
    return runs, off, meta


class NWAligner:
    """The Python path's planner and assembler of one batch: the
    configuration, the device genome text and read batch the descriptors
    point into (and their host copies, which the run-overflow redo reads),
    and the planned problems."""

    def __init__(self, pack: Pack, config: NWConfig, text_dev: torch.Tensor,
                 seqs_dev: torch.Tensor, text_host: np.ndarray, seqs_np: np.ndarray):
        self.pack = pack
        self.cfg = config
        self.text_dev = text_dev
        self.seqs_dev = seqs_dev
        self.text_host = text_host
        self.seqs_np = seqs_np
        self._problems: List[DPProblem] = []
        self._read_idx = -1  # set by plan_set
        self._dp: Optional[Dispatched] = None  # dispatched DP awaiting collect
        self._dispatched: List[int] = []  # its problems, in descriptor-row order
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

    # ------------------------------------------------------------ execution
    def dispatch_batches(self):
        """Launch the DP of every planned problem (`dispatch`); one-sided
        extensions with queries past 256 bases are held for the chunked
        path, which runs in collect_batches."""
        probs = self._problems
        self._chunked_pending = [i for i, p in enumerate(probs)
                                 if not p.is_global and p.q_len > 256]
        held = set(self._chunked_pending)
        self._dispatched = [i for i in range(len(probs)) if i not in held]
        desc = np.asarray([probs[i].desc() for i in self._dispatched], np.int32).reshape(-1, 8)
        self._dp = dispatch(desc, [probs[i].is_global for i in self._dispatched],
                            self.text_dev, self.seqs_dev, self.cfg)

    def collect_batches(self):
        """Run the chunked long extensions, then `collect` the dispatched
        DP into the problems' cigars and end cells."""
        if self._chunked_pending:
            with profile.span("dp chunked long ext"):
                self._chunked_ext(self._chunked_pending)
            self._chunked_pending = []
        runs, off, meta = collect(self._dp, self.text_host, self.seqs_np)
        self._dp = None
        for k, i in enumerate(self._dispatched):
            p = self._problems[i]
            cigar = [tuple(r) for r in runs[off[k] : off[k + 1]].tolist()]
            if p.is_global:
                p.max_i, p.max_j = p.q_len - 1, p.t_len - 1
                p.cigar = cigar
            else:
                p.max_i, p.max_j = int(meta[k, 0]), int(meta[k, 1])
                p.cigar = cigar if p.max_i >= 0 else []

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
            meta, runs = fused_results(*_dp_desc_runs_fused(
                self.text_dev, self.seqs_dev, torch.as_tensor(desc, device=self.device),
                M=CH, N=CN, params=cfg.params, zdrop=cfg.zdrop, is_global=False, tb_last=tb))
            return meta, runs, lens

        def runs_of(runs, k, n_runs):
            return [(v & 3, v >> 2) for v in runs[k, :n_runs].tolist()]

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
