"""Single-end alignment pipeline (port of ma_tpu/pipeline/aligner.py under
its reference setting, the fused DP with the native finish).

    seeding: minimizers (sketch + CHD lookup, lumping, min length), FMD
      maxSpan / SMEMs (bidirectional FM-index walks + seed extraction), or
      host MEMs -> SoC -> harmonization -> set packing  (device, torch)
    -> DP planning -> banded DP + traceback (device, kernels C / C' and D)
    -> CIGAR assembly, mapping quality, small inversions, SAM

The device stage runs on the Aligner's `device` (kernels on a CUDA device,
their plain versions on the CPU). A batch whose DP problems all fit the
fused buckets takes the native C++ planner and assembler of
pipeline/finish_native.py (the port's copy of ma_tpu's); any other batch (long
reads) takes the Python planner and assembler of pipeline/nw.py, exactly
where ma_tpu does. Paired reads go through pipeline/paired.py over
`Aligner.align_batch`.
"""
from __future__ import annotations

import dataclasses
from typing import IO, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ma_tpu_torch.config.parameters import ParameterSet, ParameterSetManager
from ma_tpu_torch.containers.alignment import Alignment
from ma_tpu_torch.containers.nucseq import NucSeq, revcomp_codes
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.index.fmd_index import FMDIndex
from ma_tpu_torch.io.sam import SamWriter
from ma_tpu_torch.pipeline import finish_native
from ma_tpu_torch.pipeline.quality import mapping_quality
from ma_tpu_torch.utils import profile
from ma_tpu_torch.utils.profile import AnalyzeRuntimes
from ma_tpu_torch.index.minimizer import MinimizerIndex, minimizer_seeding
from ma_tpu_torch.ops.extract import INT_MAX, SeedBatch, compute_delta, extract_seeds
from ma_tpu_torch.ops.filters import min_length, seed_lump
from ma_tpu_torch.ops.harmonize import HarmBatch, harmonization
from ma_tpu_torch.ops.occ import FMDDev
from ma_tpu_torch.ops.sdust import dust_mask_array
from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding
from ma_tpu_torch.ops.soc import SoCBatch, soc_collect
from ma_tpu_torch.pipeline.inversions import small_inversions
from ma_tpu_torch.pipeline.nw import Dispatched, NWAligner, NWConfig, collect, dispatch


def _next_pow2(n: int, lo: int = 32) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


@dataclasses.dataclass(frozen=True)
class DeviceStageConfig:
    """Shape-determining parameters of the device stage. Capacities scale
    with the padded read length L of the batch bucket."""

    seeding_technique: str
    mm_k: int
    mm_w: int
    max_segs: int
    max_seeds: int
    max_socs_collect: int
    max_socs_harm: int
    seeds_per_soc: int
    min_seed_len: int
    min_ambiguity: int
    max_ambiguity: int
    skip_ambiguous: bool
    rectangular: bool
    fixed_soc_width: int
    match: int
    extend: int
    gap: int
    min_socs: int
    do_heuristics: bool
    switch_qlen: int
    score_tolerance: float
    harm_score_min: int
    harm_score_min_rel: float
    score_diff_tolerance: float
    max_lookahead: int
    max_delta_dist: float
    min_delta_dist: int
    min_genome_size: int = 10_000_000
    n_cand: int = 8
    max_out_sets: int = 8

    @classmethod
    def from_params(cls, pset: ParameterSet, padded_len: int,
                    cap_boost: int = 1) -> "DeviceStageConfig":
        """`cap_boost` multiplies the per-read capacities (seed slots, SoC
        window width, segment slots) for the overflow-rescue pass."""
        g = pset.get
        L = padded_len
        cb = max(int(cap_boost), 1)
        max_socs = int(g("Maximal Number of SoCs"))
        return cls(
            seeding_technique=str(g("Seeding Technique")),
            mm_k=int(g("Minimizers - k")),
            mm_w=int(g("Minimizers - w")),
            max_segs=_next_pow2(max(64, cb * (L // 4))),
            max_seeds=min(_next_pow2(max(256, L) * cb), 8192 * cb),
            max_socs_collect=_next_pow2(max(32, max_socs), lo=32),
            seeds_per_soc=min(_next_pow2(max(64, L // 8) * cb, lo=64), 2048 * cb),
            min_seed_len=int(g("Minimal Seed Length")),
            min_ambiguity=int(g("Minimal Ambiguity")),
            max_ambiguity=int(g("Maximal Ambiguity")),
            skip_ambiguous=bool(g("Skip Ambiguous Seeds")),
            rectangular=bool(g("Rectangular SoC")),
            fixed_soc_width=int(g("Fixed SoC Width")),
            match=int(g("Match Score")),
            extend=int(g("Extend Penalty")),
            gap=int(g("Gap penalty")),
            min_socs=int(g("Minimal Number of SoCs")),
            do_heuristics=not bool(g("Disable All Heuristics")),
            switch_qlen=int(g("Harmonization Score Drop-off - Minimal Query Length")),
            score_tolerance=float(g("SoC Score Drop-off")),
            harm_score_min=int(g("Minimal Harmonization Score")),
            harm_score_min_rel=float(g("Relative Minimal Harmonization Score")),
            score_diff_tolerance=float(g("Harmonization Drop-off A - Score Difference")),
            max_lookahead=int(g("Harmonization Drop-off B - Lookahead")),
            max_delta_dist=float(g("Artifact Filter A - Maximal Delta Distance")),
            min_delta_dist=int(g("Artifact Filter B - Minimal Delta Distance")),
            min_genome_size=int(g("Minimum Genome Size for Heuristics")),
            n_cand=4 if (L <= 256 or L >= 8192) else 8,
            max_socs_harm=min(
                max_socs,
                8 if L <= 256 else (16 if (L <= 1024 or L >= 8192) else max_socs),
            ),
        )


def dust_masked(seqs: np.ndarray, lens: np.ndarray, thres: int) -> np.ndarray:
    """A copy of a [B, L] code batch with each read's SDUST low-complexity
    spans (threshold `thres`) set to 4 (N)."""
    out = seqs.copy()
    for b in range(len(seqs)):
        n = int(lens[b])
        if n:
            out[b, :n][dust_mask_array(seqs[b, :n], T=thres)] = 4
    return out


def _harm_pack_core(harm: HarmBatch, overflow: torch.Tensor, max_sets: int = 0):
    """Compaction of a HarmBatch for the host.

    data [2, B*G*M] int32: the valid seeds of valid sets in (read, set,
    seed) order — row 0 q_start << 16 | length, row 1 ref_start — followed
    by zeros. meta [B * G_out] int32, one word per set: bit 0 set_valid,
    bit 1 the read's capacity-overflow flag, bits 2-9 soc_of, bits 10+ the
    set's seed count. With max_sets > 0 only the first max_sets valid sets
    of a read survive, and meta keeps G_out = max_sets words per read (valid
    sets first, original order)."""
    B, G, M = harm.q_start.shape
    dev = harm.q_start.device
    set_ok = harm.set_valid
    if max_sets and max_sets < G:
        rank = torch.cumsum(set_ok.to(torch.int32), 1) - 1
        set_ok = set_ok & (rank < max_sets)
    G_out = min(max_sets, G) if max_sets else G
    seed_ok = harm.valid & set_ok[:, :, None]
    ql = (harm.q_start << 16) | harm.length
    sel = seed_ok.reshape(-1)
    data = torch.zeros((2, B * G * M), dtype=torch.int32, device=dev)
    profile.host_sync(2)  # two boolean selections: each waits for its count
    picked = torch.stack([ql.reshape(-1)[sel], harm.ref_start.reshape(-1)[sel]])
    data[:, : picked.shape[1]] = picked
    n_seeds = seed_ok.sum(2, dtype=torch.int32)
    mw = (
        set_ok.to(torch.int32)
        | (overflow.to(torch.int32)[:, None] << 1)
        | (harm.soc_of.to(torch.int32) << 2)
        | (n_seeds << 10)
    )
    if G_out < G:
        order = torch.argsort((~set_ok).to(torch.int32), dim=1, stable=True)
        mw = torch.gather(mw, 1, order)[:, :G_out]
    return data, mw.reshape(B * G_out)


def _batch_overflow(cfg: DeviceStageConfig, soc: SoCBatch) -> torch.Tensor:
    """Per-read overflow: any upstream capacity overflow, or a selected SoC
    window wider than seeds_per_soc (harmonization would truncate it)."""
    K = min(cfg.max_socs_harm, soc.start.shape[1])
    sel = torch.arange(K, device=soc.start.device)[None, :] < torch.clamp(soc.n_socs, max=K)[:, None]
    wide = sel & ((soc.end[:, :K] - soc.start[:, :K]) > cfg.seeds_per_soc)
    return soc.overflow | wide.any(1)


def _soc_min_score(cfg: DeviceStageConfig, lens: torch.Tensor, genome_text_len: int):
    """SoC give-up threshold fMinLen (stripOfConsideration.cpp:21-23):
    max(rel * qlen, harm_score_min) for large genomes, 0 otherwise."""
    if genome_text_len < cfg.min_genome_size:
        return torch.zeros_like(lens)
    rel = (lens.float() * cfg.harm_score_min_rel).to(torch.int32)
    return torch.clamp(rel, min=cfg.harm_score_min)


def _stage_tail(cfg: DeviceStageConfig, seeds: SeedBatch, lens: torch.Tensor,
                contig_starts: torch.Tensor, text_len: int):
    """SoC, harmonization and set packing of a SeedBatch. Returns (harm,
    soc, data, meta)."""
    with profile.span("soc"):
        soc = soc_collect(
            seeds, lens, contig_starts, match=cfg.match, extend=cfg.extend, gap=cfg.gap,
            fixed_width=cfg.fixed_soc_width, rectangular=cfg.rectangular,
            min_score=_soc_min_score(cfg, lens, text_len), max_socs=cfg.max_socs_collect,
        )
    with profile.span("harmonization"):
        harm = harmonization(
            soc, lens, text_len=text_len, max_socs=cfg.max_socs_harm,
            min_socs=cfg.min_socs, seeds_per_soc=cfg.seeds_per_soc,
            do_heuristics=cfg.do_heuristics, switch_qlen=cfg.switch_qlen,
            score_tolerance=cfg.score_tolerance, harm_score_min=cfg.harm_score_min,
            harm_score_min_rel=cfg.harm_score_min_rel,
            score_diff_tolerance=cfg.score_diff_tolerance, max_lookahead=cfg.max_lookahead,
            max_delta_dist=cfg.max_delta_dist, min_delta_dist=cfg.min_delta_dist,
            n_cand=cfg.n_cand,
        )
    with profile.span("set packing"):
        data, meta = _harm_pack_core(harm, _batch_overflow(cfg, soc), cfg.max_out_sets)
    return harm, soc, data, meta


def device_stage_mm(cfg: DeviceStageConfig, mmi, contig_starts: torch.Tensor,
                    ref_len_forward: int, seqs: torch.Tensor, lens: torch.Tensor):
    """Minimizer device stage: sketch + CHD lookup, seed filters, SoC,
    harmonization, set packing. Returns (harm, soc, data, meta)."""
    with profile.span("seeding"):
        seeds = minimizer_seeding(
            mmi, seqs, lens, contig_starts, ref_len_forward, k=cfg.mm_k, w=cfg.mm_w,
            max_occ=cfg.max_ambiguity, max_seeds=cfg.max_seeds, rectangular=cfg.rectangular,
        )
        seeds = min_length(seed_lump(seeds), cfg.min_seed_len)
    return _stage_tail(cfg, seeds, lens, contig_starts, 2 * ref_len_forward)


def device_stage(cfg: DeviceStageConfig, fmd: FMDDev, contig_starts: torch.Tensor,
                 seqs: torch.Tensor, lens: torch.Tensor):
    """FMD device stage: maxSpan or SMEM seeding, seed extraction (no
    lumping), SoC, harmonization, set packing. Returns (harm, soc, data,
    meta)."""
    seed_fn = smem_seeding if cfg.seeding_technique == "SMEMs" else max_spanning_seeding
    with profile.span("seeding"):
        segs = seed_fn(fmd, seqs, lens, max_segs=cfg.max_segs,
                       min_ambiguity=cfg.min_ambiguity, max_ambiguity=cfg.max_ambiguity)
    with profile.span("seed extraction"):
        seeds = extract_seeds(
            fmd, segs, lens, contig_starts, max_seeds=cfg.max_seeds,
            max_ambiguity=cfg.max_ambiguity, min_seed_len=cfg.min_seed_len,
            skip_ambiguous=cfg.skip_ambiguous, rectangular=cfg.rectangular,
        )
    return _stage_tail(cfg, seeds, lens, contig_starts, fmd.n)


def device_stage_from_seeds(cfg: DeviceStageConfig, contig_starts: torch.Tensor,
                            ref_len_forward: int, seeds: SeedBatch, lens: torch.Tensor):
    """SoC, harmonization and set packing of a SeedBatch built elsewhere
    (host MEM seeding); the delta values are recomputed here."""
    delta = compute_delta(seeds.q_start, seeds.length, seeds.ref_start, seeds.on_forward,
                          lens[:, None], contig_starts, ref_len_forward, cfg.rectangular)
    seeds = seeds._replace(delta=torch.where(seeds.valid, delta, INT_MAX))
    return _stage_tail(cfg, seeds, lens, contig_starts, 2 * ref_len_forward)


def mem_seed_batch(fmd: FMDIndex, seqs: np.ndarray, lens: np.ndarray,
                   cfg: DeviceStageConfig, device) -> SeedBatch:
    """Host MEM seeding (ops/mem_seeding.py, a copy of ma_tpu's) of a
    [B, L] batch -> SeedBatch on `device` (at most cfg.max_seeds seeds per
    read; the rest flag the read as overflowed)."""
    from ma_tpu_torch.ops.mem_seeding import materialize_mem_seeds, mem_seeding

    B, S = seqs.shape[0], cfg.max_seeds
    cols = np.zeros((5, B, S), np.int64)  # q_start, length, ref_start, on_forward, ambiguity
    valid = np.zeros((B, S), bool)
    n_seeds = np.zeros(B, np.int32)
    overflow = np.zeros(B, bool)
    for b in range(B):
        segs = mem_seeding(fmd, seqs[b, : lens[b]], min_seed_size=cfg.min_seed_len - 1,
                           min_ambiguity=cfg.min_ambiguity, max_ambiguity=cfg.max_ambiguity)
        tuples = materialize_mem_seeds(fmd, segs, cfg.max_ambiguity)
        if len(tuples) > S:
            overflow[b] = True
            tuples = tuples[:S]
        if tuples:
            cols[:, b, : len(tuples)] = np.asarray(tuples, np.int64).T
        valid[b, : len(tuples)] = True
        n_seeds[b] = len(tuples)
    t = lambda a, dt=torch.int32: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    z = torch.zeros((B, S), dtype=torch.int32, device=device)
    profile.host_sync(8)  # the eight uploads below
    return SeedBatch(
        q_start=t(cols[0]), length=t(cols[1]), ref_start=t(cols[2]),
        on_forward=t(cols[3], torch.bool), ambiguity=t(cols[4]), delta=z, soc_nt=z,
        valid=t(valid, torch.bool), n_seeds=t(n_seeds), overflow=t(overflow, torch.bool),
    )


@dataclasses.dataclass
class PlannedBatch:
    """A read batch between plan_batch and collect_batch, its DP launched.
    The native path keeps the C++ plan (its tokens, each seed set's
    begin_ref `sbr`, read and strip) and its DP in flight (`dp`); the
    Python path keeps its NWAligner (`nw`: the problems and their DP) and
    its seed sets' plans."""

    reads: Sequence[NucSeq]
    seqs_np: np.ndarray
    overflow: np.ndarray  # per read: a fixed-shape capacity truncated work
    dp: Optional[Dispatched] = None
    toks: Optional[np.ndarray] = None
    sbr: Optional[np.ndarray] = None
    set_read: Optional[np.ndarray] = None
    set_soc: Optional[np.ndarray] = None
    nw: Optional[NWAligner] = None
    plans: Optional[list] = None


class Aligner:
    """Single-end aligner over a Pack, on an explicit device. `fmd` is the
    host FMD index of the pack for the FMD techniques (maxSpan, SMEMs,
    MEMs); it is built on first use when not given. `index_prefix` names
    the stored index (`<prefix>.mmi.npz`): its minimizer index is used when
    its k and w match the parameters, else one is built."""

    def __init__(self, pack: Pack, params: ParameterSetManager | ParameterSet | None = None,
                 *, device, fmd: FMDIndex | None = None, index_prefix: str | None = None):
        if params is None:
            params = ParameterSetManager()
        self.pset: ParameterSet = (
            params.selected if isinstance(params, ParameterSetManager) else params
        )
        self.device = torch.device(device)
        self.pack = pack
        self.contig_starts = torch.as_tensor(
            np.asarray(pack.starts, np.int32), device=self.device
        )
        self.nw_cfg = NWConfig(self.pset)
        self._mmi_dev = None
        self._index_prefix = index_prefix
        self.fmd_host = fmd
        self._fmd_dev = None
        codes = np.asarray(pack.codes, np.uint8)
        # folded genome codes (forward || reverse complement): the DP windows
        # are cut from text_dev on the device, the native finish reads text_host
        self.text_host = np.concatenate([codes, revcomp_codes(codes)])
        self.text_dev = torch.as_tensor(self.text_host, device=self.device)
        # reads whose fixed-shape capacities truncated work this run
        self.n_overflow_reads = 0
        # overflow rescue: flagged reads re-align through a cap_boost'ed stage
        self.cap_boost = 1
        self.n_rescued_reads = 0
        self._in_rescue = False
        # small-inversion windows re-aligned, and inversion alignments found
        self.n_inversion_windows = 0
        self.n_inversions = 0

    TECHNIQUES = ("minimizers", "maxSpan", "SMEMs", "MEMs")

    @property
    def profiler(self) -> AnalyzeRuntimes | None:
        """The process's tracer (utils/profile.py); setting it installs one
        for every stage of the process, on this Aligner's device."""
        return profile.current()

    @profiler.setter
    def profiler(self, tracer: AnalyzeRuntimes | None) -> None:
        profile.install(tracer, self.device)

    def _check_supported(self) -> None:
        technique = str(self.pset.get("Seeding Technique"))
        if technique not in self.TECHNIQUES:
            raise NotImplementedError(f"Seeding Technique = {technique}")

    def mmi_dev(self, cfg: DeviceStageConfig):
        """The device minimizer index: the stored one under index_prefix
        when its k and w match, else one built on first use."""
        if self._mmi_dev is None:
            mmi = None
            if self._index_prefix and MinimizerIndex.exists(self._index_prefix):
                stored = MinimizerIndex.load(self._index_prefix)
                if stored.k == cfg.mm_k and stored.w == cfg.mm_w:
                    mmi = stored
            if mmi is None:
                mmi = MinimizerIndex.build(self.pack, k=cfg.mm_k, w=cfg.mm_w)
            self._mmi_dev = mmi.to_device(self.device)
        return self._mmi_dev

    def fmd(self) -> FMDIndex:
        """The host FMD index, built on first use."""
        if self.fmd_host is None:
            self.fmd_host = FMDIndex.build(self.pack)
        return self.fmd_host

    def fmd_dev(self) -> FMDDev:
        """The FMD index on the device, uploaded on first use."""
        if self._fmd_dev is None:
            self._fmd_dev = FMDDev.from_host(self.fmd(), self.device)
        return self._fmd_dev

    # ----------------------------------------------------------------- device
    def run_device_stage(self, seqs: np.ndarray, lens: np.ndarray):
        """The device stage on a [B, L] batch of codes. Returns (harm, soc,
        packed data, packed meta, seqs on the device)."""
        self._check_supported()
        cfg = DeviceStageConfig.from_params(self.pset, seqs.shape[1], cap_boost=self.cap_boost)
        profile.host_sync(2)  # two uploads from pageable memory
        seqs_d = torch.as_tensor(seqs, device=self.device)
        lens_d = torch.as_tensor(np.asarray(lens, np.int32), device=self.device)
        ref_len = self.pack.unpacked_size_forward_strand
        if cfg.seeding_technique == "minimizers":
            seed_d = seqs_d
            thres = int(self.pset.get("Minimizers - SDUST Threshold"))
            if thres > 0:
                # SDUST: low-complexity spans become N for seeding only; the
                # DP reads the real bases (seqs_d)
                profile.host_sync()  # the upload from pageable memory
                seed_d = torch.as_tensor(dust_masked(seqs, lens, thres), device=self.device)
            out = device_stage_mm(cfg, self.mmi_dev(cfg), self.contig_starts, ref_len,
                                  seed_d, lens_d)
        elif cfg.seeding_technique == "MEMs":
            with profile.span("seeding"):
                seeds = mem_seed_batch(self.fmd(), seqs, lens, cfg, self.device)
            out = device_stage_from_seeds(cfg, self.contig_starts, ref_len, seeds, lens_d)
        else:
            out = device_stage(cfg, self.fmd_dev(), self.contig_starts, seqs_d, lens_d)
        harm, soc, data, meta = out
        return harm, soc, data, meta, seqs_d

    # ------------------------------------------------------------------- host
    @staticmethod
    def _pad_batch(reads: Sequence[NucSeq], B: int):
        L = _next_pow2(max(len(r) for r in reads))
        seqs = np.full((B, L), 4, np.uint8)
        lens = np.zeros(B, np.int32)
        for i, r in enumerate(reads):
            seqs[i, : len(r)] = r.codes
            lens[i] = len(r)
        return seqs, lens

    def align_batch(self, reads: Sequence[NucSeq], pad_to: int = 0) -> List[List[Alignment]]:
        """Align a batch of reads (padded to one length bucket); `pad_to` pads
        the batch with empty rows (the rescue pass uses a fixed small batch)."""
        if not reads:
            return []
        B = len(reads)
        if pad_to:
            while pad_to < B:
                pad_to *= 2
            B = pad_to
        seqs, lens = self._pad_batch(reads, B)
        with profile.span("device seed+soc+harmonize"):
            _harm, _soc, data, meta, seqs_d = self.run_device_stage(seqs, lens)
        return self.collect_batch(self.plan_batch(reads, data, meta, seqs_d, seqs))

    def plan_batch(self, reads: Sequence[NucSeq], data_d, meta_d, seqs_dev,
                   seqs_np) -> PlannedBatch:
        """Download the packed sets, plan the DP problems and launch the DP:
        the native C++ plan when every problem fits the fused buckets, the
        Python planner otherwise."""
        with profile.span("device stage wait"):
            # meta word: bit0 valid, bit1 overflow, bits2-9 soc_of, bits10+ n_seeds
            profile.host_sync()
            mw = meta_d.cpu().numpy().reshape(seqs_np.shape[0], -1)
            hsv = (mw & 1).astype(bool)
            hsoc = ((mw >> 2) & 255).astype(np.int32)
            hn = (mw >> 10).astype(np.int32)
            overflow = ((mw[:, 0] >> 1) & 1).astype(bool)
            if not self._in_rescue:
                self.n_overflow_reads += int(overflow.sum())
            profile.host_sync()
            hqlr = data_d[:, : int(hn.sum())].cpu().numpy()
        # data row0 = q_start << 16 | length, row1 = ref_start
        hq, hl, hr = hqlr[0] >> 16, hqlr[0] & 0xFFFF, hqlr[1]
        pb = PlannedBatch(reads, seqs_np, overflow)
        if not self._plan_native(pb, seqs_dev, hq, hl, hr, hn, hsoc):
            self._plan_python(pb, seqs_dev, hq, hl, hr, hn, hsv, hsoc)
        return pb

    def _plan_python(self, pb: PlannedBatch, seqs_dev, hq, hl, hr, hn, hsv, hsoc) -> None:
        """Python planning of every valid seed set, then the DP launches
        (pipeline/nw.py)."""
        nw = NWAligner(self.pack, self.nw_cfg, self.text_dev, seqs_dev, self.text_host,
                       pb.seqs_np)
        G = hn.shape[1]
        offs = np.concatenate(([0], np.cumsum(hn.reshape(-1))))
        plans = []
        with profile.span("host DP planning"):
            for b in range(len(pb.reads)):
                codes = pb.reads[b].codes
                for gset in np.nonzero(hsv[b])[0]:
                    s, e = offs[b * G + gset], offs[b * G + gset + 1]
                    if s == e:
                        continue
                    seeds = [(int(hq[k]), int(hl[k]), int(hr[k])) for k in range(s, e)]
                    out = nw.plan_set(codes, seeds, read_idx=b)
                    if out is not None:
                        plans.append((b, int(hsoc[b, gset]), out))
        nw.dispatch_batches()
        pb.nw, pb.plans = nw, plans

    def _plan_native(self, pb: PlannedBatch, seqs_dev, hq, hl, hr, hn, hsoc) -> bool:
        """C++ planning, then the DP launches (pipeline/nw.py `dispatch`).
        False where ma_tpu takes its Python path: the planner's output
        overflowed, or a problem exceeds the fused buckets (query > 256 or
        reference > 768)."""
        B, G = hn.shape
        flat_n = hn.reshape(-1)
        sel = np.flatnonzero(flat_n)  # candidate sets (invalid sets have n = 0)
        with profile.span("host DP planning"):
            set_off = np.zeros(len(sel) + 1, np.int64)
            np.cumsum(flat_n[sel], out=set_off[1:])
            set_read = (sel // G).astype(np.int32)
            set_soc = hsoc.reshape(-1)[sel].astype(np.int32)
            planned = finish_native.plan(
                self.pack, self.nw_cfg, pb.reads, pb.seqs_np, np.ascontiguousarray(hq, np.int32),
                np.ascontiguousarray(hl, np.int32), np.ascontiguousarray(hr, np.int32),
                set_off, set_read, set_soc,
            )
        if planned is None:
            return False
        desc, toks, sbr = planned  # desc [n, 9]: a descriptor row, then is_global
        if len(desc) and (int(desc[:, 2].max()) > 256 or int(desc[:, 5].max()) > 768):
            return False
        pb.toks, pb.sbr, pb.set_read, pb.set_soc = toks, sbr, set_read, set_soc
        pb.dp = dispatch(desc, desc[:, 8] != 0, self.text_dev, seqs_dev, self.nw_cfg)
        return True

    def _assemble_native(self, pb: PlannedBatch):
        """Wait for the DP (`collect`), then the C++ assembler. Returns
        (out_op, out_len, out_off, out_meta)."""
        with profile.span("device banded DP + traceback"):
            prob_runs, prob_off, prob_meta = collect(pb.dp, self.text_host, pb.seqs_np)
        with profile.span("host CIGAR assembly"):
            return finish_native.assemble(
                pb.toks, pb.sbr, pb.set_read, prob_runs, prob_off, prob_meta,
                self.text_host, pb.seqs_np, self.nw_cfg.params, self.nw_cfg.sv_penalty,
            )

    def _alignments(self, pb: PlannedBatch, assembled) -> List[List[Alignment]]:
        out_op, out_len, out_off, out_meta = assembled
        with profile.span("host CIGAR assembly"):
            per_read = finish_native.build_alignments(
                out_op, out_len, out_off, out_meta, pb.set_read, pb.set_soc, pb.reads,
                self.nw_cfg.params, self.nw_cfg.sv_penalty,
            )
        return self._quality_phase(pb.reads, per_read)

    def _collect_native_sam(self, pb: PlannedBatch, omit_sec: bool, omit_sup: bool):
        """Collect straight to SAM text: ("sam", bytes) or, when the C++
        writer declines the batch (CG-tag cigars), ("objects", alignments)."""
        assembled = self._assemble_native(pb)
        out_op, out_len, out_off, out_meta = assembled
        g = self.pset.get
        with profile.span("host SAM write"):
            res = finish_native.emit_sam(
                out_op, out_len, out_off, out_meta, pb.set_read, pb.set_soc, pb.reads,
                pb.seqs_np, self.pack, match=int(g("Match Score")),
                max_supplementary=int(g("Number Supplementary Alignments")),
                max_overlap=float(g("Maximal Supplementary Overlap")),
                report_n=int(g("Maximal Number of Reported Alignments")),
                min_score=int(g("Minimal Alignment Score")),
                soft_clip=bool(g("Soft clip")), use_m=bool(g("Use M in CIGAR")),
                omit_sec=omit_sec, omit_sup=omit_sup,
            )
        if res is not None:
            return ("sam", res[0])
        return ("objects", self._alignments(pb, assembled))

    def _maybe_rescue(self, pb: PlannedBatch, results):
        """Reads whose fixed-shape capacities truncated seeds or SoC windows
        re-align through a cap_boost'ed device stage; their results replace
        the truncated ones."""
        reads = pb.reads
        if self._in_rescue or not pb.overflow.any():
            return results
        idx = [int(i) for i in np.flatnonzero(pb.overflow) if i < len(reads) and len(reads[i])]
        if not idx:
            return results
        self._in_rescue = True
        old = self.cap_boost
        self.cap_boost = max(4 * old, 4)
        try:
            with profile.span("overflow rescue"):
                res2 = self.align_batch([reads[i] for i in idx], pad_to=32)
            for k, i in enumerate(idx):
                results[i] = res2[k]
            self.n_rescued_reads += len(idx)
        finally:
            self.cap_boost = old
            self._in_rescue = False
        return results

    def collect_batch(self, pb: PlannedBatch) -> List[List[Alignment]]:
        """Wait for the DP, assemble, mapping quality, small inversions,
        overflow rescue."""
        if pb.nw is None:
            return self._maybe_rescue(pb, self._alignments(pb, self._assemble_native(pb)))
        with profile.span("device banded DP + traceback"):
            pb.nw.collect_batches()
        per_read: List[List[Alignment]] = [[] for _ in pb.reads]
        with profile.span("host CIGAR assembly"):
            for b, strip, (plan, begin_ref, ref) in pb.plans:
                aln = pb.nw.assemble(plan, begin_ref, ref, pb.reads[b].codes)
                aln.stats.index_of_strip = strip
                aln.stats.name = pb.reads[b].name
                per_read[b].append(aln)
        return self._maybe_rescue(pb, self._quality_phase(pb.reads, per_read))

    def _quality_phase(self, reads, per_read) -> List[List[Alignment]]:
        """Mapping quality, then small inversions (after mapping quality, so
        the inversions keep their MAPQ of 0)."""
        g = self.pset.get
        with profile.span("host mapping quality"):
            result = [
                mapping_quality(
                    alns, len(reads[b]), match=int(g("Match Score")),
                    max_supplementary=int(g("Number Supplementary Alignments")),
                    max_overlap_supplementary=float(g("Maximal Supplementary Overlap")),
                    report_n=int(g("Maximal Number of Reported Alignments")),
                    min_score=int(g("Minimal Alignment Score")),
                )
                for b, alns in enumerate(per_read)
            ]
        if bool(g("Detect Small Inversions")):
            with profile.span("small inversions"):
                n_win, n_inv = small_inversions(
                    result, reads, self.pack, device=self.device, params=self.nw_cfg.params,
                    band=self.nw_cfg.band_ext, zdrop_inv=int(g("Z Drop Inversions")),
                    harm_score_min=int(g("Minimal Harmonization Score")),
                    disable_heuristics=bool(g("Disable All Heuristics")),
                )
            self.n_inversion_windows += n_win
            self.n_inversions += n_inv
        return result

    # --------------------------------------------------------------- frontend
    def align_to_sam(self, reads: Iterable[NucSeq], out: IO[str], batch_size: int = 256,
                     cmd: str = "ma_tpu_torch", progress=None) -> int:
        """Stream reads -> SAM records; returns the number of reads.

        Reads are grouped into batches by padded length (a bucket flushes at
        batch_size reads, fewer for long reads) and written in flush order.
        `progress(n_done)` is called after each batch; False cancels."""
        self._check_supported()
        g = self.pset.get
        ngmlr = bool(g("Emulate NGMLR's tag output"))
        writer = SamWriter(
            out, self.pack, cmd=cmd, soft_clip=bool(g("Soft clip")),
            use_m_cigar=bool(g("Use M in CIGAR")), ngmlr_tags=ngmlr,
            cg_tag=bool(g("Output long cigars in CG tag")),
        )
        omit_sec = bool(g("Omit Secondary Alignments"))
        omit_sup = bool(g("Omit Supplementary Alignments"))
        # NGMLR tags and small inversions need Alignment objects
        sam_native = not (ngmlr or bool(g("Detect Small Inversions")))
        n = 0

        def run(bucket: List[NucSeq]):
            with profile.batch():
                run_batch(bucket)

        def run_batch(bucket: List[NucSeq]):
            nonlocal n
            with profile.span("host batch prep"):
                seqs, lens = self._pad_batch(bucket, len(bucket))
            with profile.span("device seed+soc+harmonize"):
                _harm, _soc, data, meta, seqs_d = self.run_device_stage(seqs, lens)
            pb = self.plan_batch(bucket, data, meta, seqs_d, seqs)
            # the rescue needs Alignment objects
            if pb.nw is not None or not sam_native or pb.overflow.any():
                results = self.collect_batch(pb)
            else:
                kind, res = self._collect_native_sam(pb, omit_sec, omit_sup)
                if kind == "sam":
                    with profile.span("host SAM write"):
                        writer.write_text(res.decode("ascii"))
                    n += len(bucket)
                    results = None
                else:
                    results = res
            if results is not None:
                with profile.span("host SAM write"):
                    for read, alns in zip(bucket, results):
                        if omit_sec:
                            alns = [a for a in alns if not a.secondary]
                        if omit_sup:
                            alns = [a for a in alns if not a.supplementary]
                        writer.write(alns, read)
                        n += 1
            if progress is not None and progress(n) is False:
                raise KeyboardInterrupt("alignment cancelled by progress callback")

        buckets: dict = {}
        for read in reads:
            key = _next_pow2(max(len(read), 1))
            buckets.setdefault(key, []).append(read)
            eff = batch_size if key <= 512 else max(32, batch_size * 512 // key)
            if len(buckets[key]) >= eff:
                run(buckets.pop(key))
        for bucket in buckets.values():
            run(bucket)
        return n
