"""MSV pipeline: reads -> jumps -> calls (port of ma_tpu/msv/pipeline.py).

Re-design of the reference MSV python scripts
(reference: libs/msv/python/computeSvJumps.py:6-122 — per-thread graph
MMFilteredSeeding -> SeedLumping -> SoC -> SvJumpsFromExtractedSeeds ->
JumpInserter — and libs/msv/python/sweepSvJumps.py:7-160 — section sweep ->
call filters -> inserter).

Device: one seed stage (minimizer seeding + lumping + min length + SoC, so
kernel A on a CUDA device) per read chunk, then the window-covered seeds
compacted on the device and downloaded once. Host: jump enumeration per
read (native/sv_enum.cpp) and the plane-sweep clustering. Every entry point
that touches the device takes an explicit `device`; there is no default.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from ma_tpu_torch.containers.nucseq import NucSeq
from ma_tpu_torch.containers.pack import Pack
from ma_tpu_torch.index.minimizer import MinimizerIndex, minimizer_seeding
from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import JumpParams, SvJump
from ma_tpu_torch.msv.jumps_batch import jumps_from_seed_csr
from ma_tpu_torch.msv.sweep import (
    filter_fuzzy_calls,
    filter_low_support_short_calls,
    sweep_jumps,
)
from ma_tpu_torch.native import sv_enum as sv_enum_native
from ma_tpu_torch.ops.extend_host import extend_seeds
from ma_tpu_torch.ops.filters import min_length, seed_lump
from ma_tpu_torch.ops.hash_seeding import reseed_gaps
from ma_tpu_torch.ops.soc import soc_collect
from ma_tpu_torch.utils import profile

MAX_SEEDS = 2048  # seed slots a read
MAX_SOCS = 64  # SoC windows a read
PACKED_MAX_S = 32768  # the packed download's window bounds are 16 bits


def sv_seed_stage(mmi_dev, contig_starts, ref_len_forward, seqs, lens, *, device,
                  k: int = 15, w: int = 10, max_occ: int = 10000,
                  min_seed_len: int = 18):
    """Device stage: minimizer seeds -> lumping -> min length -> SoC (the
    MMFilteredSeeding + SeedLumping + SoC part of computeSvJumps.py:52-86).
    `seqs` [B, L] uint8 codes and `lens` [B] (numpy or tensors) go to
    `device` as they are; returns the SoCBatch there."""
    seqs = torch.as_tensor(seqs, device=device)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=device)
    seeds = minimizer_seeding(
        mmi_dev, seqs, lens, contig_starts, ref_len_forward, k=k, w=w,
        max_occ=max_occ, max_seeds=MAX_SEEDS, rectangular=False,
    )
    seeds = min_length(seed_lump(seeds), min_seed_len)
    return soc_collect(seeds, lens, contig_starts, rectangular=False, max_socs=MAX_SOCS)


def _soc_pack_csr(soc, min_nt: int):
    """Device-side CSR compaction of a SoCBatch for the host transfer.

    Only seeds covered by a selected SoC window (k < n_socs, score >=
    min_nt) are ever read by the enumeration front end (feasible_socs /
    native sv_enum walk window ranges), so exactly those are kept: a
    coverage mask from each read's window bounds (+1 at a start, -1 at an
    end, a running sum), its cumsum as each seed's read-local rank, and
    boolean indexing in row-major order (read, then slot; read, then
    window). Returns one int32 host array: cnt [B], wcnt [B], the windows'
    start << 16 | end (bounds remapped to the ranks) and scores, then the
    seeds' q << 1 | fw, length and ref_start, each over its flat CSR."""
    sd = soc.seeds
    B, S = sd.q_start.shape
    K = soc.start.shape[1]
    dev = sd.q_start.device
    st, en = soc.start.long(), soc.end.long()
    sel_k = (torch.arange(K, device=dev)[None, :] < soc.n_socs[:, None]) & (
        soc.score >= min_nt
    )
    live = sel_k & (st < en)
    edge = torch.zeros((B, S + 1), dtype=torch.int32, device=dev)
    one = live.to(torch.int32)
    edge.scatter_add_(1, st.clamp(0, S), one)
    edge.scatter_add_(1, en.clamp(0, S), -one)
    cov = torch.cumsum(edge, 1)[:, :S] > 0
    keep = cov & sd.valid
    cum = torch.cumsum(keep.to(torch.int32), 1, dtype=torch.int32)
    cnt = cum[:, -1]
    # window bounds -> read-local compacted ranks (the exclusive cumsum)
    cum_pad = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev), cum], 1)
    new_st = torch.gather(cum_pad, 1, st.clamp(0, S))
    new_en = torch.gather(cum_pad, 1, en.clamp(0, S))
    wse = (new_st << 16) | new_en
    wcnt = sel_k.sum(1, dtype=torch.int32)
    p0 = (sd.q_start << 1) | sd.on_forward.to(torch.int32)
    flat = torch.cat([cnt, wcnt, wse[sel_k], soc.score[sel_k],
                      p0[keep], sd.length[keep], sd.ref_start[keep]])
    return flat.cpu().numpy()


class SocHost:
    """One-shot host copy of a SoCBatch: feasible_socs and the native
    enumeration index numpy arrays instead of device slices.

    With `min_nt` (and fewer than 32,768 seed slots) only the seeds under
    a selected window come down, as a packed CSR (_soc_pack_csr), and the
    dense per-read arrays are rebuilt on the host: q, l, r, fw, va [B, mx]
    with mx = max(max cnt, 1); starts, ends, scores [B, kx] with kx =
    max(max wcnt, 1); n_socs = wcnt. Otherwise the seed columns come down
    sliced to the populated pow2 prefix (at least 128 slots) and the window
    planes whole."""

    __slots__ = ("q", "l", "r", "fw", "va", "starts", "ends", "scores",
                 "n_socs")

    def __init__(self, soc, min_nt: int = None):
        if min_nt is not None and int(soc.seeds.valid.shape[1]) < PACKED_MAX_S:
            self._init_packed(soc, min_nt)
            return
        sd = soc.seeds
        S = int(sd.valid.shape[1])
        slot = torch.arange(1, S + 1, device=sd.valid.device)[None, :]
        ci = torch.arange(soc.end.shape[1], device=sd.valid.device)[None, :]
        hi = int(torch.maximum(
            torch.where(sd.valid, slot, 0).max(),
            torch.where(ci < soc.n_socs[:, None], soc.end, 0).max().long(),
        )) if S else 0
        Sh = 128
        while Sh < hi:
            Sh *= 2
        Sh = min(Sh, S)
        (self.q, self.l, self.r, self.fw, self.va, self.starts, self.ends,
         self.scores, self.n_socs) = (
            a.cpu().numpy() for a in (
                sd.q_start[:, :Sh], sd.length[:, :Sh], sd.ref_start[:, :Sh],
                sd.on_forward[:, :Sh], sd.valid[:, :Sh],
                soc.start, soc.end, soc.score, soc.n_socs,
            )
        )

    def _init_packed(self, soc, min_nt: int):
        B = int(soc.n_socs.shape[0])
        flat = _soc_pack_csr(soc, min_nt)
        cnt = flat[:B].astype(np.int64)
        wcnt = flat[B : 2 * B].astype(np.int64)
        total, wtotal = int(cnt.sum()), int(wcnt.sum())
        o = 2 * B
        wse, wsc = flat[o : o + wtotal], flat[o + wtotal : o + 2 * wtotal]
        o += 2 * wtotal
        d0, d1, d2 = (flat[o + i * total : o + (i + 1) * total] for i in range(3))
        mx = max(int(cnt.max()) if B else 0, 1)
        mask = np.arange(mx)[None, :] < cnt[:, None]
        self.q = np.zeros((B, mx), np.int32)
        self.l = np.zeros((B, mx), np.int32)
        self.r = np.zeros((B, mx), np.int32)
        self.fw = np.zeros((B, mx), bool)
        self.q[mask] = d0 >> 1
        self.fw[mask] = (d0 & 1).astype(bool)
        self.l[mask] = d1
        self.r[mask] = d2
        self.va = mask
        kx = max(int(wcnt.max()) if B else 0, 1)
        wmask = np.arange(kx)[None, :] < wcnt[:, None]
        self.starts = np.zeros((B, kx), np.int32)
        self.ends = np.zeros((B, kx), np.int32)
        self.scores = np.zeros((B, kx), np.int32)
        self.starts[wmask] = wse >> 16
        self.ends[wmask] = wse & 0xFFFF
        self.scores[wmask] = wsc
        self.n_socs = wcnt.astype(np.int32)


def feasible_socs(
    soc, b: int, min_nt: int, soc_height: int = 0
) -> List[List[tuple]]:
    """GetAllFeasibleSoCsAsSet (stripOfConsideration.h:234-285): every SoC
    with accumulated nt >= min_nt, split on query gaps > soc_height, gap
    pieces below min_nt dropped. Returns seed-tuple lists (nt = SoC score).

    `soc` may be a SoCBatch (device) or a SocHost snapshot."""
    if not isinstance(soc, SocHost):
        soc = SocHost(soc)
    q = soc.q[b]
    l = soc.l[b]
    r_ = soc.r[b]
    fw = soc.fw[b]
    va = soc.va[b]
    starts = soc.starts[b]
    ends = soc.ends[b]
    scores = soc.scores[b]
    n_socs = int(soc.n_socs[b])
    out: List[List[tuple]] = []
    for si in range(n_socs):
        nt = int(scores[si])
        if nt < min_nt:
            continue
        idx = [m for m in range(int(starts[si]), int(ends[si])) if va[m]]
        seeds = sorted(
            ((int(q[m]), int(l[m]), int(r_[m]), bool(fw[m]), nt) for m in idx),
            key=lambda t: t[0],
        )
        if not seeds:
            continue
        cur: List[tuple] = []
        cur_nt = 0
        max_q = seeds[0][0] + seeds[0][1]
        for sd_t in seeds:
            if sd_t[0] > max_q + soc_height:
                if cur_nt >= min_nt:
                    out.append(cur)
                cur, cur_nt = [], 0
            cur.append(sd_t)
            cur_nt += sd_t[1]
            max_q = max(max_q, sd_t[0] + sd_t[1])
        if cur_nt >= min_nt:
            out.append(cur)
    return out


def compute_sv_jumps_batch(
    reads: Sequence[NucSeq],
    pack: Pack,
    mmi: MinimizerIndex,
    params: JumpParams = JumpParams(),
    min_seed_len: int = 18,
    max_occ: int = 10000,
    min_nt_in_soc: int = 25,
    soc_height: int = 0,
    do_reseed: bool = True,
    batch: int = 512,
    keep_seeds: bool = False,
    *,
    device,
):
    """reads -> JumpBatch (compute_sv_jumps, computeSvJumps.py:6-122): the
    seed stage on `device` per chunk of `batch` reads, then the enumeration
    front end (feasible-SoC extraction, rectangle reseeding, maximal
    extension, per-read union) in ONE C++ call per chunk (native/sv_enum.cpp;
    the Python modules below stay as the oracles, MA_TPU_SV_ENUM=python),
    then ONE vectorized jump enumeration over all reads' seed unions
    (msv/jumps_batch.py; per-object compute_jumps stays as the oracle).

    The next chunk's seed stage is dispatched before this chunk's SoCs are
    downloaded: launches on a CUDA device are asynchronous, so its seeding
    overlaps this chunk's host enumeration. A trailing partial chunk runs at
    its own size (read ids are s + b either way)."""
    use_native = os.environ.get("MA_TPU_SV_ENUM", "native") != "python"
    mmi_dev = mmi.to_device(device)
    cst = torch.as_tensor(np.asarray(pack.starts, np.int32), device=device)
    rlf = pack.unpacked_size_forward_strand
    col_q: List[np.ndarray] = []
    col_l: List[np.ndarray] = []
    col_r: List[np.ndarray] = []
    col_fw: List[np.ndarray] = []
    col_nt: List[np.ndarray] = []
    read_off = [0]
    total = 0
    qlens: List[int] = []
    read_ids: List[int] = []

    def _dispatch(s):
        chunk = reads[s : s + batch]
        L = 32
        while L < max(len(r) for r in chunk):
            L *= 2
        seqs = np.full((len(chunk), L), 4, np.uint8)
        lens = np.zeros(len(chunk), np.int32)
        for i, r in enumerate(chunk):
            seqs[i, : len(r)] = r.codes
            lens[i] = len(r)
        dev = sv_seed_stage(mmi_dev, cst, rlf, seqs, lens, device=device, k=mmi.k,
                            w=mmi.w, max_occ=max_occ, min_seed_len=min_seed_len)
        return s, chunk, seqs, lens, dev

    starts = list(range(0, len(reads), batch))
    with profile.span("sv dispatch"):
        pending = _dispatch(starts[0]) if starts else None
    for idx in range(len(starts)):
        s, chunk, seqs, lens, dev = pending
        with profile.span("sv dispatch"):
            pending = _dispatch(starts[idx + 1]) if idx + 1 < len(starts) else None
        with profile.span("sv soc download"):
            soc = SocHost(dev, min_nt=min_nt_in_soc)
        B = len(chunk)
        with profile.span("sv enumerate"):
            if use_native:
                oq, ol, orr, ofw, ont, cnt = sv_enum_native.enumerate_batch(
                    soc, seqs, lens, pack, min_nt_in_soc, soc_height, do_reseed,
                )
                col_q.append(oq)
                col_l.append(ol)
                col_r.append(orr)
                col_fw.append(ofw)
                col_nt.append(ont)
                for b in range(B):
                    c = int(cnt[b])
                    if c == 0:
                        continue
                    total += c
                    read_off.append(total)
                    qlens.append(len(chunk[b]))
                    read_ids.append(s + b)
                continue
            for b in range(B):
                # per-SoC reseeding, then jumps over the UNION of the feasible
                # SoCs' seeds (RecursiveReseedingSoCs reduces the SeedsSet back
                # to one flat Seeds before SvJumpsFromExtractedSeeds,
                # svJumpsFromSeeds.h:605-621,691)
                union: List[tuple] = []
                for soc_seeds in feasible_socs(soc, b, min_nt_in_soc, soc_height):
                    seeds = soc_seeds
                    if do_reseed:
                        seeds = reseed_gaps(seeds, chunk[b].codes, pack)
                    # maximal extension sharpens breakpoints (SeedLumping
                    # applies SeedExtender, seedFilters.h:265-290)
                    seeds = extend_seeds(seeds, chunk[b].codes, pack)
                    union.extend(seeds)
                if not union:
                    continue
                union = sorted(set(union))
                arr = np.asarray(union, np.int64).reshape(-1, 5)
                col_q.append(arr[:, 0])
                col_l.append(arr[:, 1])
                col_r.append(arr[:, 2])
                col_fw.append(arr[:, 3].astype(bool))
                col_nt.append(arr[:, 4])
                total += len(union)
                read_off.append(total)
                qlens.append(len(chunk[b]))
                read_ids.append(s + b)

    def cat(xs, dt):
        return np.concatenate(xs) if xs else np.zeros(0, dt)

    with profile.span("sv jumps"):
        cq, cl, cr = cat(col_q, np.int64), cat(col_l, np.int64), cat(col_r, np.int64)
        cfw, cnt_ = cat(col_fw, bool), cat(col_nt, np.int64)
        jb = jumps_from_seed_csr(
            cq, cl, cr, cfw, cnt_,
            np.asarray(read_off, np.int64), np.asarray(qlens, np.int64),
            np.asarray(read_ids, np.int64), params=params,
        )
        if keep_seeds:
            # per-read seed unions for the viewer (seeds_for_reads)
            jb.read_seeds = {
                int(read_ids[i]): [
                    (int(cq[m]), int(cl[m]), int(cr[m]), bool(cfw[m]), int(cnt_[m]))
                    for m in range(read_off[i], read_off[i + 1])
                ]
                for i in range(len(read_ids))
            }
    return jb


def seeds_for_reads(
    reads: Sequence[NucSeq],
    pack: Pack,
    mmi: MinimizerIndex,
    read_ids: Sequence[int],
    min_seed_len: int = 18,
    max_occ: int = 10000,
    min_nt_in_soc: int = 25,
    soc_height: int = 0,
    do_reseed: bool = True,
    max_seeds_per_read: int = 200,
    *,
    device,
):
    """Per-read seed unions for the viewer's dot-plots (the bokeh
    renderer's seed-fetch role, sv_visualization/renderer/*): re-runs the
    enumeration front end on just `read_ids` and returns
    {read_id: [(q, l, r, fw), ...]} (longest `max_seeds_per_read` kept —
    the renderer_speedup.cpp decimation role)."""
    ids = [i for i in read_ids if 0 <= i < len(reads)]
    if not ids:
        return {}
    sel = [reads[i] for i in ids]
    jb = compute_sv_jumps_batch(
        sel, pack, mmi, min_seed_len=min_seed_len, max_occ=max_occ,
        min_nt_in_soc=min_nt_in_soc, soc_height=soc_height,
        do_reseed=do_reseed, keep_seeds=True, device=device,
    )
    out = {}
    for local_id, seeds in jb.read_seeds.items():
        if len(seeds) > max_seeds_per_read:
            seeds = sorted(seeds, key=lambda s: -s[1])[:max_seeds_per_read]
        out[ids[local_id]] = [(q, l, r, bool(fw)) for (q, l, r, fw, _) in seeds]
    return out


def compute_sv_jumps(
    reads: Sequence[NucSeq],
    pack: Pack,
    mmi: MinimizerIndex,
    *,
    device,
    **kw,
) -> List[SvJump]:
    """Object-list variant of compute_sv_jumps_batch (compat surface for
    the store/render/tests; identical jumps and ids)."""
    return compute_sv_jumps_batch(reads, pack, mmi, device=device, **kw).to_jumps()


def sweep_sv_jumps(
    jumps: Sequence[SvJump],
    min_reads: int = 2,
    max_supp_nt: int = 10,
    max_call_size: int = 20,
    max_fuzziness: int = 50,
) -> List[SvCall]:
    """jumps -> filtered calls (sweep_sv_jumps, sweepSvJumps.py:7-160)."""
    calls = sweep_jumps(jumps, min_reads=min_reads)
    calls = filter_low_support_short_calls(calls, max_supp_nt, max_call_size)
    calls = filter_fuzzy_calls(calls, max_fuzziness)
    return calls
