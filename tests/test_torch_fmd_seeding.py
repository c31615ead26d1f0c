"""ma_tpu_torch's FMD seeding path against ma_tpu's, stage by stage, for
maxSpan (the Default preset) and SMEMs (Illumina):

1. ma_tpu's own unlumped FMD seeds through the port's soc_collect ->
   harmonization -> _harm_pack_core give what ma_tpu's device_stage gives
   (the shadow sweep's float rounding on overlapping seeds of one diagonal,
   ROADMAP Queue 3, does not show on these fixtures);
2. max_spanning_seeding / smem_seeding field by field (SegmentBatch);
3. extract_seeds field by field (SeedBatch);
4. device_stage (SoCBatch, HarmBatch, packed data and meta).

Fixtures: a 60 kbp genome (96 reads at 2% substitutions), an E. coli-size
genome (512 reads at 1%), and a genome with a tandem repeat (reads with Ns,
an empty read, repeat reads). Every compared field is an integer or a bool,
so equality is exact."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.containers.pack import Pack as JPack  # noqa: E402
from ma_tpu.index.fmd_index import FMDIndex as JFMDIndex  # noqa: E402
from ma_tpu.ops import extract as JE  # noqa: E402
from ma_tpu.ops import occ as JO  # noqa: E402
from ma_tpu.ops import seeding as JS  # noqa: E402
from ma_tpu.pipeline import aligner as JA  # noqa: E402
from ma_tpu_torch.config.parameters import ParameterSetManager  # noqa: E402
from ma_tpu_torch.containers.nucseq import revcomp_codes  # noqa: E402
from ma_tpu_torch.containers.pack import Pack  # noqa: E402
from ma_tpu_torch.index.fmd_index import FMDIndex  # noqa: E402
from ma_tpu_torch.ops import extract as TE  # noqa: E402
from ma_tpu_torch.ops import occ as TO  # noqa: E402
from ma_tpu_torch.ops import seeding as TS  # noqa: E402
from ma_tpu_torch.pipeline import aligner as TA  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

TECHNIQUES = {"maxSpan": "Default", "SMEMs": "Illumina"}
GENOMES = ("60k", "ecoli", "repeat")
L = 256


def _reads(rng, genome, B, err):
    seqs = np.full((B, L), 4, np.uint8)
    lens = np.full(B, 150, np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(genome) - 150))
        codes = genome[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < err)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        seqs[i, :150] = codes
    return seqs, lens


@functools.lru_cache(maxsize=None)
def genome_fixture(name):
    """(pack, host FMD index, ma_tpu's host FMD index of the same genome,
    seqs [B, 256] uint8, lens [B] int32); the two indexes hold the same
    arrays."""
    if name == "60k":
        rng = np.random.default_rng(99)
        genome = rng.integers(0, 4, 60_000).astype(np.uint8)
        seqs, lens = _reads(rng, genome, 96, 0.02)
    elif name == "ecoli":
        rng = np.random.default_rng(1234)
        genome = rng.integers(0, 4, 4_641_652).astype(np.uint8)
        seqs, lens = _reads(rng, genome, 512, 0.01)
    else:  # the fixture of tests/test_torch_harmonize.py, with an empty read
        rng = np.random.default_rng(17)
        genome = rng.integers(0, 4, 60_000).astype(np.uint8)
        genome[30_000:30_420] = np.tile(rng.integers(0, 4, 7), 60).astype(np.uint8)
        seqs, lens = _reads(rng, genome, 24, 0.02)
        seqs[5, [7, 70, 140]] = 4
        seqs[9, :150] = 4  # all N
        seqs[10] = 4  # empty
        lens[10] = 0
        seqs[22, :150] = genome[30_100:30_250]
        seqs[23, :150] = genome[30_350:30_500]
    pack, jpack = Pack.empty(), JPack.empty()
    pack.append("g", genome)
    jpack.append("g", genome)
    fmd, jfmd = FMDIndex.build(pack), JFMDIndex.build(jpack)
    for name in ("bwt_words", "occ_cp", "L2", "ssa"):
        assert np.array_equal(getattr(fmd, name), getattr(jfmd, name)), name
    assert (fmd.n, fmd.primary) == (jfmd.n, jfmd.primary)
    return pack, fmd, jfmd, seqs, lens


def configs(technique):
    mgr = ParameterSetManager()
    mgr.set_selected(TECHNIQUES[technique])
    pset = mgr.selected
    assert pset.get("Seeding Technique") == technique
    jcfg = JA.DeviceStageConfig.from_params(pset, L)
    tcfg = TA.DeviceStageConfig.from_params(pset, L)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def seed_kw(cfg):
    return dict(max_segs=cfg.max_segs, min_ambiguity=cfg.min_ambiguity,
                max_ambiguity=cfg.max_ambiguity)


def extract_kw(cfg):
    return dict(max_seeds=cfg.max_seeds, max_ambiguity=cfg.max_ambiguity,
                min_seed_len=cfg.min_seed_len, skip_ambiguous=cfg.skip_ambiguous,
                rectangular=cfg.rectangular)


@functools.lru_cache(maxsize=None)
def run(genome, technique):
    """Both packages' segments, seeds and device stage on one fixture, and
    the port's stage tail on ma_tpu's seeds."""
    pack, fmd, jfmd, seqs, lens = genome_fixture(genome)
    jcfg, tcfg = configs(technique)
    cs = np.asarray(pack.starts, np.int32)
    jdev, tdev = JO.FMDDev.from_host(jfmd), TO.FMDDev.from_host(fmd, "cpu")
    jseed = JS.smem_seeding if technique == "SMEMs" else JS.max_spanning_seeding
    tseed = TS.smem_seeding if technique == "SMEMs" else TS.max_spanning_seeding
    jsegs = jseed(jdev, jnp.asarray(seqs), jnp.asarray(lens), **seed_kw(jcfg))
    jseeds = JE.extract_seeds(jdev, jsegs, jnp.asarray(lens), jnp.asarray(cs), **extract_kw(jcfg))
    jout = JA.device_stage(jcfg, jdev, jnp.asarray(cs), jnp.asarray(seqs), jnp.asarray(lens))
    ts, tl, tcs = torch.as_tensor(seqs), torch.as_tensor(lens), torch.as_tensor(cs)
    tsegs = tseed(tdev, ts, tl, **seed_kw(tcfg))
    tseeds = TE.extract_seeds(tdev, tsegs, tl, tcs, **extract_kw(tcfg))
    tout = TA.device_stage(tcfg, tdev, tcs, ts, tl)
    # the port's SoC + harmonization + packing on ma_tpu's seeds
    jseeds_t = TE.SeedBatch(*(torch.as_tensor(np.array(a)) for a in jseeds))
    tail = TA._stage_tail(tcfg, jseeds_t, tl, tcs, fmd.n)
    return dict(jsegs=jsegs, jseeds=jseeds, jout=jout, tsegs=tsegs, tseeds=tseeds,
                tout=tout, tail=tail)


def same_fields(a, b, names=None):
    for name in names or a._fields:
        x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
        assert x.shape == y.shape, name
        assert np.array_equal(x, y), name


def same_stage(jout, tout):
    """SoCBatch, every HarmBatch field, packed meta exactly and packed seeds
    over the populated prefix (past it ma_tpu leaves sort leftovers)."""
    (jh, jsoc, jd, jm), (th, tsoc, td, tm) = jout, tout
    same_fields(jsoc, tsoc, ("start", "end", "score", "amb", "n_socs", "overflow"))
    same_fields(jsoc.seeds, tsoc.seeds)
    same_fields(jh, th)
    jm, tm = np.asarray(jm), tm.numpy()
    assert np.array_equal(jm, tm)
    total = int((jm >> 10).sum())
    assert total > 0
    assert np.array_equal(np.asarray(jd)[:, :total], td.numpy()[:, :total])
    return jh


CASES = [(g, t) for g in GENOMES for t in TECHNIQUES]


@pytest.mark.parametrize("genome,technique", CASES)
def test_unlumped_seeds_harmonize_as_ma_tpu(genome, technique):
    """ma_tpu's FMD seeds, unlumped, through ma_tpu's device_stage and
    through the port's soc_collect -> harmonization -> _harm_pack_core."""
    r = run(genome, technique)
    jh = same_stage(r["jout"], r["tail"])
    assert np.asarray(jh.set_valid).sum() >= len(genome_fixture(genome)[3]) // 2


@pytest.mark.parametrize("genome,technique", CASES)
def test_segments(genome, technique):
    r = run(genome, technique)
    same_fields(r["jsegs"], r["tsegs"])
    assert int(r["tsegs"].n_segs.sum()) > 0


@pytest.mark.parametrize("genome,technique", CASES)
def test_extract_seeds(genome, technique):
    r = run(genome, technique)
    same_fields(r["jseeds"], r["tseeds"])
    assert int(r["tseeds"].n_seeds.sum()) > 0


@pytest.mark.parametrize("genome,technique", CASES)
def test_device_stage(genome, technique):
    r = run(genome, technique)
    same_stage(r["jout"], r["tout"])


@pytest.mark.parametrize("genome,technique", CASES)
def test_no_overlapping_seeds_on_one_diagonal(genome, technique):
    """Why the float rounding of the shadow sweep does not show: it needs
    two overlapping seeds on one diagonal, and FMD seeds are exact matches
    extended until no occurrence extends, so two of them on one diagonal
    and strand never overlap. Counted over every read's valid seeds."""
    s = run(genome, technique)["tseeds"]
    q, ln, ref, fw, valid = (x.numpy() for x in (s.q_start, s.length, s.ref_start,
                                                 s.on_forward, s.valid))
    for b in range(q.shape[0]):
        k = np.flatnonzero(valid[b])
        diag = np.where(fw[b, k], ref[b, k] - q[b, k], ref[b, k] + q[b, k])
        st, en = q[b, k], q[b, k] + ln[b, k]
        pair = ((diag[:, None] == diag[None, :]) & (fw[b, k][:, None] == fw[b, k][None, :])
                & (st[:, None] < en[None, :]) & (st[None, :] < en[:, None]))
        np.fill_diagonal(pair, False)
        assert not pair.any(), b


def test_repeat_fixture_edge_reads():
    """The empty and all-N reads give no segments; the repeat reads give
    segments that occur dozens of times."""
    for technique in TECHNIQUES:
        r = run("repeat", technique)
        n_segs = r["tsegs"].n_segs.numpy()
        assert n_segs[10] == 0 and n_segs[9] == 0
        assert (r["tsegs"].sai_size.numpy()[22:] > 30).any()


@pytest.mark.parametrize("technique", list(TECHNIQUES))
@pytest.mark.parametrize("cap", ["max_segs", "iter_cap"])
def test_overflow(technique, cap):
    """Small segment capacity or iteration cap: the same segments kept and
    the same reads flagged as in ma_tpu."""
    pack, fmd, jfmd, seqs, lens = genome_fixture("repeat")
    jcfg, _ = configs(technique)
    kw = seed_kw(jcfg)
    if cap == "max_segs":
        kw["max_segs"] = 4
    else:
        kw["iter_cap"] = 60
    jseed = JS.smem_seeding if technique == "SMEMs" else JS.max_spanning_seeding
    tseed = TS.smem_seeding if technique == "SMEMs" else TS.max_spanning_seeding
    want = jseed(JO.FMDDev.from_host(jfmd), jnp.asarray(seqs), jnp.asarray(lens), **kw)
    got = tseed(TO.FMDDev.from_host(fmd, "cpu"), torch.as_tensor(seqs), torch.as_tensor(lens),
                **kw)
    same_fields(want, got)
    assert 0 < int(got.overflow.sum()) < len(lens)


@pytest.mark.parametrize("genome", ["60k", "repeat"])
@pytest.mark.parametrize("ext_ops", [False, True])
def test_max_spanning_on_cpu_and_with_ext_ops_takes_the_eager_loop(monkeypatch, genome,
                                                                   ext_ops):
    """CPU tensors, and `ext_ops` given, run the eager step loop (the
    kernel's wrapper is never called) and give ma_tpu's segments as before;
    the tracer sees the loop's checks, not the kernel's counter."""
    from ma_tpu_torch.utils import profile

    def no_kernel(*a, **k):
        raise AssertionError("the FM-walk kernel was called")

    monkeypatch.setattr(TS, "_max_spanning_kernel", no_kernel)
    pack, fmd, _, seqs, lens = genome_fixture(genome)
    _, tcfg = configs("maxSpan")
    kw = seed_kw(tcfg)
    if ext_ops:
        kw["ext_ops"] = (TO.init_interval, TO.extend_backward)
    tr = profile.AnalyzeRuntimes()
    profile.install(tr, None)
    try:
        got = TS.max_spanning_seeding(TO.FMDDev.from_host(fmd, "cpu"), torch.as_tensor(seqs),
                                      torch.as_tensor(lens), **kw)
    finally:
        profile.install(None)
    same_fields(run(genome, "maxSpan")["jsegs"], got)
    c = tr.counters
    assert "fmd kernel reads" not in c
    assert c["fmd steps"] > 0 and c["fmd steps"] % TS.CHECK_EVERY == 0
    assert c["host syncs"] == c["fmd steps"] // TS.CHECK_EVERY + 1
