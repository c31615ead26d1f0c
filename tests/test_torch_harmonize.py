"""ma_tpu_torch harmonization against ma_tpu: the line sweep (kernel B's
plain version) against the Pallas kernel in interpret mode and the XLA
scan, harmonize_sets, and the whole minimizer device stage (SoCBatch,
HarmBatch, packed sets). Every compared field is an integer or a bool, so
equality is exact."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.ops import harmonize as JH  # noqa: E402
from ma_tpu.ops.harmonize_pallas import linesweep_sorted_pallas  # noqa: E402
from ma_tpu_torch.containers.nucseq import revcomp_codes  # noqa: E402
from ma_tpu_torch.ops import harmonize as TH  # noqa: E402
from ma_tpu_torch.ops.harmonize_cuda import linesweep_plain, linesweep_sorted_plain  # noqa: E402
from ma_tpu_torch.ops.sortops import sort_with_payloads  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)


def _shadows(seed, lead, M):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 500, lead + (M,)).astype(np.int32)
    ends = starts + rng.integers(1, 60, lead + (M,)).astype(np.int32)
    dists = (rng.random(lead + (M,)) * 30).astype(np.float32)
    dists[..., 40:48] = dists[..., 40:41]  # float ties
    valid = rng.random(lead + (M,)) < 0.7
    starts[..., 10:20] = starts[..., 10:11]  # start ties
    ends[..., 30:36] = ends[..., 30:31]  # end ties
    return starts, ends, dists, valid


@pytest.mark.parametrize("seed,lead,M", [(0, (5, 3), 64), (1, (2, 4), 64), (2, (4,), 512)])
def test_linesweep_matches_pallas_and_scan(seed, lead, M, monkeypatch):
    starts, ends, dists, valid = _shadows(seed, lead, M)
    # the port's full sweep vs the XLA scan
    got = TH._linesweep(torch.as_tensor(starts), torch.as_tensor(ends),
                        torch.as_tensor(dists), torch.as_tensor(valid)).numpy()
    monkeypatch.setenv("MA_TPU_SWEEP", "xla")
    seed_idx = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), starts.shape)
    want = np.asarray(JH._linesweep(jnp.asarray(starts), jnp.asarray(ends),
                                    jnp.asarray(dists), seed_idx, jnp.asarray(valid)))
    assert np.array_equal(got, want)
    # the plain sweep vs the Pallas kernel on the same presorted rows
    key = torch.where(torch.as_tensor(valid), torch.as_tensor(starts), 2**30).reshape(-1, M)
    orig = torch.arange(M, dtype=torch.int32).expand(key.shape)
    _, (s_end, s_dist, s_valid, s_orig) = sort_with_payloads(
        [key, -torch.as_tensor(ends).reshape(-1, M)],
        [torch.as_tensor(ends).reshape(-1, M), torch.as_tensor(dists).reshape(-1, M),
         torch.as_tensor(valid).reshape(-1, M).to(torch.int32), orig],
    )
    plain = linesweep_sorted_plain(s_end, s_dist, s_valid, s_orig).numpy()
    pallas = np.asarray(linesweep_sorted_pallas(
        jnp.asarray(s_end.numpy()), jnp.asarray(s_dist.numpy()),
        jnp.asarray(s_valid.numpy()), jnp.asarray(s_orig.numpy()), interpret=True))
    assert np.array_equal(plain, pallas)
    assert np.array_equal(plain.reshape(got.shape), got)


def _seed_sets(seed, B=6, K=4, M=64, exact=False):
    """Harmonization inputs shaped like lumped minimizer seeds: per set, seeds
    follow one diagonal in query order without overlapping, the diagonal
    shifts at a few indels, ~10% are off-diagonal outliers; genome-scale
    reference coordinates. With `exact`, every seed lies on its set's one
    diagonal (all distances 0, ties with the outlier bound)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, K, 2, M), np.int32)
    ln = np.zeros_like(q)
    r = np.zeros_like(q)
    cnt = rng.integers(0, 40, (B, K, 2))
    for idx in np.ndindex(B, K, 2):
        pos, diag = 0, int(rng.integers(1_000, 4_000_000))
        for m in range(int(cnt[idx])):
            length = int(rng.integers(15, 25))
            if rng.random() < 0.08 and not exact:
                diag += int(rng.integers(-3, 4))
            q[idx + (m,)], ln[idx + (m,)] = pos, length
            r[idx + (m,)] = diag + pos
            if rng.random() < 0.1 and not exact:
                r[idx + (m,)] = int(rng.integers(1_000, 4_000_000))
            pos += length + int(rng.integers(0, 12))
    valid = np.arange(M) < cnt[..., None]
    return q, ln, r, valid


def _harmonize_both(q, ln, r, valid):
    jm = np.asarray(JH.harmonize_sets(jnp.asarray(q), jnp.asarray(ln), jnp.asarray(r),
                                      jnp.asarray(valid), n_cand=4))
    tm = TH.harmonize_sets(torch.as_tensor(q), torch.as_tensor(ln), torch.as_tensor(r),
                           torch.as_tensor(valid), n_cand=4).numpy()
    return jm, tm


@pytest.mark.parametrize("seed,exact", [(3, False), (4, False), (5, True)])
def test_harmonize_sets_matches(seed, exact, monkeypatch):
    monkeypatch.setenv("MA_TPU_SWEEP", "xla")
    q, ln, r, valid = _seed_sets(seed, exact=exact)
    jm, tm = _harmonize_both(q, ln, r, valid)
    assert np.array_equal(jm, tm)
    ja = np.asarray(JH.artifact_filter(jnp.asarray(q), jnp.asarray(ln), jnp.asarray(r),
                                       jnp.asarray(jm)))
    ta = TH.artifact_filter(torch.as_tensor(q), torch.as_tensor(ln), torch.as_tensor(r),
                            torch.as_tensor(tm)).numpy()
    assert np.array_equal(ja, ta)


def test_harmonize_sets_same_diagonal_overlap_divergence(monkeypatch):
    """Known divergence (ROADMAP Queue 3): when two OVERLAPPING seeds lie on
    one diagonal, the shadow sweep compares their distances to the guide
    line, which differ only by float32 rounding; XLA's float32 trigonometry
    and fused multiply-adds round differently from the port's float64
    evaluation, so the survivor mask (HarmBatch.valid) can differ there.
    Lumped seeds never overlap on one diagonal; this pins the divergence to
    sets that hold such a pair."""
    monkeypatch.setenv("MA_TPU_SWEEP", "xla")
    rng = np.random.default_rng(3)
    shape = (6, 4, 2, 64)
    q = rng.integers(0, 140, shape).astype(np.int32)
    ln = rng.integers(15, 30, shape).astype(np.int32)
    r = (rng.integers(1_000, 900_000, shape[:-1] + (1,)) + q
         + rng.integers(-3, 4, shape) * (rng.random(shape) < 0.3)).astype(np.int32)
    valid = np.arange(64) < rng.integers(0, 40, shape[:-1] + (1,))
    jm, tm = _harmonize_both(q, ln, r, valid)
    for idx in np.argwhere((jm != tm).any(-1)):
        idx = tuple(idx)
        v = np.flatnonzero(valid[idx])
        d, s, e = r[idx][v] - q[idx][v], q[idx][v], q[idx][v] + ln[idx][v]
        same = (d[:, None] == d[None, :]) & (s[:, None] < e[None, :]) & (s[None, :] < e[:, None])
        np.fill_diagonal(same, False)
        assert same.any(), f"mask differs in set {idx} without a same-diagonal overlap"



@pytest.mark.parametrize("lead,M", [((6, 5), 64), ((3,), 2048), ((1,), 8192)])
def test_linesweep_plain_matches_ma_tpu_on_unsorted_rows(lead, M, monkeypatch):
    """Kernel B's plain version (the stable sort, then the sweep) on rows in
    any order, with start, end and distance ties and invalid elements,
    against ma_tpu's _linesweep (its XLA scan) at both main-path widths and
    at the widest, a long read's overflow rescue."""
    starts, ends, dists, valid = _shadows(7, lead, M)
    got = linesweep_plain(*(torch.as_tensor(a).reshape(-1, M)
                            for a in (starts, ends, dists, valid))).numpy()
    monkeypatch.setenv("MA_TPU_SWEEP", "xla")
    seed_idx = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), starts.shape)
    want = np.asarray(JH._linesweep(jnp.asarray(starts), jnp.asarray(ends),
                                    jnp.asarray(dists), seed_idx, jnp.asarray(valid)))
    assert np.array_equal(got, want.reshape(-1, M))
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("preset", ["Default", "PacBio"])
def test_kernel_b_takes_every_sweep_width(preset):
    """The rows the aligner sweeps are seeds_per_soc wide: at every read
    length bucket, in the overflow rescue's boosted stage too (cap_boost 4),
    they fit kernel B, whose widest rows are the rescue's."""
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.ops.harmonize_cuda import MAX_M
    from ma_tpu_torch.pipeline.aligner import DeviceStageConfig

    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    widths = {DeviceStageConfig.from_params(mgr.selected, 2**e, cap_boost=cb).seeds_per_soc
              for e in range(5, 17) for cb in (1, 4)}
    assert max(widths) == MAX_M


@pytest.fixture(scope="module")
def stage():
    """The minimizer device stage of both packages on one read batch: a
    60 kbp genome with a 7-periodic tandem repeat, reads at 2%
    substitutions (half reverse complemented), reads with Ns and repeat
    reads."""
    from ma_tpu.config.parameters import ParameterSetManager as JManager
    from ma_tpu.containers.pack import Pack as JPack
    from ma_tpu.index.minimizer import MinimizerIndex as JMI
    from ma_tpu.pipeline import aligner as JA
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.minimizer import MinimizerIndex as TMI
    from ma_tpu_torch.pipeline import aligner as TA

    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 60_000).astype(np.uint8)
    genome[30_000:30_420] = np.tile(rng.integers(0, 4, 7), 60).astype(np.uint8)
    pack, jpack = Pack.empty(), JPack.empty()
    pack.append("g", genome)
    jpack.append("g", genome)
    L, B = 256, 24
    seqs = np.full((B, L), 4, np.uint8)
    lens = np.full(B, 150, np.int32)
    for i in range(B - 2):
        p = int(rng.integers(0, len(genome) - 150))
        codes = genome[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.02)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        if i == 5:
            codes[[7, 70, 140]] = 4
        seqs[i, :150] = codes
    seqs[B - 2, :150] = genome[30_100:30_250]
    seqs[B - 1, :150] = genome[30_350:30_500]
    pset, jpset = ParameterSetManager().selected, JManager().selected
    pset.set("Seeding Technique", "minimizers")
    jpset.set("Seeding Technique", "minimizers")
    jcfg = JA.DeviceStageConfig.from_params(jpset, L)
    tcfg = TA.DeviceStageConfig.from_params(pset, L)
    assert dataclass_fields(jcfg) == dataclass_fields(tcfg)
    cs = np.asarray(pack.starts, np.int32)
    Lf = pack.unpacked_size_forward_strand
    jout = JA.device_stage_mm(jcfg, JMI.build(jpack, jcfg.mm_k, jcfg.mm_w).to_device(),
                              jnp.asarray(cs), Lf, jnp.asarray(seqs), jnp.asarray(lens))
    tout = TA.device_stage_mm(tcfg, TMI.build(pack, tcfg.mm_k, tcfg.mm_w).to_device("cpu"),
                              torch.as_tensor(cs), Lf, torch.as_tensor(seqs),
                              torch.as_tensor(lens))
    return jout, tout


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def test_device_stage_soc_batch(stage):
    (_, jsoc, _, _), (_, tsoc, _, _) = stage
    for name in ("start", "end", "score", "amb", "n_socs", "overflow"):
        assert np.array_equal(np.asarray(getattr(jsoc, name)), getattr(tsoc, name).numpy()), name
    for name in jsoc.seeds._fields:
        assert np.array_equal(np.asarray(getattr(jsoc.seeds, name)),
                              getattr(tsoc.seeds, name).numpy()), name


def test_device_stage_harm_batch(stage):
    (jh, _, _, _), (th, _, _, _) = stage
    for name in jh._fields:
        a, b = np.asarray(getattr(jh, name)), getattr(th, name).numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert np.asarray(jh.set_valid).sum() >= 20


def test_device_stage_packed_sets(stage):
    """Packed meta words exactly; packed seeds over the populated prefix
    (past it ma_tpu leaves sort leftovers, the port zeros)."""
    (_, _, jd, jm), (_, _, td, tm) = stage
    jm, tm = np.asarray(jm), tm.numpy()
    assert np.array_equal(jm, tm)
    total = int((jm >> 10).sum())
    assert total > 0
    assert np.array_equal(np.asarray(jd)[:, :total], td.numpy()[:, :total])
