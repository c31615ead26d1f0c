"""The port's multi-device package (ma_tpu_torch/parallel/) against
ma_tpu/parallel/ on the CPU.

One module fixture starts two ranks of `python -m ma_tpu_torch.parallel.worker`
(gloo, `file://` rendezvous, every rank under a timeout) that run every mode
once over the files it writes; ma_tpu's side runs in this process on the
2-device mesh `jax.devices()[:2]` (tests/conftest.py gives 8 virtual CPU
devices) while the ranks run. The sharded seeds equal ma_tpu's field for
field, slot for slot, two reference faults included (ROADMAP Queue 3); the
row-sharded FMD lookups and seeding equal the single-device ones; both
ranks run the same collectives; the two ranks' SAM, merged, equals the
single-process port's byte for byte and ma_tpu's record for record.
"""
import concurrent.futures
import io
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("q_start", "length", "ref_start", "on_forward", "ambiguity", "delta", "soc_nt",
          "valid", "n_seeds", "overflow")
TECHNIQUES = ("SMEMs", "maxSpan")

# the duplicate-seed fault: the 5,581 entries of this genome's index (k 15,
# w 10) split into two shards of 2,791, the second padded with its last
# entry (position 9,405); a read over it gets seed (86, 9391, 15) twice
FAULT_SEED, FAULT_G, FAULT_READ = 123, 30_002, (9305, 9505)
# the straddling hash: a 40 bp segment planted 60 times; one of its
# minimizers' 60 occurrences splits 49 / 11 over the two shards, so each
# shard passes max_occ 50 and the whole index drops it
STRADDLE_SEED, STRADDLE_G, STRADDLE_COPIES = 1, 20_000, 60


def _fault_genome():
    return np.random.default_rng(FAULT_SEED).integers(0, 4, FAULT_G).astype(np.uint8)


def _straddle_genome():
    rng = np.random.default_rng(STRADDLE_SEED)
    g = rng.integers(0, 4, STRADDLE_G).astype(np.uint8)
    seg = rng.integers(0, 4, 40).astype(np.uint8)
    for i in range(STRADDLE_COPIES):
        g[150 + 320 * i: 190 + 320 * i] = seg
    return g


def _fmd_genome():
    return np.random.default_rng(42).integers(0, 4, 20_000).astype(np.uint8)


def _pack(pkg, contigs):
    import importlib

    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    pack = Pack.empty()
    for name, codes in contigs:
        pack.append(name, codes)
    return pack


def _mm_batch():
    """The fault read first, then five random 200 bp reads (odd ones
    reverse complemented), in a [6, 256] batch."""
    from ma_tpu_torch.containers.nucseq import revcomp_codes

    g = _fault_genome()
    rng = np.random.default_rng(5)
    seqs = np.full((6, 256), 4, np.int32)
    starts = [FAULT_READ[0]] + [int(rng.integers(0, FAULT_G - 200)) for _ in range(5)]
    for b, p in enumerate(starts):
        r = g[p: p + 200]
        seqs[b, :200] = revcomp_codes(r) if b % 2 else r
    return seqs, np.full(6, 200, np.int32)


def _straddle_batch():
    seqs = np.full((1, 256), 4, np.int32)
    seqs[0, :200] = _straddle_genome()[100:300]  # over the first planted copy
    return seqs, np.full(1, 200, np.int32)


def _fmd_batch():
    from ma_tpu_torch.containers.nucseq import revcomp_codes

    g = _fmd_genome()
    rng = np.random.default_rng(7)
    seqs = np.full((16, 120), 4, np.int32)
    for i in range(16):
        p = int(rng.integers(0, len(g) - 120))
        seqs[i] = revcomp_codes(g[p: p + 120]) if i % 2 else g[p: p + 120]
    return seqs, np.full(16, 120, np.int32)


def _align_reads(rng, genome, shard):
    from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes

    reads = []
    for i in range(24):
        p = int(rng.integers(0, len(genome) - 150))
        codes = genome[p: p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.02)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"s{shard}_r{i}", qual="I" * 150))
    return reads


def _write_inputs(d):
    """Index files, read batches and FASTQ files of every worker mode."""
    from ma_tpu_torch.containers.nucseq import decode_seq
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.index.minimizer import MinimizerIndex

    g = _pack("ma_tpu_torch", [("chrF", _fault_genome())])
    g.store(f"{d}/g")
    MinimizerIndex.build(g).store(f"{d}/g")
    MinimizerIndex.build(_pack("ma_tpu_torch", [("chrS", _straddle_genome())])).store(f"{d}/s")
    fg = _fmd_genome()
    f = _pack("ma_tpu_torch", [("c0", fg[:12_000]), ("c1", fg[12_000:])])
    fmd = FMDIndex.build(f)
    fmd.store(f"{d}/f")

    mm = dict(k=15, w=10, max_occ=50, max_seeds_per_shard=256)
    for name, index, (seqs, lens), pack in (("main", "g", _mm_batch(), g),
                                            ("straddle", "s", _straddle_batch(), None)):
        pack = pack or _pack("ma_tpu_torch", [("chrS", _straddle_genome())])
        np.savez(f"{d}/seed-mm-{name}.npz", index=index, seqs=seqs, lens=lens,
                 contig_starts=np.asarray(pack.starts, np.int32),
                 ref_len_forward=pack.unpacked_size_forward_strand, **mm)
    seqs, lens = _fmd_batch()
    rng = np.random.default_rng(11)
    occ_k = np.concatenate([[-1, 0, 1], rng.integers(0, fmd.n, 61)]).astype(np.int32)
    np.savez(f"{d}/seed-fmd-main.npz", index="f", seqs=seqs, lens=lens,
             contig_starts=np.asarray(f.starts, np.int32), techniques=np.array(TECHNIQUES),
             occ_k=occ_k, sa_rows=np.abs(occ_k))

    rng = np.random.default_rng(21)
    for shard in range(2):
        with open(f"{d}/reads{shard}.fq", "w") as fq:
            for r in _align_reads(rng, _fault_genome(), shard):
                fq.write(f"@{r.name}\n{decode_seq(r.codes)}\n+\n{r.qual}\n")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(workdir, a future of the two ranks' results): the ranks run while
    the tests compute ma_tpu's side."""
    from ma_tpu_torch.parallel.worker import run_ranks

    d = str(tmp_path_factory.mktemp("ranks"))
    _write_inputs(d)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, 2, d, "psum,seed-mm,seed-fmd,align", devices=["cpu", "cpu"],
                      backend="gloo", timeout=60.0, wall_timeout=300.0,
                      extra=("--batch-size", "24"), env=env)
    yield d, fut
    pool.shutdown(wait=True)


def _results(run):
    d, fut = run
    return d, fut.result()


def _out(d, case):
    return np.load(f"{d}/{case}.out.npz")


def _mesh():
    import jax
    from jax.sharding import Mesh
    from ma_tpu.parallel.sharded_index import SHARD_AXIS

    return Mesh(np.array(jax.devices()[:2]), (SHARD_AXIS,))


def _assert_fields(got, want, prefix=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[prefix + f]), np.asarray(want[f]),
                                      err_msg=prefix + f)


def _asdict(sb):
    return {f: np.asarray(getattr(sb, f)) for f in FIELDS}


def _ma_tpu_sharded_mm(contigs, seqs, lens):
    from ma_tpu.index.minimizer import MinimizerIndex
    from ma_tpu.parallel.sharded_index import shard_minimizer_index, sharded_minimizer_seeding

    pack = _pack("ma_tpu", contigs)
    shards = shard_minimizer_index(MinimizerIndex.build(pack), 2)
    return _asdict(sharded_minimizer_seeding(
        _mesh(), shards, seqs, lens, pack.starts.astype(np.int32),
        pack.unpacked_size_forward_strand))


def _unsharded_n_seeds(pkg, contigs, seqs, lens):
    """n_seeds of each package's single-device minimizer_seeding at 512
    slots (the sharded batch's width)."""
    if pkg == "ma_tpu":
        import jax.numpy as jnp
        from ma_tpu.index.minimizer import MinimizerIndex, minimizer_seeding

        pack = _pack(pkg, contigs)
        sb = minimizer_seeding(MinimizerIndex.build(pack).to_device(), jnp.asarray(seqs),
                               jnp.asarray(lens), jnp.asarray(pack.starts.astype(np.int32)),
                               pack.unpacked_size_forward_strand, max_seeds=512)
        return np.asarray(sb.n_seeds)
    from ma_tpu_torch.index.minimizer import MinimizerIndex, minimizer_seeding

    pack = _pack(pkg, contigs)
    sb = minimizer_seeding(MinimizerIndex.build(pack).to_device("cpu"), torch.as_tensor(seqs),
                           torch.as_tensor(lens), torch.as_tensor(pack.starts.astype(np.int32)),
                           pack.unpacked_size_forward_strand, max_seeds=512)
    return sb.n_seeds.numpy()


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_minimizer_index_as_ma_tpu(n_shards):
    from ma_tpu.index.minimizer import MinimizerIndex as RefIndex
    from ma_tpu.parallel.sharded_index import shard_minimizer_index as ref_shard
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.parallel.sharded_index import shard_minimizer_index

    contigs = [("chrF", _fault_genome())]
    got = shard_minimizer_index(MinimizerIndex.build(_pack("ma_tpu_torch", contigs)), n_shards)
    H, Pp, S = ref_shard(RefIndex.build(_pack("ma_tpu", contigs)), n_shards)[:3]
    for a, b in ((got.hash, H), (got.pos, Pp), (got.strand, S)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_fmd_index_as_ma_tpu(n_shards):
    from ma_tpu.index.fmd_index import FMDIndex as RefFMD
    from ma_tpu.parallel.sharded_fmd import shard_fmd_index as ref_shard
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.parallel.sharded_fmd import shard_fmd_index

    g = _fmd_genome()
    contigs = [("c0", g[:12_000]), ("c1", g[12_000:])]
    got = shard_fmd_index(FMDIndex.build(_pack("ma_tpu_torch", contigs)), n_shards)
    want = ref_shard(RefFMD.build(_pack("ma_tpu", contigs)), n_shards)
    for a, b in zip(got[:5], want[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[5].keys() == want[5].keys()
    for k in want[5]:
        np.testing.assert_array_equal(got[5][k], want[5][k])


@pytest.fixture(scope="module")
def ref_mm_main():
    """ma_tpu's sharded seeds of the main minimizer batch."""
    return _ma_tpu_sharded_mm([("chrF", _fault_genome())], *_mm_batch())


def test_sharded_minimizer_seeding_as_ma_tpu(run, ref_mm_main):
    want = ref_mm_main
    d, _ = _results(run)
    got = _out(d, "seed-mm-main")
    assert got["q_start"].shape == (6, 512)
    _assert_fields(got, want)
    assert got["valid"].sum() > 6 * 20


def test_sharded_mm_pad_duplicates_last_hash_as_ma_tpu(run, ref_mm_main):
    """A reference fault the port copies: the read over the index's largest
    hash gets its seed once more from the last shard's pad, 40 seeds in
    both packages against the unsharded 39."""
    contigs = [("chrF", _fault_genome())]
    seqs, lens = _mm_batch()
    ref = ref_mm_main
    d, _ = _results(run)
    got = _out(d, "seed-mm-main")
    for sb in (got, ref):
        assert int(sb["n_seeds"][0]) == 40
        v = sb["valid"][0]
        seeds = list(zip(sb["q_start"][0][v], sb["ref_start"][0][v], sb["length"][0][v]))
        assert seeds.count((86, 9391, 15)) == 2
        assert len(set(seeds)) == 39
    for pkg in ("ma_tpu", "ma_tpu_torch"):
        assert int(_unsharded_n_seeds(pkg, contigs, seqs, lens)[0]) == 39


def test_sharded_mm_straddling_hash_passes_max_occ_as_ma_tpu(run):
    """The second reference fault: shards split by count, so a hash whose 60
    occurrences straddle the two shards (49 / 11) passes max_occ 50 in each,
    while the unsharded lookup drops it: 60 more seeds in both packages."""
    contigs = [("chrS", _straddle_genome())]
    seqs, lens = _straddle_batch()
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.parallel.sharded_index import shard_minimizer_index

    H = shard_minimizer_index(MinimizerIndex.build(_pack("ma_tpu_torch", contigs)), 2).hash
    assert H[0, -1] == H[1, 0]
    assert ((H[0] == H[0, -1]).sum(), (H[1] == H[0, -1]).sum()) == (49, 11)
    want = _ma_tpu_sharded_mm(contigs, seqs, lens)
    d, _ = _results(run)
    got = _out(d, "seed-mm-straddle")
    _assert_fields(got, want)
    for pkg in ("ma_tpu", "ma_tpu_torch"):
        assert int(got["n_seeds"][0]) == int(_unsharded_n_seeds(pkg, contigs, seqs, lens)[0]) + 60


def test_sharded_fmd_lookups_equal_single_device(run):
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.ops.occ import FMDDev, occ4, sa_lookup

    d, _ = _results(run)
    z = np.load(f"{d}/seed-fmd-main.npz")
    dev = FMDDev.from_host(FMDIndex.load(f"{d}/f"), "cpu")
    got = _out(d, "seed-fmd-main")
    np.testing.assert_array_equal(got["occ4"], occ4(dev, torch.as_tensor(z["occ_k"])).numpy())
    np.testing.assert_array_equal(got["sa"], sa_lookup(dev, torch.as_tensor(z["sa_rows"])).numpy())


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_sharded_fmd_seeding_as_ma_tpu_and_single_device(run, technique):
    from ma_tpu.index.fmd_index import FMDIndex as RefFMD
    from ma_tpu.parallel.sharded_fmd import shard_fmd_index as ref_shard
    from ma_tpu.parallel.sharded_fmd import sharded_fmd_seeding as ref_seeding
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.ops.extract import extract_seeds
    from ma_tpu_torch.ops.occ import FMDDev
    from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding

    g = _fmd_genome()
    contigs = [("c0", g[:12_000]), ("c1", g[12_000:])]
    seqs, lens = _fmd_batch()
    ref_pack = _pack("ma_tpu", contigs)
    want = _asdict(ref_seeding(_mesh(), ref_shard(RefFMD.build(ref_pack), 2), seqs, lens,
                               np.asarray(ref_pack.starts, np.int32), technique=technique))
    pack = _pack("ma_tpu_torch", contigs)
    dev = FMDDev.from_host(FMDIndex.build(pack), "cpu")
    seed_fn = smem_seeding if technique == "SMEMs" else max_spanning_seeding
    segs = seed_fn(dev, torch.as_tensor(seqs), torch.as_tensor(lens))
    single = _asdict(extract_seeds(dev, segs, torch.as_tensor(lens),
                                   torch.as_tensor(np.asarray(pack.starts, np.int32))))
    d, _ = _results(run)
    got = _out(d, "seed-fmd-main")
    _assert_fields(got, want, technique + ".")
    _assert_fields(got, single, technique + ".")
    assert got[technique + ".valid"].sum() >= 16


def test_ranks_run_the_same_collectives(run):
    _, res = _results(run)
    fmd = [r["results"]["seed-fmd"][0] for r in res]
    for tech in TECHNIQUES:
        counts = [f[tech]["collectives"] for f in fmd]
        assert counts[0] == counts[1] > 100, counts
        assert fmd[0][tech]["bytes_reduced"] == fmd[1][tech]["bytes_reduced"]
    assert fmd[0]["lookups"] == fmd[1]["lookups"]
    for r in res:  # one collective a sharded minimizer batch
        assert [c["collectives"] for c in r["results"]["seed-mm"]] == [1, 1]


def test_psum_over_two_ranks(run):
    _, res = _results(run)
    for r in res:
        assert (r["backend"], r["world"], r["device"]) == ("gloo", 2, "cpu")
        p = r["results"]["psum"]
        assert p["sum"] == p["want"] == 3
        assert set(p["probe"].values()) == {"ok"}, p["probe"]


@pytest.mark.parametrize("world", [1, 2])
def test_multihost_helpers_as_ma_tpu(world, tmp_path, monkeypatch):
    import jax
    from ma_tpu.parallel import multihost as ref
    from ma_tpu_torch.parallel import multihost
    from ma_tpu_torch.parallel.mesh import RankGroup

    paths = [f"r{i}.fq" for i in range(5)]
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        group = RankGroup(rank, world, "cpu", "gloo")
        assert multihost.shard_paths(paths, group) == ref.shard_paths(paths)
        assert (multihost.output_path_for_process("d/out.sam", group)
                == ref.output_path_for_process("d/out.sam"))
    if world == 1:  # no process group: one process, as jax reports it
        assert multihost.shard_paths(paths) == paths
        assert multihost.output_path_for_process("out.sam") == "out.sam"
    parts = []
    for r in range(world):
        p = tmp_path / f"out.part{r:04d}.sam"
        p.write_text("@HD\tVN:1.6\n@SQ\tSN:c\tLN:9\n" + "".join(f"r{r}_{i}\t0\n" for i in range(3)))
        parts.append(str(p))
    n = multihost.merge_sam_shards(parts[::-1], str(tmp_path / "port.sam"))
    assert n == ref.merge_sam_shards(parts[::-1], str(tmp_path / "ref.sam")) == 3 * world
    assert (tmp_path / "port.sam").read_bytes() == (tmp_path / "ref.sam").read_bytes()


@pytest.mark.parametrize("world", [2, 3])
def test_pad_batch_and_local_rows_as_ma_tpu(world):
    import jax
    from ma_tpu.parallel.mesh import make_mesh, pad_batch_to_mesh
    from ma_tpu_torch.parallel.mesh import RankGroup, local_rows, pad_batch_to_group

    seqs = np.random.default_rng(3).integers(0, 4, (7, 10)).astype(np.uint8)
    lens = np.arange(7, dtype=np.int32) + 3
    want = pad_batch_to_mesh(seqs, lens, make_mesh(jax.devices(), n=world))
    got = pad_batch_to_group(seqs, lens, RankGroup(0, world, "cpu", "gloo"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rows = [local_rows(*got[:2], RankGroup(r, world, "cpu", "gloo")) for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([s for s, _ in rows]), got[0])
    np.testing.assert_array_equal(np.concatenate([n for _, n in rows]), got[1])


def test_two_rank_align_merges_to_single_process_sam(run, monkeypatch):
    import jax
    from ma_tpu.index.fmd_index import FMDIndex as RefFMD
    from ma_tpu.io.fasta import read_reads as ref_read_reads
    from ma_tpu.pipeline.aligner import Aligner as RefAligner
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.io.fasta import read_reads
    from ma_tpu_torch.parallel.multihost import merge_sam_shards
    from ma_tpu_torch.pipeline.aligner import Aligner

    d, res = _results(run)
    fqs = [f"{d}/reads0.fq", f"{d}/reads1.fq"]
    # ma_tpu reads MA_TPU_DP while tracing, and a second run may replay a
    # stale program (ROADMAP Queue 3): fresh caches
    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    jax.clear_caches()
    ref_pack = _pack("ma_tpu", [("chrF", _fault_genome())])
    ref_al = RefAligner(ref_pack, RefFMD.build(ref_pack))
    ref_al.pset.set("Seeding Technique", "minimizers")
    ref_sam = io.StringIO()
    try:
        ref_al.align_to_sam(iter([r for p in fqs for r in ref_read_reads(p)]), ref_sam,
                            batch_size=24)
    finally:
        jax.clear_caches()

    assert [r["results"]["align"]["files"] for r in res] == [["reads0.fq"], ["reads1.fq"]]
    parts = [f"{d}/{r['results']['align']['out']}" for r in res]
    assert [os.path.basename(p) for p in parts] == ["out.part0000.sam", "out.part0001.sam"]
    n = merge_sam_shards(parts, f"{d}/merged.sam")
    al = Aligner(Pack.load(f"{d}/g"), device="cpu", index_prefix=f"{d}/g")
    al.pset.set("Seeding Technique", "minimizers")
    single = io.StringIO()
    assert al.align_to_sam(iter([r for p in fqs for r in read_reads(p)]), single,
                           batch_size=24) == 48
    merged = open(f"{d}/merged.sam").read()
    assert merged == single.getvalue()
    records = [ln for ln in merged.splitlines() if not ln.startswith("@")]
    assert len(records) == n >= 40  # nearly all 48 reads align
    assert records == [ln for ln in ref_sam.getvalue().splitlines() if not ln.startswith("@")]


def test_worker_exits_when_peer_never_starts(tmp_path):
    """Rank 0 of a world of 2 whose peer never starts: the rendezvous times
    out and the rank exits non-zero, well before the caller's limit."""
    from ma_tpu_torch.parallel.worker import worker_command

    cmd = worker_command(0, 2, f"file://{tmp_path}/rdv", "cpu", "gloo", str(tmp_path), "psum", 3)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode != 0
    assert time.monotonic() - t0 < 45
    assert "init_multihost: rank 0 of 2, backend gloo, device cpu" in res.stdout


def test_hooks_keep_single_device_outputs():
    """With the hooks given their defaults the outputs are unchanged, and
    extend_backward calls its occ4_fn once an extension."""
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.ops.extract import extract_seeds
    from ma_tpu_torch.ops.occ import (
        SAI, FMDDev, extend_backward, init_interval, occ4, sa_lookup,
    )
    from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding

    g = _fmd_genome()
    pack = _pack("ma_tpu_torch", [("c0", g[:12_000]), ("c1", g[12_000:])])
    dev = FMDDev.from_host(FMDIndex.build(pack), "cpu")
    calls = []

    def counted(f, k):
        calls.append(tuple(k.shape))
        return occ4(f, k)

    ik = init_interval(dev, torch.tensor([0, 1, 2, 3]))
    c = torch.tensor([1, 2, 3, 0])
    got = extend_backward(dev, ik, c, occ4_fn=counted)
    assert calls == [(4, 2)]
    for a, b in zip(got, extend_backward(dev, ik, c)):
        assert torch.equal(a, b)
    assert isinstance(got, SAI)

    seqs, lens = map(torch.as_tensor, _fmd_batch())
    cst = torch.as_tensor(np.asarray(pack.starts, np.int32))
    for seed_fn in (smem_seeding, max_spanning_seeding):
        calls.clear()
        plain = seed_fn(dev, seqs, lens)
        hooked = seed_fn(dev, seqs, lens, ext_ops=(
            init_interval, lambda f, i, ch: extend_backward(f, i, ch, occ4_fn=counted)))
        assert calls
        for a, b in zip(plain, hooked):
            assert torch.equal(a, b)
        e1 = extract_seeds(dev, plain, lens, cst)
        e2 = extract_seeds(dev, plain, lens, cst, sa_fn=sa_lookup)
        for a, b in zip(e1, e2):
            assert torch.equal(a, b)


def test_parallel_import_loads_no_jax():
    script = textwrap.dedent("""
        import sys
        import ma_tpu_torch.parallel
        import ma_tpu_torch.parallel.sharded_fmd, ma_tpu_torch.parallel.sharded_index
        import ma_tpu_torch.parallel.worker
        print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ma_tpu")))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout
