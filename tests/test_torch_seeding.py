"""ma_tpu_torch minimizer index + seeding + seed filters against ma_tpu
(exact equality of every integer and bool field)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.containers.pack import Pack as JPack  # noqa: E402
from ma_tpu.index import minimizer as J  # noqa: E402
from ma_tpu.ops import filters as JF  # noqa: E402
from ma_tpu.ops.extract import SeedBatch as JSeedBatch  # noqa: E402
from ma_tpu_torch.containers.nucseq import revcomp_codes  # noqa: E402
from ma_tpu_torch.containers.pack import Pack  # noqa: E402
from ma_tpu_torch.index import minimizer as T  # noqa: E402
from ma_tpu_torch.ops import filters as TF  # noqa: E402
from ma_tpu_torch.ops.extract import SeedBatch as TSeedBatch  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

K, W = 15, 10


@pytest.fixture(scope="module")
def setup():
    """Two contigs (one holding a 7-periodic tandem repeat) and reads: random
    ones at 2% substitutions (half reverse complemented), reads with Ns, a
    read from the repeat (many occurrences per minimizer) and a poly-A read
    (every k-mer ties: more selected minimizers than lanes)."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 30_000).astype(np.uint8)
    a[12_000:12_420] = np.tile(rng.integers(0, 4, 7), 60).astype(np.uint8)
    a[5_000:5_040] = 0  # a poly-A stretch: the poly-A read's lanes have hits
    b = rng.integers(0, 4, 20_000).astype(np.uint8)
    packs = JPack.empty(), Pack.empty()  # (ma_tpu's, the port's)
    for pack in packs:
        pack.append("chrA", a)
        pack.append("chrB", b)
    genome = np.concatenate([a, b])
    L = 256
    reads = []
    for i in range(14):
        p = int(rng.integers(0, len(genome) - 150))
        codes = genome[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.02)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        if i in (3, 4):
            codes[rng.integers(0, 150, 3)] = 4
        reads.append(codes)
    reads.append(genome[12_100:12_250].copy())
    reads.append(np.zeros(150, np.uint8))
    reads.append(genome[100:130].copy())  # short read
    seqs = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = r
        lens[i] = len(r)
    return packs, seqs, lens


def _assert_batches_equal(j, t, fields=None):
    for name in fields or j._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name).cpu().numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), f"field {name} differs"


def test_index_arrays_match(setup):
    jpack, pack = setup[0]
    ji = J.MinimizerIndex.build(jpack, k=K, w=W)
    ti = T.MinimizerIndex.build(pack, k=K, w=W)
    for f in ("hash_sorted", "pos", "strand"):
        assert getattr(ji, f).dtype == getattr(ti, f).dtype, f
        assert np.array_equal(getattr(ji, f), getattr(ti, f)), f
    jd = ji.to_device()
    td = ti.to_device("cpu")
    assert jd.chd_tlog == td.chd_tlog and jd.chd_mlog == td.chd_mlog
    assert np.array_equal(np.asarray(jd.chd_d), td.chd_d.numpy())
    assert np.array_equal(np.asarray(jd.chd_table), td.chd_table.numpy())


def test_index_store_load_roundtrip(setup, tmp_path):
    ti = T.MinimizerIndex.build(setup[0][1], k=K, w=W)
    prefix = str(tmp_path / "g")
    ti.store(prefix)
    assert T.MinimizerIndex.exists(prefix)
    back = T.MinimizerIndex.load(prefix)
    assert (back.k, back.w) == (K, W)
    assert np.array_equal(back.hash_sorted, ti.hash_sorted)
    assert np.array_equal(back.pos, ti.pos)


def test_sketch_matches(setup):
    _, seqs, _ = setup
    js = J._sketch_arrays(jnp.asarray(seqs, jnp.int32), K, W, jnp)
    ts = T._sketch_arrays(torch.as_tensor(seqs, dtype=torch.int32), K, W)
    for name, a, b in zip(("sel", "hash", "strand", "valid"), js, ts):
        assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64)), name


@pytest.mark.parametrize("max_seeds", [256, 32])
def test_seed_batch_matches(setup, max_seeds):
    """minimizer_seeding -> seed_lump -> min_length; max_seeds=32 makes the
    repeat reads overflow their seed slots, the poly-A read its lanes."""
    (jpack, pack), seqs, lens = setup
    cs = np.asarray(pack.starts, np.int32)
    Lf = pack.unpacked_size_forward_strand
    kw = dict(k=K, w=W, max_occ=100, max_seeds=max_seeds, rectangular=True)

    jdev = J.MinimizerIndex.build(jpack, k=K, w=W).to_device()
    js = J.minimizer_seeding(jdev, jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(cs), Lf, **kw)
    tdev = T.MinimizerIndex.build(pack, k=K, w=W).to_device("cpu")
    ts = T.minimizer_seeding(tdev, torch.as_tensor(seqs), torch.as_tensor(lens),
                             torch.as_tensor(cs), Lf, **kw)
    _assert_batches_equal(js, ts)
    assert bool(np.asarray(js.overflow).any())
    if max_seeds == 32:
        assert bool(np.asarray(js.overflow)[-3])  # the repeat read

    jl = JF.seed_lump(js)
    tl = TF.seed_lump(ts)
    _assert_batches_equal(jl, tl)
    _assert_batches_equal(JF.min_length(jl, 16), TF.min_length(tl, 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_lump_run_boundaries(seed):
    """seed_lump on seeds built to sit on few diagonals of both strands:
    seeds that touch (start == running end), overlap, nest or leave a gap,
    duplicates, and invalid slots."""
    rng = np.random.default_rng(seed)
    B, S = 8, 48
    q = np.zeros((B, S), np.int32)
    ln = rng.integers(1, 20, (B, S)).astype(np.int32)
    fw = rng.random((B, S)) < 0.5
    diag = rng.integers(1_000, 1_004, (B, S)).astype(np.int32)
    for b in range(B):
        pos = 0
        for s in range(S):
            step = int(rng.choice([0, ln[b, s - 1] if s else 0, 3, 25]))
            pos = min(pos + step, 900)
            q[b, s] = pos
    ref = np.where(fw, diag + q, diag - q).astype(np.int32)
    valid = rng.random((B, S)) < 0.9
    fields = (q, ln, ref, fw, rng.integers(1, 5, (B, S)).astype(np.int32),
              np.zeros((B, S), np.int32), np.zeros((B, S), np.int32), valid,
              valid.sum(1).astype(np.int32), np.zeros(B, bool))
    jl = JF.seed_lump(JSeedBatch(*(jnp.asarray(a) for a in fields)))
    tl = TF.seed_lump(TSeedBatch(*(torch.as_tensor(a) for a in fields)))
    _assert_batches_equal(jl, tl)
    assert (np.asarray(jl.n_seeds) < valid.sum(1)).all()  # runs were merged
