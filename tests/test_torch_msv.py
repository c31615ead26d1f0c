"""The port's MSV structural-variant caller (ma_tpu_torch/msv/pipeline.py)
against ma_tpu on the CPU: the non-rectangular SeedBatch and SoCBatch of the
seed stage field by field (against ma_tpu's XLA twin and its Pallas sweep in
interpret mode), SocHost's nine fields with their shapes, the native
enumeration against the port's own Python oracle, compute_sv_jumps_batch's
JumpBatch column for column (a partial last chunk included), the calls, the
viewer's seed unions and the connector-pattern filter with its DP scores.

The fixture is tests/test_sv_enum.py's 120 kbp problem (a deletion, an
inversion and an insertion, 96 reads of 1 kb) with a 1.5 kb segment
repeated 16 times in the reference and 8 more reads inside the repeat: their
minimizers hit 16 places each, so they overflow the 2,048 seed slots and
the kept seeds depend on the slot order. Each ma_tpu run clears jax's
caches first (ma_tpu reads MA_TPU_SOC while tracing; ROADMAP Queue 3)."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

G = 120_000
REPEAT_AT, REPEAT_UNIT, REPEAT_COPIES = 96_000, 1_500, 16
READ_LEN, BATCH = 1000, 64
JUMP_COLUMNS = ("from_pos", "to_pos", "query_from", "query_to", "from_forward",
                "to_forward", "num_supporting_nt", "read_id", "was_mirrored", "id")
CALL_FIELDS = ("from_pos", "to_pos", "from_size", "to_size", "from_forward",
               "to_forward", "supp_reads", "supp_nt", "reference_ambiguity",
               "supporting_jump_ids", "id", "order_id", "ctg_order_id", "mirrored")


def sv_data():
    """(reference codes, read codes): tests/test_sv_enum.py's problem, the
    same draws in the same order, plus the repeat and 8 reads inside it."""
    rng = np.random.default_rng(20260821)
    ref = rng.integers(0, 4, size=G).astype(np.uint8)
    for c in range(1, REPEAT_COPIES):
        at = REPEAT_AT + c * REPEAT_UNIT
        ref[at : at + REPEAT_UNIT] = ref[REPEAT_AT : REPEAT_AT + REPEAT_UNIT]
    donor = np.concatenate([
        ref[:30_000],
        ref[30_500:60_000],  # 500 bp deletion at 30k
        ref[60_000:60_300][::-1] ^ 3 & 3,  # 300 bp inversion at 60k
        ref[60_300:90_000],
        rng.integers(0, 4, size=400).astype(np.uint8),  # 400 bp insertion
        ref[90_000:],
    ])
    donor = np.where(donor > 3, 0, donor).astype(np.uint8)
    lo = REPEAT_AT + 400 - 500  # the donor is 100 bp shorter before the repeat
    starts = [int(rng.integers(0, len(donor) - READ_LEN)) for _ in range(96)]
    reads = []
    for p in starts:
        codes = donor[p : p + READ_LEN].copy()
        for j in np.nonzero(rng.random(READ_LEN) < 0.002)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        reads.append(codes)
    for i in range(8):
        p = lo + 1_000 + i * 2_500
        reads.append(donor[p : p + READ_LEN].copy())
    return ref, reads


def objects(pkg: str, data):
    """(Pack, MinimizerIndex, [NucSeq]) of one package from the same arrays."""
    import importlib

    ref, reads = data
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    NucSeq = importlib.import_module(pkg + ".containers.nucseq").NucSeq
    MinimizerIndex = importlib.import_module(pkg + ".index.minimizer").MinimizerIndex
    pack = Pack.empty()
    pack.append("chrR", ref)
    return pack, MinimizerIndex.build(pack, k=15, w=10), [
        NucSeq(c.copy(), name=f"sv{i}") for i, c in enumerate(reads)]


@pytest.fixture(scope="module")
def data():
    return sv_data()


@pytest.fixture(scope="module")
def port(data):
    return objects("ma_tpu_torch", data)


@pytest.fixture(scope="module")
def ref(data):
    return objects("ma_tpu", data)


@pytest.fixture
def fresh_jax(monkeypatch):
    """ma_tpu with jax's caches cleared before and after (and MA_TPU_SOC
    restored by monkeypatch)."""
    jax = pytest.importorskip("jax")
    jax.clear_caches()
    yield
    jax.clear_caches()


def chunk_arrays(reads):
    L = 32
    while L < max(len(r) for r in reads):
        L *= 2
    seqs = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = r.codes
        lens[i] = len(r)
    return seqs, lens


def port_stage(port, reads):
    from ma_tpu_torch.msv.pipeline import sv_seed_stage

    pack, mmi, _ = port
    seqs, lens = chunk_arrays(reads)
    cst = torch.as_tensor(np.asarray(pack.starts, np.int32))
    return sv_seed_stage(mmi.to_device("cpu"), cst, pack.unpacked_size_forward_strand,
                         seqs, lens, device="cpu", k=mmi.k, w=mmi.w)


def ref_stage(ref, reads):
    import jax.numpy as jnp

    from ma_tpu.msv.pipeline import sv_seed_stage

    pack, mmi, _ = ref
    seqs, lens = chunk_arrays(reads)
    return sv_seed_stage(mmi.to_device(), jnp.asarray(np.asarray(pack.starts, np.int32)),
                         pack.unpacked_size_forward_strand, seqs, lens, k=mmi.k, w=mmi.w)


def assert_batch_equal(got, want, what):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if hasattr(b, "_fields"):
            assert_batch_equal(a, b, f"{what}.{f}")
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, a.shape)
        assert np.array_equal(a, b), (what, f)


def test_seed_batch_non_rectangular_as_ma_tpu(port, ref, fresh_jax):
    """minimizer_seeding at 2,048 slots, rectangular=False, then seed_lump and
    min_length: every SeedBatch field equals ma_tpu's, on reads that overflow
    their slots (which seeds are kept follows the slot order)."""
    import jax.numpy as jnp

    from ma_tpu.index.minimizer import minimizer_seeding as ref_seeding
    from ma_tpu.ops.filters import min_length as ref_min_length, seed_lump as ref_lump
    from ma_tpu_torch.index.minimizer import minimizer_seeding
    from ma_tpu_torch.ops.filters import min_length, seed_lump

    reads = port[2][-BATCH:]
    seqs, lens = chunk_arrays(reads)
    kw = dict(k=15, w=10, max_occ=10000, max_seeds=2048, rectangular=False)
    p_pack, p_mmi, _ = port
    r_pack, r_mmi, _ = ref
    got = minimizer_seeding(p_mmi.to_device("cpu"), torch.as_tensor(seqs),
                            torch.as_tensor(lens),
                            torch.as_tensor(np.asarray(p_pack.starts, np.int32)), G, **kw)
    want = ref_seeding(r_mmi.to_device(), jnp.asarray(seqs), jnp.asarray(lens),
                       jnp.asarray(np.asarray(r_pack.starts, np.int32)), G, **kw)
    assert int(np.asarray(want.overflow).sum()) >= 4, "no read overflows its 2,048 slots"
    assert int(np.asarray(want.n_seeds).max()) == 2048
    assert (~np.asarray(want.on_forward)[np.asarray(want.valid)]).any()
    assert_batch_equal(got, want, "minimizer_seeding")
    got, want = seed_lump(got), ref_lump(want)
    assert_batch_equal(got, want, "seed_lump")
    assert_batch_equal(min_length(got, 18), ref_min_length(want, 18), "min_length")


@pytest.mark.parametrize("soc_form", ["xla", "pallas"])
def test_soc_batch_non_rectangular_as_ma_tpu(port, ref, fresh_jax, monkeypatch, soc_form):
    """sv_seed_stage (B = 64, S = 2,048, K = 64, non-rectangular SoCs): the
    SoCBatch and its sorted seeds equal ma_tpu's under its XLA while_loop
    sweep and under its Pallas sweep in interpret mode."""
    if soc_form == "pallas":
        monkeypatch.setenv("MA_TPU_SOC", "pallas")
    else:
        monkeypatch.delenv("MA_TPU_SOC", raising=False)
    reads = port[2][-BATCH:]
    got, want = port_stage(port, reads), ref_stage(ref, reads)
    assert int(np.asarray(want.n_socs).sum()) > BATCH
    assert np.asarray(want.overflow).any()
    assert tuple(got.start.shape) == (BATCH, 64) and tuple(got.seeds.valid.shape) == (BATCH, 2048)
    assert_batch_equal(got, want, "soc")


@pytest.mark.parametrize("min_nt", [25, 150, None], ids=["packed25", "packed150", "dense"])
def test_soc_host_as_ma_tpu(port, ref, fresh_jax, min_nt):
    """SocHost field for field, shapes and dtypes included: the packed CSR
    download (mx = max cnt, kx = max wcnt, 16-bit window bounds) and the
    dense branch (the populated pow2 prefix)."""
    from ma_tpu.msv.pipeline import SocHost as RefSocHost
    from ma_tpu_torch.msv.pipeline import SocHost

    reads = port[2][-BATCH:]
    got = SocHost(port_stage(port, reads), min_nt=min_nt)
    want = RefSocHost(ref_stage(ref, reads), min_nt=min_nt)
    assert int(want.n_socs.sum()) > 0
    for f in RefSocHost.__slots__:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, a.shape, b.dtype, b.shape)
        assert np.array_equal(a, b), f


def test_native_enumeration_matches_python_oracle(port):
    """The port's native front end against its own Python oracle
    (feasible_socs -> reseed_gaps -> extend_seeds -> sorted union) read by
    read, and the whole JumpBatch under MA_TPU_SV_ENUM=python."""
    from ma_tpu_torch.msv.pipeline import SocHost, compute_sv_jumps_batch, feasible_socs
    from ma_tpu_torch.native import sv_enum
    from ma_tpu_torch.ops.extend_host import extend_seeds
    from ma_tpu_torch.ops.hash_seeding import reseed_gaps

    pack, mmi, reads = port
    chunk = reads[:32]
    seqs, lens = chunk_arrays(chunk)
    soc = SocHost(port_stage(port, chunk))
    oq, ol, orr, ofw, ont, cnt = sv_enum.enumerate_batch(soc, seqs, lens, pack, min_nt=25,
                                                         soc_height=0, do_reseed=True)
    off = n_nonempty = 0
    for b in range(len(chunk)):
        union = []
        for piece in feasible_socs(soc, b, 25, 0):
            union.extend(extend_seeds(reseed_gaps(piece, chunk[b].codes, pack),
                                      chunk[b].codes, pack))
        union = sorted(set(union))
        c = int(cnt[b])
        got = [(int(oq[off + i]), int(ol[off + i]), int(orr[off + i]), bool(ofw[off + i]),
                int(ont[off + i])) for i in range(c)]
        assert got == union, f"read {b}"
        off += c
        n_nonempty += c > 0
    assert n_nonempty >= 16

    native = compute_sv_jumps_batch(reads, pack, mmi, batch=BATCH, device="cpu")
    os.environ["MA_TPU_SV_ENUM"] = "python"
    try:
        python = compute_sv_jumps_batch(reads, pack, mmi, batch=BATCH, device="cpu")
    finally:
        del os.environ["MA_TPU_SV_ENUM"]
    for col in JUMP_COLUMNS:
        assert np.array_equal(getattr(native, col), getattr(python, col)), col


@pytest.fixture(scope="module")
def jumps(port, ref):
    """(port JumpBatch, ma_tpu JumpBatch) over every read in chunks of 64
    (the last one partial: 104 reads)."""
    import jax

    from ma_tpu.msv.pipeline import compute_sv_jumps_batch as ref_jumps
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch

    jax.clear_caches()
    want = ref_jumps(ref[2], ref[0], ref[1], batch=BATCH)
    jax.clear_caches()
    return compute_sv_jumps_batch(port[2], port[0], port[1], batch=BATCH, device="cpu"), want


def test_jump_batch_as_ma_tpu(port, jumps):
    """compute_sv_jumps_batch's JumpBatch column for column, with a partial
    last chunk; the port runs that chunk at its own size (ma_tpu pads it),
    and one chunk of every read gives the same batch."""
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch

    got, want = jumps
    assert len(port[2]) % BATCH and len(want) > 100
    for col in JUMP_COLUMNS:
        a, b = np.asarray(getattr(got, col)), np.asarray(getattr(want, col))
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    one = compute_sv_jumps_batch(port[2], port[0], port[1], batch=len(port[2]), device="cpu")
    for col in JUMP_COLUMNS:
        assert np.array_equal(getattr(one, col), getattr(got, col)), col
    rows = lambda jb: [tuple(getattr(j, c) for c in JUMP_COLUMNS) for j in jb.to_jumps()]  # noqa: E731
    assert rows(got) == rows(want)


def call_rows(calls):
    return [tuple(getattr(c, f) for f in CALL_FIELDS)
            + (None if c.inserted_sequence is None else list(c.inserted_sequence),)
            for c in calls]


@pytest.mark.parametrize("min_reads", [1, 2])
def test_calls_as_ma_tpu(jumps, min_reads):
    """sweep_sv_jumps over each package's JumpBatch gives the same calls."""
    from ma_tpu.msv.pipeline import sweep_sv_jumps as ref_sweep
    from ma_tpu_torch.msv.pipeline import sweep_sv_jumps

    got, want = jumps
    calls = sweep_sv_jumps(got, min_reads=min_reads)
    assert calls and call_rows(calls) == call_rows(ref_sweep(want, min_reads=min_reads))


def test_seeds_for_reads_as_ma_tpu(port, ref, fresh_jax):
    from ma_tpu.msv.pipeline import seeds_for_reads as ref_seeds
    from ma_tpu_torch.msv.pipeline import seeds_for_reads

    ids = [0, 3, 50, 97, 101, 500]
    got = seeds_for_reads(port[2], port[0], port[1], ids, device="cpu")
    want = ref_seeds(ref[2], ref[0], ref[1], ids)
    assert len(got) >= 4 and got == want


def test_connector_filter_as_ma_tpu(port, ref, jumps, fresh_jax, monkeypatch):
    """connector_pattern_filter on the single-read calls: the same kept
    calls, and the DP scores (kernel D's plain version here; ma_tpu's
    banded_align, the XLA scan) equal problem for problem. Calls whose
    breakend windows reach past the forward strand (here: to the contig's
    last bases) make both packages raise the same ValueError (a reference
    fault, ROADMAP Queue 3); the rest are compared."""
    import ma_tpu.msv.connector as ref_conn
    import ma_tpu_torch.msv.connector as conn
    from ma_tpu.msv.pipeline import sweep_sv_jumps as ref_sweep
    from ma_tpu_torch.msv.pipeline import sweep_sv_jumps

    got_j, want_j = jumps
    calls, ref_calls = sweep_sv_jumps(got_j, min_reads=1), ref_sweep(want_j, min_reads=1)
    jl, wl = got_j.to_jumps(), want_j.to_jumps()
    L = port[0].unpacked_size_forward_strand
    border = [i for i, c in enumerate(calls)
              if any(p < L < p + 100 for p in (c.from_pos + max(c.from_size, 1),
                                                c.to_pos + max(c.to_size, 1)))]
    assert border
    for i in border[:2]:
        with pytest.raises(ValueError, match="strand border") as port_err:
            conn.connector_pattern_filter([calls[i]], jl, port[2], port[0], device="cpu")
        with pytest.raises(ValueError) as ref_err:
            ref_conn.connector_pattern_filter([ref_calls[i]], wl, ref[2], ref[0])
        assert str(port_err.value) == str(ref_err.value)

    seen = {}

    def spy(mod, key):
        orig = mod.banded_align

        def run(*a, **kw):
            res = orig(*a, **kw)
            seen[key] = (np.asarray(res.score.cpu() if key == "port" else res.score),
                         tuple(a[0].shape), tuple(a[1].shape))
            return res

        monkeypatch.setattr(mod, "banded_align", run)

    spy(conn, "port")
    spy(ref_conn, "ref")
    inner = [i for i in range(len(calls)) if i not in set(border)][::8]
    calls = [calls[i] for i in inner]
    kept = conn.connector_pattern_filter(calls, jl, port[2], port[0], device="cpu")
    want = ref_conn.connector_pattern_filter([ref_calls[i] for i in inner], wl, ref[2], ref[0])
    assert 0 < len(kept) < len(calls)
    assert call_rows(kept) == call_rows(want)
    assert seen["port"][1:] == seen["ref"][1:] and seen["port"][1][1] <= 100
    assert seen["port"][0].shape[0] == 2 * len(calls) + 2 * sum(
        len(c.supporting_jump_ids) for c in calls)
    assert np.array_equal(seen["port"][0], seen["ref"][0])
    assert (seen["port"][0] > 0).any()


def test_native_enumeration_raises_if_unbuilt(port, monkeypatch):
    """The native front end raises when it cannot be built: there is no
    quiet hand-over to the Python path."""
    import subprocess

    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch
    from ma_tpu_torch.native import sv_enum

    def fail(source):
        raise subprocess.CalledProcessError(1, ["g++", source])

    monkeypatch.setattr(sv_enum, "_lib", None)
    monkeypatch.setattr(sv_enum, "shared_library", fail)
    monkeypatch.delenv("MA_TPU_SV_ENUM", raising=False)
    pack, mmi, reads = port
    with pytest.raises(subprocess.CalledProcessError):
        compute_sv_jumps_batch(reads[:8], pack, mmi, device="cpu")
