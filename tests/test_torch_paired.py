"""Paired reads through the port on the CPU: pick_paired chooses as ma_tpu's
does on the same alignments, and PairedAligner over the port's
Aligner(device="cpu") writes SAM byte-identical to ma_tpu's PairedAligner
under its reference setting (MA_TPU_DP=fused MA_TPU_FINISH=native), under
the Illumina Paired preset (SMEMs) and under Default with "Use Paired
Reads" (maxSpan), the mates reverse-complemented or not."""
import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

PHRED = np.frombuffer(b"#+5?I", np.uint8)


def paired_data(seed: int = 313, genome_len: int = 16_000, n_pairs: int = 64,
                read_len: int = 150):
    """An FR library over a random genome, as numpy: insert 400 +- 30, 1%
    substitutions, random qualities. Returns (genome, [(codes1, codes2,
    qual1, qual2, start, insert)])."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    comp = np.array([3, 2, 1, 0], np.uint8)

    def mutate(codes):
        codes = codes.copy()
        for j in np.nonzero(rng.random(len(codes)) < 0.01)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        return codes

    pairs = []
    for _ in range(n_pairs):
        ins = int(np.clip(rng.normal(400, 30), 300, 500))
        p = int(rng.integers(0, genome_len - ins))
        c1 = mutate(genome[p : p + read_len])
        c2 = comp[mutate(genome[p + ins - read_len : p + ins])[::-1]]
        q1, q2 = (PHRED[rng.integers(0, len(PHRED), read_len)].tobytes().decode()
                  for _ in range(2))
        pairs.append((c1, c2, q1, q2, p, ins))
    return genome, pairs


def paired_objects(pkg: str, data):
    """The pack and the (mate 1, mate 2) NucSeq pairs of package `pkg`."""
    NucSeq = importlib.import_module(pkg + ".containers.nucseq").NucSeq
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    genome, pairs = data
    pack = Pack.empty()
    pack.append("chrP", genome)
    return pack, [(NucSeq(c1, name=f"p{i}", qual=q1), NucSeq(c2, name=f"p{i}", qual=q2))
                  for i, (c1, c2, q1, q2, _p, _ins) in enumerate(pairs)]


def write_paired_files(d, data):
    """genome.fa, r1.fq and r2.fq of `data` under directory `d`."""
    from ma_tpu_torch.containers.nucseq import decode_seq

    genome, pairs = data
    seq = decode_seq(genome)
    (d / "genome.fa").write_text(">chrP test genome\n" + "\n".join(
        seq[i : i + 70] for i in range(0, len(seq), 70)) + "\n")
    for m in (0, 1):
        (d / f"r{m + 1}.fq").write_text("".join(
            f"@p{i}\n{decode_seq(pr[m])}\n+\n{pr[2 + m]}\n" for i, pr in enumerate(pairs)))


# case -> (preset, parameters set on top of it)
CASES = {
    "illumina_paired": ("IlluminaPaired", {}),
    "default_paired": ("Default", {"Use Paired Reads": True}),
    "default_paired_no_mate_pair": ("Default", {"Use Paired Reads": True,
                                                "Paired Mate - Mate Pair": False}),
}


def params(case: str, pkg: str = "ma_tpu_torch"):
    mgr = importlib.import_module(pkg + ".config.parameters").ParameterSetManager()
    preset, extra = CASES[case]
    mgr.set_selected(preset)
    for name, value in extra.items():
        mgr.selected.set(name, value)
    assert mgr.selected.get("Use Paired Reads")
    return mgr


def _sam(pkg: str, case: str, data) -> str:
    fmd_mod = importlib.import_module(pkg + ".index.fmd_index")
    Aligner = importlib.import_module(pkg + ".pipeline.aligner").Aligner
    PairedAligner = importlib.import_module(pkg + ".pipeline.paired").PairedAligner
    pack, pairs = paired_objects(pkg, data)
    fmd = fmd_mod.FMDIndex.build(pack)
    if pkg == "ma_tpu":
        al = Aligner(pack, fmd, params(case, pkg))
    else:
        al = Aligner(pack, params(case, pkg), device="cpu", fmd=fmd)
    out = io.StringIO()
    assert PairedAligner(al).align_to_sam(iter(pairs), out, batch_size=32,
                                          cmd="ma_tpu") == 2 * len(pairs)
    return out.getvalue()


@contextlib.contextmanager
def ma_tpu_reference():
    """ma_tpu under its reference setting, MA_TPU_DP=fused
    MA_TPU_FINISH=native; yields a function to call before each ma_tpu run,
    which clears jax's caches (ma_tpu reads MA_TPU_DP while tracing, and a
    second run may replay a stale program: ROADMAP Queue 3). The caches are
    cleared and the variables restored on the way out."""
    jax = pytest.importorskip("jax")
    env = {"MA_TPU_DP": "fused", "MA_TPU_FINISH": "native"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield jax.clear_caches
    finally:
        jax.clear_caches()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def data():
    return paired_data()


@pytest.fixture(scope="module")
def port_sams(data):
    return {case: _sam("ma_tpu_torch", case, data) for case in CASES}


@pytest.fixture(scope="module")
def ma_tpu_sams(data):
    """ma_tpu's paired SAM per case, under its reference setting."""
    sams = {}
    with ma_tpu_reference() as fresh:
        for case in CASES:
            fresh()
            sams[case] = _sam("ma_tpu", case, data)
    return sams


@pytest.mark.parametrize("case", list(CASES))
def test_paired_sam_identical_to_ma_tpu(port_sams, ma_tpu_sams, case):
    sam = port_sams[case]
    assert sam.count("\n") >= 3 + 128
    assert sam == ma_tpu_sams[case]


def _records(sam: str):
    return [line.split("\t") for line in sam.splitlines() if not line.startswith("@")]


def test_paired_records_place_the_library(port_sams, data):
    """Under the default mate orientation both mates of every pair are
    primary, within 10 bp of the simulated start, flagged as properly
    paired first / last mates, with opposite TLENs equal to the insert."""
    _genome, pairs = data
    truth = {f"p{i}": (p, ins) for i, (_c1, _c2, _q1, _q2, p, ins) in enumerate(pairs)}
    for case in ("illumina_paired", "default_paired"):
        recs = [r for r in _records(port_sams[case]) if not int(r[1]) & 0x900]
        by_name: dict = {}
        for r in recs:
            by_name.setdefault(r[0], []).append(r)
        assert sorted(by_name) == sorted(truth)
        for name, (p, ins) in truth.items():
            r1, r2 = sorted(by_name[name], key=lambda r: int(r[1]) & 0x80)
            f1, f2 = int(r1[1]), int(r2[1])
            assert f1 & 0x43 == 0x43 and f2 & 0x83 == 0x83, (name, f1, f2)
            assert abs(int(r1[3]) - 1 - p) <= 10, (case, name)
            assert abs(int(r2[3]) - 1 - (p + ins - 150)) <= 10, (case, name)
            # "Paired Mate - Mate Pair" reverse-complements mate 2 before
            # alignment: both mates map to the forward strand
            assert not f1 & 0x30 and not f2 & 0x30
            assert r1[6] == r2[6] == "="
            assert int(r1[8]) == -int(r2[8]) and abs(abs(int(r1[8])) - ins) <= 20


def _alignments(pkg: str, pack, rng_seed: int, n: int):
    """`n` random alignments of package `pkg` on `pack` from one seed: a
    start on either strand near the middle, a few seeded runs."""
    A = importlib.import_module(pkg + ".containers.alignment")
    rng = np.random.default_rng(rng_seed)
    L = pack.unpacked_size_forward_strand
    out = []
    for _ in range(n):
        start = int(rng.integers(L // 2 - 400, L // 2 + 400))
        if rng.random() < 0.5:
            start = 2 * L - start - 150  # the reverse strand
        a = A.Alignment(start, 0)
        for _ in range(int(rng.integers(1, 4))):
            a.append(A.MATCH, int(rng.integers(10, 60)))
            if rng.random() < 0.5:
                a.append(A.MISMATCH, 1)
        a.stats.num_seeds = int(rng.integers(0, 3))
        a.mapping_quality = float(rng.random())
        a.secondary = bool(rng.random() < 0.3)
        out.append(a)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_pick_paired_matches_ma_tpu(data, seed):
    """pick_paired on the same alignments (0-4 per mate, built from one
    seed in each package) picks the same pair with the same flags, MAPQ and
    cross links."""
    from ma_tpu.pipeline.paired import pick_paired as pick_ref
    from ma_tpu_torch.pipeline.paired import pick_paired

    def run(pkg, pick):
        pack, _pairs = paired_objects(pkg, data)
        n1, n2 = seed % 5, (seed * 3 + 1) % 5
        a1 = _alignments(pkg, pack, seed, n1)
        a2 = _alignments(pkg, pack, seed + 100, n2)
        got = pick(a1, a2, pack, 150, 150, mean=400.0, std=30.0, score_factor=1.25)
        return [(a.begin_on_ref, a.end_on_ref, a.score(), a.stats.first, a.secondary,
                 a.supplementary, repr(a.mapping_quality),
                 None if a.stats.other is None else a.stats.other.begin_on_ref)
                for a in got]

    assert run("ma_tpu_torch", pick_paired) == run("ma_tpu", pick_ref)
