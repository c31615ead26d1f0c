"""The port's copies of ma_tpu's MSV host modules against ma_tpu on the same
inputs: hash seeding and rectangle reseeding (ops/hash_seeding.py), maximal
extension (ops/extend_host.py), the per-object jumps (msv/jumps.py), the
vectorized jumps (msv/jumps_batch.py, over tests/test_msv_batch.py's random
cases), the sweep and its call filters, call ambiguity, inserted sequences,
the TSV and both HTML files byte for byte, the npz store, genome
reconstruction and the k-mer counter. Inputs are numpy arrays made from a
seed; each package builds its own objects from them."""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from test_msv_batch import _csr, _random_read_seeds

torch.set_num_threads(1)

COLUMNS = ("from_pos", "to_pos", "query_from", "query_to", "from_forward",
           "to_forward", "num_supporting_nt", "read_id", "was_mirrored", "id")
DERIVED = ("size", "fuzziness", "seed_dir_fuzziness", "from_start",
           "from_start_same_strand", "from_size", "from_end", "to_start",
           "to_size", "to_end", "sweep_end", "insert_ratio")
PKGS = ("ma_tpu_torch", "ma_tpu")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def pack_of(pkg: str, *contigs):
    pack = mod(pkg, "containers.pack").Pack.empty()
    for i, codes in enumerate(contigs):
        pack.append(f"c{i}", np.asarray(codes, np.uint8))
    return pack


def convert(obj, pkg: str):
    """The same SvJump / SvCall / JumpParams, built from `pkg`'s class."""
    if isinstance(obj, list):
        return [convert(o, pkg) for o in obj]
    cls_mod = "msv.calls" if type(obj).__name__ == "SvCall" else "msv.jumps"
    cls = getattr(mod(pkg, cls_mod), type(obj).__name__)
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = convert(v, pkg) if dataclasses.is_dataclass(v) else (
            list(v) if isinstance(v, list) else v)
    return cls(**kw)


def rows(objs):
    """Comparable rows of SvJumps or SvCalls (every field but params)."""
    out = []
    for o in objs:
        row = []
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            if f.name == "params":
                v = dataclasses.astuple(v)
            elif isinstance(v, np.ndarray):
                v = (str(v.dtype), v.tolist())
            row.append(v)
        out.append(tuple(row))
    return out


def sv_genome(seed: int, n: int = 30_000):
    """(genome, donor): a 600 bp deletion at 8 kb, a 400 bp inversion at
    15 kb and a 300 bp insertion at 22 kb."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    donor = np.concatenate([g[:8000], g[8600:15000], (3 - g[15000:15400])[::-1],
                            g[15400:22000], rng.integers(0, 4, 300).astype(np.uint8),
                            g[22000:]])
    return g, donor


@pytest.fixture(scope="module")
def sv_run():
    """Port-made jumps and calls of 700 bp reads tiled every 60 bp over
    sv_genome(2025), every second one reverse-complemented, as inputs for
    the host modules: (genome, reads codes, jumps, calls)."""
    from ma_tpu_torch.containers.nucseq import NucSeq
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps, sweep_sv_jumps

    g, donor = sv_genome(2025)
    pack = pack_of("ma_tpu_torch", g)
    rng = np.random.default_rng(5)
    reads = []
    for p in range(0, len(donor) - 700, 60):  # 1% substitutions
        r = donor[p : p + 700].copy()
        sub = rng.random(700) < 0.01
        r[sub] = (r[sub] + 1) % 4
        reads.append(r)
    for i in range(1, len(reads), 2):
        reads[i] = (3 - reads[i])[::-1].copy()
    jumps = compute_sv_jumps([NucSeq(r, name=f"r{i}") for i, r in enumerate(reads)], pack,
                             MinimizerIndex.build(pack), device="cpu")
    calls = sweep_sv_jumps(jumps, min_reads=2)
    assert len(jumps) > 1000 and len(calls) >= 20
    return g, reads, jumps, calls


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_hash_seeding_as_ma_tpu(seed):
    """hash_map_seeding, lump_diagonal, kmer_size_for_rectangle,
    reseed_rectangle (both strands) and reseed_gaps across an SV."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    read = np.concatenate([g[500:560], rng.integers(0, 4, 15).astype(np.uint8), g[575:640],
                           (3 - g[1200:1260])[::-1], g[700:800]]).astype(np.uint8)
    seeds = [(0, 40, 500, True, 80), (80, 40, 580, True, 80), (130, 30, 1245, False, 60),
             (200, 50, 730, True, 90)]
    out = {}
    for pkg in PKGS:
        hs = mod(pkg, "ops.hash_seeding")
        pack = pack_of(pkg, g)
        matches = hs.hash_map_seeding(read, g[480:900], 7)
        out[pkg] = (
            matches, hs.lump_diagonal(matches),
            [hs.kmer_size_for_rectangle(w, h, t) for w in (4, 50, 300, 2000)
             for h in (4, 60, 1000) for t in (0.001, 0.01)],
            hs.reseed_rectangle(read, pack, 0, len(read), 450, 900, max_size=500),
            hs.reseed_rectangle(read, pack, 120, 200, 1150, 1300, max_size=200),
            hs.reseed_gaps(seeds, read, pack),
            hs.reseed_gaps(seeds, read, pack, max_size=60),
        )
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    assert len(out["ma_tpu"][5]) > len(seeds)


@pytest.mark.parametrize("seed", [11, 12])
def test_extend_seeds_as_ma_tpu(seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, 4000).astype(np.uint8)
    read = np.concatenate([g[1000:1300], (3 - g[2000:2200])[::-1]]).astype(np.uint8)
    read[rng.integers(0, len(read), 6)] ^= 1
    seeds = [(q, 15, 1000 + q, True, 40) for q in range(5, 290, 37)]
    seeds += [(300 + q, 15, 2199 - q, False, 40) for q in range(3, 190, 29)]
    got = mod("ma_tpu_torch", "ops.extend_host").extend_seeds(seeds, read, pack_of("ma_tpu_torch", g))
    want = mod("ma_tpu", "ops.extend_host").extend_seeds(seeds, read, pack_of("ma_tpu", g))
    assert got == want and got != seeds


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_compute_jumps_as_ma_tpu(seed):
    """compute_jumps and make_jump over random seed sets, with and without
    dummy jumps and size limits."""
    rng = np.random.default_rng(seed)
    for dummy, lo, hi in ((True, 0, 0), (False, 200, 0), (True, 0, 5000)):
        for rid in range(20):
            qlen = int(rng.integers(150, 3000))
            seeds = _random_read_seeds(rng, qlen)
            got, want = (
                mod(pkg, "msv.jumps").compute_jumps(
                    seeds, qlen, read_id=rid,
                    params=mod(pkg, "msv.jumps").JumpParams(
                        do_dummy_jumps=dummy, min_size_jump=lo, max_size_jump=hi))
                for pkg in PKGS)
            assert rows(got) == rows(want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jumps_from_seed_csr_as_ma_tpu(seed):
    """jumps_from_seed_csr over tests/test_msv_batch.py's random cases:
    every column and every derived column."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(60):
        qlen = int(rng.integers(150, 3000))
        reads.append((qlen, _random_read_seeds(rng, qlen)))
    got, want = (mod(pkg, "msv.jumps_batch").jumps_from_seed_csr(
        *_csr(reads), params=mod(pkg, "msv.jumps").JumpParams()) for pkg in PKGS)
    assert len(want) > 50
    for col in COLUMNS:
        a, b = np.asarray(getattr(got, col)), np.asarray(getattr(want, col))
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    for meth in DERIVED:
        assert np.array_equal(getattr(got, meth)(), getattr(want, meth)()), meth
    assert rows(got.to_jumps()) == rows(want.to_jumps())
    sub = np.arange(0, len(want), 3)
    assert rows(got.take(sub).to_jumps()) == rows(want.take(sub).to_jumps())


def test_sweep_and_filters_as_ma_tpu(sv_run):
    """sweep_jumps (JumpBatch and object lists), the short/fuzzy/diagonal/
    score filters and sweep_sv_jumps over the same jumps."""
    _, _, jumps, _ = sv_run
    out = {}
    for pkg in PKGS:
        js = convert(jumps, pkg)
        sw = mod(pkg, "msv.sweep")
        jb = mod(pkg, "msv.jumps_batch").JumpBatch.from_jumps(js, js[0].params)
        by_id = {j.id: j for j in js}
        calls = sw.sweep_jumps(js, min_reads=1)
        out[pkg] = [rows(x) for x in (
            calls, sw.sweep_jumps(jb, min_reads=2),
            sw.filter_low_support_short_calls(calls, 10, 20),
            sw.filter_fuzzy_calls(calls, 50),
            sw.filter_diagonal_line_calls(
                calls, jumps_of=lambda c: [by_id[i] for i in c.supporting_jump_ids],
                threshold=3),
            sw.filter_low_score_calls(calls, min_score=200.0),
            mod(pkg, "msv.pipeline").sweep_sv_jumps(js, min_reads=3),
        )]
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    n = [len(x) for x in out["ma_tpu"]]
    assert n[1] >= 20 and n[0] > n[4] > 0 and n[0] > n[5] > 0 and n[6] > 0, n


def test_ambiguity_and_inserted_as_ma_tpu(sv_run):
    """compute_call_ambiguity on the calls (and on calls over a planted
    repeat), then compute_inserted_sequences from the jumps and reads."""
    g, reads, jumps, calls = sv_run
    g = g.copy()
    g[12000:12040] = g[11000:11040]
    extra = [convert(c, "ma_tpu_torch") for c in calls] + [
        mod("ma_tpu_torch", "msv.calls").SvCall(11020, 12020, 0, 0, True, True, supp_nt=80),
        mod("ma_tpu_torch", "msv.calls").SvCall(5000, 25000, 0, 0, True, False, supp_nt=80)]
    out = {}
    for pkg in PKGS:
        pack = pack_of(pkg, g)
        cs = convert(extra, pkg)
        mod(pkg, "msv.ambiguity").compute_call_ambiguity(cs, pack)
        amb = [mod(pkg, "msv.ambiguity").call_ambiguity(c, pack, distance_max=d)
               for c in cs for d in (10, 20)]
        seqs = [mod(pkg, "containers.nucseq").NucSeq(r) for r in reads]
        mod(pkg, "msv.inserted").compute_inserted_sequences(cs, convert(jumps, pkg), seqs)
        out[pkg] = (amb, rows(cs))
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    assert any(c[8] is not None for c in out["ma_tpu"][1])  # an inserted sequence


def test_tsv_and_html_files_byte_for_byte(sv_run, tmp_path):
    """calls_to_tsv, jumps_to_tsv, render_html and render_interactive_html
    (seed dot-plots, nucleotide tracks, a truth set) write the same bytes."""
    g, _, jumps, calls = sv_run
    seeds = {3: [(0, 40, 1000, True), (60, 30, 1200, False)], 7: [(5, 100, 9000, True)]}
    truth = [mod("ma_tpu_torch", "msv.calls").SvCall(7999, 8600),
             mod("ma_tpu_torch", "msv.calls").SvCall(20000, 20500)]
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        r = mod(pkg, "msv.render")
        js, cs = convert(jumps, pkg), convert(calls, pkg)
        r.calls_to_tsv(cs, str(d / "c.tsv"))
        r.jumps_to_tsv(js, str(d / "j.tsv"))
        r.render_html(str(d / "c.html"), js, cs, genome_len=len(g))
        r.render_html(str(d / "auto.html"), js[:50], cs)
        mod(pkg, "msv.html_view").render_interactive_html(
            str(d / "v.html"), js, cs, genome_len=len(g), truth=convert(truth, pkg),
            read_seeds=seeds, pack=pack_of(pkg, g))
    for name in ("c.tsv", "j.tsv", "c.html", "auto.html", "v.html"):
        a, b = ((tmp_path / pkg / name).read_bytes() for pkg in PKGS)
        assert a == b, name
    assert b"rseeds" in (tmp_path / "ma_tpu" / "v.html").read_bytes()


def test_store_round_trip_as_ma_tpu(sv_run, tmp_path):
    """SvStore: each package loads what the other wrote; the files are the
    same but for the runs' "time" field."""
    _, _, jumps, calls = sv_run
    calls = [dataclasses.replace(c, inserted_sequence=np.array([0, 1, 2, 3], np.uint8))
             if i == 1 else c for i, c in enumerate(calls)]
    for pkg in PKGS:
        st = mod(pkg, "msv.store").SvStore(str(tmp_path / pkg))
        rj = st.new_run("jumps", "unit", kind="jumps")
        st.insert_jumps(rj, convert(jumps, pkg))
        rc = st.new_run("calls", kind="calls")
        st.insert_calls(rc, convert(calls, pkg))
    for name in ("jumps_1.npz", "calls_2.npz"):
        a, b = (np.load(tmp_path / pkg / name) for pkg in PKGS)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    runs = [json.loads((tmp_path / pkg / "runs.json").read_text()) for pkg in PKGS]
    for r in runs:
        for v in r.values():
            v.pop("time")
    assert runs[0] == runs[1]
    for reader, writer in (("ma_tpu", "ma_tpu_torch"), ("ma_tpu_torch", "ma_tpu")):
        st = mod(reader, "msv.store").SvStore(str(tmp_path / writer))
        own = mod(reader, "msv.store").SvStore(str(tmp_path / reader))
        assert rows(st.load_jumps(1)) == rows(own.load_jumps(1))
        assert rows(st.load_calls(2)) == rows(own.load_calls(2))
        assert rows(st.load_calls(2, from_range=(0, 10_000))) == \
            rows(own.load_calls(2, from_range=(0, 10_000)))
        assert st.new_run("more") == 3


def test_reconstruct_as_ma_tpu():
    """The reference's golden example (tests/test_msv_reconstruct.py) and
    calls_to_seeds on it, in both packages."""
    out = {}
    for pkg in PKGS:
        nuc = mod(pkg, "containers.nucseq")
        SvCall = mod(pkg, "msv.calls").SvCall
        rec = mod(pkg, "msv.reconstruct")
        pack = pack_of(pkg, nuc.encode_seq("GATCGTATC"), nuc.encode_seq("CTCGTCAACAG"))
        a = SvCall(4, 7, 0, 0, True, True)
        b = SvCall(9, 14, 0, 0, True, False)
        c = SvCall(10, 15, 0, 0, False, True)
        d = SvCall(16, 17, 0, 0, True, True, inserted_sequence=nuc.encode_seq("TGTT"))
        e = SvCall(0, 19, 0, 0, True, True)
        f = SvCall(1, 19, 0, 0, False, False, mirrored=True)
        g = SvCall(18, 20, 0, 0, True, True)
        paths = [[e, f, a], [b, c, d, g]]
        recon = rec.reconstruct_sequenced_genome(paths, pack)
        seeds = rec.calls_to_seeds(paths, pack)
        out[pkg] = (nuc.decode_seq(recon.codes[: recon.unpacked_size_forward_strand]),
                    [int(x) for x in recon.lengths], recon.names,
                    [(n, s, [None if i is None else i.tolist() for i in ins])
                     for n, s, ins in seeds])
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    assert out["ma_tpu"][0] == "GGATCGTCCGACGAAATGTTCA"


def test_kmer_filter_as_ma_tpu(sv_run):
    """KMerCounter's counts keyed by the same integers, is_unique,
    filter_frequent_seeds and combine_overlapping_calls."""
    _, reads, _, calls = sv_run
    rng = np.random.default_rng(13)
    rep = rng.integers(0, 4, 150).astype(np.uint8)
    seqs = reads[:20] + [rep] * 6 + [rep[:20]]
    seeds = [[(0, 60, 1000, True, 0), (100, 200, 5000, False, 0)] for _ in seqs]
    out = {}
    for pkg in PKGS:
        kf = mod(pkg, "msv.kmer_filter")
        c = kf.KMerCounter(k=15, w=10)
        for s in seqs:
            c.add_sequence(s)
        counts = c._ensure()
        keys = sorted(counts)[:50]
        out[pkg] = (counts, [c.occurrences(h) for h in keys],
                    [c.is_unique(keys, m) for m in (1, 5, 7)],
                    [kf.filter_frequent_seeds(seeds, seqs, c, max_occ=m) for m in (1, 5, 6)],
                    rows(kf.combine_overlapping_calls(convert(calls, pkg), max_dist=200)),
                    rows(kf.combine_overlapping_calls(convert(calls, pkg), max_dist=5000)))
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    counts = out["ma_tpu"][0]
    assert max(counts.values()) >= 6 and all(type(k) is int for k in counts)
