"""The port's copies of ma_tpu's evaluation and host-filter tools against
ma_tpu on the same inputs: the host seed filters (ops/filters_host.py, the
ten cases of tests/test_filters_host.py, nw_alignment among them), Bowtie-
and BLASR-style seeding (ops/other_seeding.py), the alignment printer
(utils/printer.py), the genome and read simulators (utils/simulate.py) and
the SAM reader with its seed-set comparison (io/sam_reader.py) on SAM text
the port's CPU Aligner writes. Inputs are numpy arrays made from a seed;
each package builds its own objects from them."""
import dataclasses
import io

import numpy as np
import pytest
import torch

from test_torch_msv_host import PKGS, mod, pack_of
from test_torch_store import both

torch.set_num_threads(1)


# --------------------------------------------------------- host filters
def contig_border(pkg):
    fh = mod(pkg, "ops.filters_host")
    pack = pack_of(pkg, np.random.default_rng(1).integers(0, 4, 100000))
    near, far, rev_far = (0, 20, 100, True, 0), (0, 20, 50000, True, 0), (0, 20, 60000, False, 0)
    out = fh.filter_contig_border([near, far, rev_far], pack)
    assert out == [far, rev_far]
    return out


def smem(pkg):
    big, enclosed = (0, 50, 100, True, 0), (10, 20, 500, True, 0)
    extending = (30, 40, 900, True, 0)
    out = mod(pkg, "ops.filters_host").max_extended_to_smem([big, enclosed, extending])
    assert big in out and extending in out and enclosed not in out
    return out


def max_spanning(pkg):
    long_seed, short_inside = (0, 60, 100, True, 0), (10, 20, 500, True, 0)
    tail = (55, 30, 900, True, 0)  # the longest covering positions 60..84
    out = mod(pkg, "ops.filters_host").max_extended_to_max_spanning(
        [long_seed, short_inside, tail])
    assert long_seed in out and tail in out and short_inside not in out
    return out


def overlapping_seeds(pkg):
    a, b = (0, 50, 100, True, 0), (40, 50, 600, True, 0)
    out = mod(pkg, "ops.filters_host").filter_overlapping_seeds([a, b], min_nt_non_overlap=16)
    assert (0, 40, 100, True, 0) in out and (50, 40, 610, True, 0) in out
    return out


def to_unique(pkg):
    ref = np.random.default_rng(2).integers(0, 4, 1000).astype(np.uint8)
    ref[500:530] = ref[100:130]  # a duplicate region
    dup_seed, uniq_seed = (5, 30, 100, True, 0), (0, 45, 95, True, 0)
    out = mod(pkg, "ops.filters_host").filter_to_unique([dup_seed, uniq_seed], ref[95:140].copy(),
                                                        ref)
    assert out == [uniq_seed]
    return out


def palindrome(pkg):
    fwd, rev, far = (10, 30, 1000, True, 0), (15, 20, 1025, False, 0), (60, 30, 5000, True, 0)
    kept, pal = mod(pkg, "ops.filters_host").palindrome_filter([fwd, rev, far])
    assert fwd in kept and far in kept and rev in pal
    return kept, pal


def by_area(pkg):
    inside, outside = (0, 20, 100, True, 0), (0, 20, 5000, True, 0)
    rev_inside = (0, 20, 115, False, 0)  # spans [96, 116)
    out = mod(pkg, "ops.filters_host").filter_seeds_by_area([inside, outside, rev_inside], 90, 30)
    assert inside in out and rev_inside in out and outside not in out
    return out


def nw_global(pkg):
    dp = mod(pkg, "ops.dp")
    q = np.array([0, 1, 2, 3, 0, 1], np.uint8)
    t = np.array([0, 1, 2, 2, 3, 0, 1], np.uint8)
    kw = {"device": "cpu"} if pkg == "ma_tpu_torch" else {}
    score, cigar = dp.nw_alignment(q, t, **kw)
    assert sum(n for op, n in cigar if op == dp.OP_D) == 1
    assert sum(n for op, n in cigar if op == dp.OP_M) == 6 and score == 6 * 2 - (4 + 2)
    rng = np.random.default_rng(4)
    rand = [dp.nw_alignment(rng.integers(0, 5, n).astype(np.uint8),
                            rng.integers(0, 5, m).astype(np.uint8), **kw)
            for n, m in ((1, 9), (30, 24), (57, 60))]
    return score, cigar, rand


def local_seed_set(pkg):
    chain = [(0, 30, 1000, True, 0), (35, 30, 1035, True, 0), (70, 30, 1072, True, 0)]
    out = mod(pkg, "ops.filters_host").pick_local_seed_set(chain + [(110, 10, 90000, True, 0)])
    assert set(out) == set(chain)
    return out


def overlapping_socs(pkg):
    fh = mod(pkg, "ops.filters_host")
    out = fh.filter_overlapping_socs([[(0, 60, 1000, True, 0)], [(40, 60, 5000, True, 0)]])
    assert len(out) == 2
    assert 50 in [s[0] + s[1] for soc in out for s in soc]
    assert 50 in [s[0] for soc in out for s in soc]
    out2 = fh.filter_overlapping_socs([[(0, 100, 1000, True, 0)], [(30, 20, 9000, True, 0)]])
    assert len(out2) == 1 and out2[0][0][1] == 100
    return out, out2


@pytest.mark.parametrize("case", [contig_border, smem, max_spanning, overlapping_seeds,
                                  to_unique, palindrome, by_area, nw_global, local_seed_set,
                                  overlapping_socs], ids=lambda c: c.__name__)
def test_host_filters_as_ma_tpu(case):
    both(case)


def test_host_filters_on_random_seed_sets_as_ma_tpu():
    """Every filter on random per-read seed sets, each package's output
    equal."""
    def run(pkg):
        fh = mod(pkg, "ops.filters_host")
        rng = np.random.default_rng(77)
        g = rng.integers(0, 4, 60_000).astype(np.uint8)
        pack = pack_of(pkg, g[:30_000], g[30_000:])
        out = []
        for _ in range(12):
            n = int(rng.integers(1, 12))
            seeds = [(int(q), int(ln), int(r), bool(fw), int(ln))
                     for q, ln, r, fw in zip(rng.integers(0, 200, n), rng.integers(10, 60, n),
                                             rng.integers(100, 59_000, n), rng.integers(0, 2, n))]
            query = rng.integers(0, 4, 300).astype(np.uint8)
            out.append((
                fh.filter_contig_border(seeds, pack, max_dist=1000),
                fh.max_extended_to_smem(seeds), fh.max_extended_to_max_spanning(seeds),
                fh.filter_overlapping_seeds(seeds), fh.palindrome_filter(seeds),
                fh.filter_seeds_by_area(seeds, 5_000, 20_000), fh.pick_local_seed_set(seeds),
                fh.filter_overlapping_socs([seeds[: n // 2], seeds[n // 2 :]]),
                fh.filter_to_unique(seeds[:3], query, g[:2_000]),
            ))
        return out

    both(run)


# ------------------------------------------------------- other seeding
@pytest.fixture(scope="module")
def fmd_pair():
    genome = np.random.default_rng(101).integers(0, 4, 3000).astype(np.uint8)
    return genome, {pkg: mod(pkg, "index.fmd_index").FMDIndex.build(pack_of(pkg, genome))
                    for pkg in PKGS}


def test_bowtie_seeding_as_ma_tpu(fmd_pair):
    genome, fmd = fmd_pair
    read = genome[500:560].copy()
    read[40] = 4
    out = both(lambda pkg: mod(pkg, "ops.other_seeding").bowtie_seeding(fmd[pkg], read, 16, 1))
    assert len(out) == 60 - 16 - 17 and all(sz == 16 and ik[2] >= 1 for _, sz, ik in out)
    both(lambda pkg: mod(pkg, "ops.other_seeding").bowtie_seeding(fmd[pkg], genome[7:107], 12, 3))


def test_blasr_seeding_as_ma_tpu(fmd_pair):
    genome, fmd = fmd_pair
    read = genome[1000:1100]
    out = both(lambda pkg: mod(pkg, "ops.other_seeding").blasr_seeding(fmd[pkg], read, 12))
    assert out and any(sz > 50 for _, sz, _ in out)
    assert all(sz > 0 and qs >= 0 and qs + sz <= 100 for qs, sz, _ in out)
    noisy = (3 - genome[2000:2120])[::-1].copy()
    noisy[::25] = (noisy[::25] + 1) % 4
    both(lambda pkg: mod(pkg, "ops.other_seeding").blasr_seeding(fmd[pkg], noisy, 10))


# ------------------------------------------------------------- printer
def test_format_alignment_as_ma_tpu():
    def text(pkg):
        al = mod(pkg, "containers.alignment")
        rng = np.random.default_rng(3)
        genome = rng.integers(0, 4, 100).astype(np.uint8)
        pack = pack_of(pkg, genome)
        query = genome[10:40].copy()
        query[5] = (query[5] + 1) % 4
        a = al.Alignment(begin_on_ref=10, begin_on_query=0)
        a.append(al.SEED, 5)
        a.append(al.MISMATCH, 1)
        a.append(al.SEED, 24)
        gapped = al.Alignment(begin_on_ref=50, begin_on_query=0)
        for op, n in ((al.MATCH, 10), (al.INSERTION, 2), (al.MATCH, 8), (al.DELETION, 3),
                      (al.MATCH, 10)):
            gapped.append(op, n)
        q2 = rng.integers(0, 4, 30).astype(np.uint8)
        printer = mod(pkg, "utils.printer")
        return (printer.format_alignment(a, query, pack),
                printer.format_alignment(gapped, q2, pack, width=16))

    plain, gapped = both(text)
    assert "Q " in plain and "R " in plain and plain.count("*") == 1
    assert "-" in gapped


# ------------------------------------------------------------ simulate
def test_simulate_as_ma_tpu(tmp_path):
    def arrays(pkg):
        sim = mod(pkg, "utils.simulate")
        spec = sim.GenomeSpec(length=40_000, repeat_len_range=(200, 800))
        g = sim.simulate_genome(spec, seed=9)
        short, st = sim.simulate_illumina(g, 20, read_len=100, indel_rate=0.01, seed=3)
        long_, lt = sim.simulate_long_reads(g, 4, mean_len=1500, seed=4)
        sim.write_fasta(str(tmp_path / f"{pkg}.fa"), "g", g[:1000])
        sim.write_fastq(str(tmp_path / f"{pkg}.fq"), short[:4], prefix="s")
        files = [(tmp_path / f"{pkg}{s}").read_bytes() for s in (".fa", ".fq")]
        assert g.dtype == np.uint8 and len(g) == 40_000
        return ([g.tolist()], [r.tolist() for r in short], st, [r.tolist() for r in long_], lt,
                files)

    both(arrays)


# --------------------------------------------------------- SAM reader
@pytest.fixture(scope="module")
def sam_case():
    """SAM text the port's CPU Aligner writes for 8 exact 120 bp reads
    (every second one reverse complemented) over a 12 kb genome."""
    from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes
    from ma_tpu_torch.pipeline.aligner import Aligner

    rng = np.random.default_rng(61)
    genome = rng.integers(0, 4, 12000).astype(np.uint8)
    reads, truth = [], []
    for i in range(8):
        p = int(rng.integers(0, 12000 - 120))
        codes = genome[p : p + 120]
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"s{i}"))
        truth.append((p, bool(i % 2)))
    buf = io.StringIO()
    Aligner(pack_of("ma_tpu_torch", genome), device="cpu").align_to_sam(
        iter(reads), buf, batch_size=8)
    return genome, reads, truth, buf.getvalue()


def test_sam_reader_as_ma_tpu(sam_case):
    """read_sam, records_by_name, alignment_to_seeds and SeedSetComp on the
    port's SAM: the same records, seeds and recall in both packages, and
    every read's seeds at its simulated place (recall 1)."""
    genome, reads, truth, sam = sam_case

    def parse(pkg):
        sr = mod(pkg, "io.sam_reader")
        pack = pack_of(pkg, genome)
        by_name = sr.records_by_name(io.StringIO(sam))
        comp = sr.SeedSetComp()
        seeds = []
        for i, (p, rev) in enumerate(truth):
            recs = [r for r in by_name[f"s{i}"] if not r.is_secondary]
            found = sr.alignment_to_seeds(recs[0], pack)
            comp.add([(0, 120, p + 119, False)] if rev else [(0, 120, p, True)], found)
            seeds.append(found)
            for q, ln, r, fw in found:
                for j in range(0, ln, 17):
                    assert reads[i].codes[q + j] == (genome[r + j] if fw else 3 - genome[r - j])
        recs = [dataclasses.astuple(r) + (r.is_reverse, r.is_supplementary)
                for r in sr.read_sam(io.StringIO(sam))]
        return recs, seeds, dataclasses.astuple(comp), comp.recall

    recs, _, _, recall = both(parse)
    assert len(recs) >= 8 and recall == 1.0


def test_seed_overlap_and_ksw_as_ma_tpu(tmp_path):
    def run(pkg):
        sr = mod(pkg, "io.sam_reader")
        a, b, c = [(0, 10, 100, True)], [(5, 10, 105, True)], [(0, 10, 109, False)]
        pack = pack_of(pkg, np.zeros(100, np.uint8), np.ones(100, np.uint8))
        p = tmp_path / f"{pkg}.ksw"
        p.write_text("@hdr\nc1\t11\t60\tread7\t0\t0\t0\t0\t0\t50M\n"
                     "c0\t3\t60\tread8\t0\t0\t0\t0\t0\t2S8M\n")
        bad = tmp_path / f"{pkg}.bad"
        bad.write_text("c0\t3\t60\n")
        with pytest.raises(ValueError) as ex:
            list(sr.read_ksw(str(bad), pack))
        return (sr.seed_overlap_nt(a, b), sr.seed_overlap_nt(a, c),
                list(sr.read_ksw(str(p), pack)), str(ex.value))

    overlap, crossed, ksw, _ = both(run)
    assert (overlap, crossed) == (5, 0)
    assert ksw == [("read7", 110, "50M"), ("read8", 2, "2S8M")]
