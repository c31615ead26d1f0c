"""SDUST masking of minimizers in the port, on the CPU: ma_tpu_torch's
ops/sdust.py gives ma_tpu's intervals, masks and seed filter (the golden
cases of tests/test_sdust.py and random low-complexity sequences); with
"Minimizers - SDUST Threshold" set, the masked copy of a batch feeds the
minimizer seeding only, the DP keeps the real bases, and the SAM is
byte-identical to ma_tpu's under its reference setting (MA_TPU_DP=fused
MA_TPU_FINISH=native); the FMD techniques ignore the threshold."""
import io

import numpy as np
import pytest
import torch

from test_sdust import GOLDEN, enc
from test_torch_paired import ma_tpu_reference

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

THRES = 20


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_sdust_golden(case):
    from ma_tpu.ops import sdust as ref
    from ma_tpu_torch.ops import sdust

    seq, want = GOLDEN[case]
    assert sdust.sdust(enc(seq)) == want == ref.sdust(enc(seq))
    assert np.array_equal(sdust.dust_mask_array(enc(seq)), ref.dust_mask_array(enc(seq)))


def _low_complexity(rng, n: int) -> np.ndarray:
    """Random bases with tandem repeats (units of 1-6 bases, 2% changed)
    and a few Ns planted."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(int(rng.integers(1, 5))):
        unit = rng.integers(0, 4, int(rng.integers(1, 7)))
        ln = int(rng.integers(20, 120))
        p = int(rng.integers(0, n - ln))
        rep = np.resize(unit, ln).astype(np.uint8)
        flip = rng.random(ln) < 0.02
        rep[flip] = (rep[flip] + 1) % 4
        codes[p : p + ln] = rep
    codes[rng.integers(0, n, int(rng.integers(0, 3)))] = 4
    return codes


@pytest.mark.parametrize("T,W", [(20, 64), (10, 64), (30, 32)])
@pytest.mark.parametrize("seed", range(4))
def test_sdust_matches_ma_tpu(seed, T, W):
    from ma_tpu.ops import sdust as ref
    from ma_tpu_torch.ops import sdust

    codes = _low_complexity(np.random.default_rng(seed), 600)
    got = sdust.sdust(codes, T=T, W=W)
    assert got == ref.sdust(codes, T=T, W=W)
    assert T != 20 or got, "the planted repeats must be masked"
    assert np.array_equal(sdust.dust_mask_array(codes, T=T, W=W),
                          ref.dust_mask_array(codes, T=T, W=W))


def test_seed_filter_matches_ma_tpu():
    from ma_tpu.ops import sdust as ref
    from ma_tpu_torch.ops import sdust

    rng = np.random.default_rng(1)
    codes = _low_complexity(rng, 600)
    dust = sdust.sdust(codes)
    seeds = [(int(q), int(ln), i) for i, (q, ln) in
             enumerate(zip(rng.integers(0, 580, 200), rng.integers(5, 40, 200)))]
    seeds.sort()
    got = sdust.filter_seeds_by_dust(seeds, dust)
    assert got == ref.filter_seeds_by_dust(seeds, dust)
    assert 0 < len(got) < len(seeds)
    assert [sdust.dust_overlap_ok(q, ln, dust) for q, ln, _ in seeds] == \
        [ref.dust_overlap_ok(q, ln, dust) for q, ln, _ in seeds]


def test_dust_masked_batch():
    """The aligner's batch helper sets each read's SDUST spans to N, up to
    its length, and leaves the batch it was given as it was."""
    from ma_tpu.ops.sdust import dust_mask_array
    from ma_tpu_torch.pipeline.aligner import dust_masked

    rng = np.random.default_rng(2)
    lens = np.array([300, 0, 150, 257], np.int32)
    seqs = np.full((4, 512), 4, np.uint8)
    for b, n in enumerate(lens):
        seqs[b, :n] = _low_complexity(rng, 300)[:n] if n else 0
    before = seqs.copy()
    got = dust_masked(seqs, lens, THRES)
    assert np.array_equal(seqs, before)
    for b, n in enumerate(lens):
        want = seqs[b].copy()
        want[:n][dust_mask_array(seqs[b, :n], T=THRES)] = 4
        assert np.array_equal(got[b], want)
    assert (got != seqs).any()


# a 20 kbp genome with low-complexity islands; 64 reads of 150 bp at 1%
# substitutions, every fourth read across an island, odd reads reverse
# complemented
FIXTURE = """
import importlib
import numpy as np

def fixture(pkg="ma_tpu_torch"):
    nucseq = importlib.import_module(pkg + ".containers.nucseq")
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    rng = np.random.default_rng(77)
    G = 20_000
    genome = rng.integers(0, 4, size=G).astype(np.uint8)
    islands = []
    for k, unit in enumerate(([0], [1, 2, 3], [0, 3], [2, 2, 0, 1])):
        p = 1_500 + 4_500 * k
        genome[p : p + 90] = np.resize(np.asarray(unit, np.uint8), 90)
        islands.append(p)
    pack = Pack.empty()
    pack.append("chrD", genome)
    reads = []
    for i in range(64):
        if i % 4 == 0:
            p = islands[(i // 4) % 4] - int(rng.integers(10, 50))
        else:
            p = int(rng.integers(0, G - 150))
        codes = genome[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.01)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = nucseq.revcomp_codes(codes)
        reads.append(nucseq.NucSeq(codes, name=f"d{i}"))
    return pack, reads
"""


def _fixture(pkg="ma_tpu_torch"):
    scope: dict = {}
    exec(FIXTURE, scope)
    return scope["fixture"](pkg)


def _port_sam(thres: int, preset: str = "Default", technique="minimizers") -> str:
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack, reads = _fixture()
    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    mgr.selected.set("Seeding Technique", technique)
    mgr.selected.set("Minimizers - SDUST Threshold", thres)
    out = io.StringIO()
    assert Aligner(pack, mgr, device="cpu").align_to_sam(iter(reads), out, batch_size=64,
                                                         cmd="ma_tpu") == len(reads)
    return out.getvalue()


def test_sdust_sam_identical_to_ma_tpu():
    port = _port_sam(THRES)
    with ma_tpu_reference() as fresh:
        from ma_tpu.index.fmd_index import FMDIndex
        from ma_tpu.pipeline.aligner import Aligner

        fresh()
        pack, reads = _fixture("ma_tpu")
        al = Aligner(pack, FMDIndex.build(pack))
        al.pset.set("Seeding Technique", "minimizers")
        al.pset.set("Minimizers - SDUST Threshold", THRES)
        out = io.StringIO()
        al.align_to_sam(iter(reads), out, batch_size=64)
    assert port.count("\n") > 3 + 48
    assert port == out.getvalue()
    assert port != _port_sam(0), "the threshold must change the output"


def test_mask_feeds_seeding_only(monkeypatch):
    """The minimizer stage gets the masked copy (Ns over the islands), while
    the DP reads the real bases: an exact copy of the genome across an
    island aligns without mismatches or gaps at threshold 20."""
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.containers.nucseq import NucSeq
    from ma_tpu_torch.pipeline import aligner as A

    pack, _reads = _fixture()
    genome = np.asarray(pack.codes)
    p = 1_500 - 30
    read = NucSeq(genome[p : p + 150].copy(), name="exact")
    seen = []
    stage = A.device_stage_mm

    def spy(cfg, mmi, cs, ref_len, seqs, lens):
        seen.append(seqs.clone())
        return stage(cfg, mmi, cs, ref_len, seqs, lens)

    monkeypatch.setattr(A, "device_stage_mm", spy)
    scores, first = {}, []
    for thres in (0, THRES):
        seen.clear()
        mgr = ParameterSetManager()
        mgr.selected.set("Seeding Technique", "minimizers")
        mgr.selected.set("Minimizers - SDUST Threshold", thres)
        alns = A.Aligner(pack, mgr, device="cpu").align_batch([read])[0]
        best = max(alns, key=lambda a: a.score())
        assert abs(best.begin_on_ref - p) <= 5
        scores[thres] = (best.score(), best.cigar(pack, 150))
        first.append(seen[0])
    plain, masked = (s[0, :150].numpy() for s in first)
    assert np.array_equal(plain, read.codes)
    assert (masked[30:120] == 4).all() and np.array_equal(masked[:20], read.codes[:20])
    # a DP over the masked copy would score the 90 Ns as mismatches; over
    # the real bases the read aligns without a gap, at least as well as
    # the unmasked seeds (whose repeat seeds shift it by a 7 bp indel)
    score, cigar = scores[THRES]
    assert score >= max(scores[0][0], 2 * 148) and not set(cigar) & set("ID"), scores


def test_fmd_techniques_ignore_the_threshold():
    assert _port_sam(THRES, technique="maxSpan") == _port_sam(0, technique="maxSpan")
