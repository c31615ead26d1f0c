"""The port's copies of ma_tpu's host modules against ma_tpu's, on the same
inputs: the FMD index (SA-IS and the packed-40 build), the pack and index
file formats in both directions, the CHD table, the SAM writer (the @PG line
included), mapping quality, the parameter presets, and the native finish
(plan, assemble, SAM emission) on the calls of a whole slice run."""
import io

import numpy as np
import pytest
import torch

from ma_tpu.config import parameters as JP
from ma_tpu.containers import alignment as JAl
from ma_tpu.containers.nucseq import NucSeq as JNucSeq
from ma_tpu.containers.pack import Pack as JPack
from ma_tpu.index.fmd_index import FMDIndex as JFMD
from ma_tpu.io import sam as JSam
from ma_tpu.native import chd as JChd
from ma_tpu.native import sais as JSais
from ma_tpu.pipeline import finish_native as JFin
from ma_tpu.pipeline.quality import mapping_quality as j_mapq
from ma_tpu_torch.config import parameters as TP
from ma_tpu_torch.containers import alignment as TAl
from ma_tpu_torch.containers.nucseq import NucSeq as TNucSeq
from ma_tpu_torch.containers.pack import Pack as TPack
from ma_tpu_torch.index.fmd_index import FMDIndex as TFMD
from ma_tpu_torch.io import sam as TSam
from ma_tpu_torch.native import chd as TChd
from ma_tpu_torch.native import sais as TSais
from ma_tpu_torch.pipeline import finish_native as TFin
from ma_tpu_torch.pipeline.quality import mapping_quality as t_mapq

torch.set_num_threads(1)

FMD_FIELDS = ("n", "primary", "L2", "bwt_words", "occ_cp", "ssa")


def _packs():
    """Both packages' packs of two contigs, one with a run of Ns."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, 9_000).astype(np.uint8)
    b = rng.integers(0, 4, 5_000).astype(np.uint8)
    a[3_000:3_040] = 4
    out = []
    for cls in (JPack, TPack):
        p = cls.empty()
        p.append("chrA", a)
        p.append("chrB", b)
        out.append(p)
    return out


def _same_fmd(x, y):
    for name in FMD_FIELDS:
        assert np.array_equal(np.asarray(getattr(x, name)), np.asarray(getattr(y, name))), name


def test_fmd_index_build_and_files_across_packages(tmp_path):
    jpack, tpack = _packs()
    jf, tf = JFMD.build(jpack), TFMD.build(tpack)
    _same_fmd(jf, tf)
    tf.store(str(tmp_path / "t"))
    jf.store(str(tmp_path / "j"))
    _same_fmd(JFMD.load(str(tmp_path / "t")), tf)
    _same_fmd(TFMD.load(str(tmp_path / "j")), jf)


def test_sais_builds_agree():
    rng = np.random.default_rng(2)
    text = rng.integers(0, 4, 20_000).astype(np.uint8)
    text[5_000:5_300] = np.tile([0, 1, 2], 100)
    assert np.array_equal(JSais.suffix_array(text), TSais.suffix_array(text))
    for a, b in zip(JSais.fmd_arrays_large(text), TSais.fmd_arrays_large(text)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pack_files_across_packages(tmp_path):
    jpack, tpack = _packs()
    tpack.store(str(tmp_path / "t"))
    jpack.store(str(tmp_path / "j"))
    assert (tmp_path / "t.json").read_text().replace('"t"', '"j"') == \
        (tmp_path / "j.json").read_text()
    for load, prefix, want in ((JPack.load, "t", tpack), (TPack.load, "j", jpack)):
        got = load(str(tmp_path / prefix))
        for name in ("codes", "starts", "lengths"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), name
        assert list(got.names) == list(want.names)
        assert [tuple(h) for h in got.holes] == [tuple(h) for h in want.holes]


def test_chd_tables_agree():
    rng = np.random.default_rng(4)
    hu = np.unique(rng.integers(0, 2**32, 5_000, dtype=np.uint64)).astype(np.uint32)
    uoff = np.arange(len(hu) + 1, dtype=np.int32)
    got, want = TChd.build(hu, uoff), JChd.build(hu, uoff)
    assert got[2:] == want[2:]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_minimizer_index_files_across_packages(tmp_path):
    from ma_tpu.index.minimizer import MinimizerIndex as JMI
    from ma_tpu_torch.index.minimizer import MinimizerIndex as TMI

    jpack, tpack = _packs()
    TMI.build(tpack, 15, 10).store(str(tmp_path / "t"))
    JMI.build(jpack, 15, 10).store(str(tmp_path / "j"))
    a, b = JMI.load(str(tmp_path / "t")), TMI.load(str(tmp_path / "j"))
    assert (a.k, a.w) == (b.k, b.w) == (15, 10)
    for name in ("hash_sorted", "pos", "strand"):
        assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))), name


def _alignments(mod, pack_len, rng_seed):
    """Alignments of package `mod` from one draw: random op runs, strands,
    seed counts and a mapping-quality-zero flag."""
    rng = np.random.default_rng(rng_seed)
    out = []
    ops = (mod.SEED, mod.MATCH, mod.MISMATCH, mod.INSERTION, mod.DELETION)
    for k in range(7):
        begin = int(rng.integers(0, pack_len - 400))
        a = mod.Alignment(begin_on_ref=begin, begin_on_query=int(rng.integers(0, 5)))
        for _ in range(int(rng.integers(3, 12))):
            a.append(ops[int(rng.integers(0, 5))], int(rng.integers(1, 20)))
        a.stats.name = f"q{k}"
        a.stats.num_seeds = int(rng.integers(0, 4))
        a.stats.set_mapping_quality_to_zero = k == 5
        out.append(a)
    return out


def _aln_fields(alns):
    return [(a.data, a.begin_on_ref, a.end_on_ref, a.begin_on_query, a.end_on_query,
             a.iscore, a.secondary, a.supplementary, repr(a.mapping_quality)) for a in alns]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mapping_quality_agrees(seed):
    for report_n, min_score in ((0, -10_000), (2, 0)):
        got = t_mapq(_alignments(TAl, 14_000, seed), 150, report_n=report_n, min_score=min_score)
        want = j_mapq(_alignments(JAl, 14_000, seed), 150, report_n=report_n, min_score=min_score)
        assert _aln_fields(got) == _aln_fields(want)


@pytest.mark.parametrize("soft_clip,use_m", [(False, True), (True, False)])
def test_sam_writer_agrees(soft_clip, use_m):
    jpack, tpack = _packs()
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 150).astype(np.uint8)
    texts = []
    for pack, mod, nucseq, sam in ((jpack, JAl, JNucSeq, JSam), (tpack, TAl, TNucSeq, TSam)):
        alns = _alignments(mod, 2 * pack.unpacked_size_forward_strand, 5)
        for a in alns:
            a.mapping_quality = 0.5
        out = io.StringIO()
        w = sam.SamWriter(out, pack, soft_clip=soft_clip, use_m_cigar=use_m)
        w.write(alns, nucseq(codes.copy(), name="q", qual="I" * 150))
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "@PG\tID:ma_tpu\tPN:ma_tpu\tVN:0.1.0\t" in texts[1]


def test_parameter_presets_agree():
    jm, tm = JP.ParameterSetManager(), TP.ParameterSetManager()
    assert list(jm.sets) == list(tm.sets)
    for name, js in jm.sets.items():
        ts = tm.sets[name]
        assert list(js.by_name) == list(ts.by_name), name
        assert {k: js.get(k) for k in js.by_name} == {k: ts.get(k) for k in ts.by_name}, name


def test_native_finish_calls_agree(monkeypatch):
    """A slice run of the port with every native finish call (plan,
    assemble, SAM emission) repeated through ma_tpu's library on the same
    arguments: the same outputs."""
    from test_torch_slice import _fixture

    from ma_tpu_torch.pipeline.aligner import Aligner

    seen = {"plan": 0, "assemble": 0, "emit_sam": 0}

    def spy(name):
        mine, ref = getattr(TFin, name), getattr(JFin, name)

        def both(*args, **kw):
            got, want = mine(*args, **kw), ref(*args, **kw)
            seen[name] += 1
            assert type(got) is type(want)
            if isinstance(got, tuple):
                for x, y in zip(got, want):
                    assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y)
            else:
                assert got == want
            return got
        return both

    for name in seen:
        monkeypatch.setattr(TFin, name, spy(name))
    pack, reads = _fixture()
    al = Aligner(pack, device="cpu")
    al.pset.set("Seeding Technique", "minimizers")
    assert al.align_to_sam(iter(reads), io.StringIO(), batch_size=24) == len(reads)
    assert min(seen.values()) >= 1, seen
