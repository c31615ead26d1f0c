"""Small-inversion rescue in ma_tpu_torch against ma_tpu's on the CPU: the
z-drop window scan, the rescue itself (split into device calls or not, with
cigars from the device traceback equal to the host traceback's), and short
reads with inversions on: the native plan with Alignment objects to SAM,
byte-identical to ma_tpu's under MA_TPU_DP=fused, MA_TPU_FINISH=native."""
import copy
import importlib
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ma_tpu.pipeline import inversions as JI  # noqa: E402
from ma_tpu_torch.containers.alignment import DELETION, INSERTION, MATCH, MISMATCH, SEED  # noqa: E402,E501
from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq, revcomp_codes  # noqa: E402
from ma_tpu_torch.ops.dp import DPParams, traceback_one  # noqa: E402
from ma_tpu_torch.ops.dp_wavefront import banded_align_wavefront  # noqa: E402
from ma_tpu_torch.pipeline import inversions as TI  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)


def _aln(begin_ref, begin_q, ops, pkg="ma_tpu_torch"):
    """An Alignment of package `pkg` (the op codes are the same in both)."""
    Alignment = importlib.import_module(pkg + ".containers.alignment").Alignment
    a = Alignment(begin_on_ref=begin_ref, begin_on_query=begin_q)
    for op, n in ops:
        a.append(op, n)
    return a


@pytest.mark.parametrize("ops", [
    [(SEED, 50), (MISMATCH, 60), (SEED, 50)],
    [(SEED, 50), (MATCH, 40), (SEED, 50)],
    [(SEED, 30), (INSERTION, 30), (MATCH, 5), (DELETION, 70), (SEED, 20), (MISMATCH, 80),
     (MATCH, 3), (SEED, 10)],
])
def test_for_all_drop_pos(ops):
    args = (2, 4, 4, 2, 100)
    assert (TI.for_all_drop_pos(_aln(1000, 5, ops), *args)
            == JI.for_all_drop_pos(_aln(1000, 5, ops, "ma_tpu"), *args))


def _inversion_case(pkg="ma_tpu_torch"):
    """A genome and reads carrying inverted stretches, with alignments that
    replay them as mismatch / indel windows between seeds, as objects of
    package `pkg`."""
    nucseq = importlib.import_module(pkg + ".containers.nucseq")
    NucSeq = nucseq.NucSeq
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, size=16_384).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrI", genome)
    reads, alns = [], []
    for k, (p, inv_len, fwd) in enumerate(((4000, 60, 80), (9000, 150, 100), (12000, 90, 60))):
        inv = revcomp_codes(genome[p + fwd : p + fwd + inv_len]).copy()
        inv[::13] = (inv[::13] + 1) % 4
        codes = np.concatenate([genome[p : p + fwd], inv,
                                genome[p + fwd + inv_len : p + 2 * fwd + inv_len]])
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"inv{k}"))
        mid = ([(MISMATCH, inv_len)] if k != 1
               else [(DELETION, inv_len // 2), (MISMATCH, inv_len - inv_len // 2),
                     (INSERTION, inv_len // 2)])
        alns.append([_aln(p, 0, [(SEED, fwd)] + mid + [(SEED, fwd)], pkg)])
    alns[2].append(_aln(12000, 0, [(SEED, 60), (MATCH, 90), (SEED, 60)], pkg))  # no window
    return pack, reads, alns


def _fields(per_read):
    # repr: the packages' Alignment objects are distinct, and NaN != NaN
    return [[(a.data, a.begin_on_ref, a.end_on_ref, a.begin_on_query, a.end_on_query,
              a.supplementary, a.secondary, repr(a.mapping_quality), a.score()) for a in alns]
            for alns in per_read]


def test_small_inversions_matches_ma_tpu(monkeypatch):
    pack, reads, alns = _inversion_case()
    one_call, split = (copy.deepcopy(alns) for _ in range(2))
    jpack, jreads, want = _inversion_case("ma_tpu")
    JI.small_inversions(want, jreads, jpack, params=DPParams())
    TI.small_inversions(one_call, reads, pack, device="cpu", params=DPParams())
    monkeypatch.setattr(TI, "MAX_DIR_BYTES", 1)  # one window per device call
    TI.small_inversions(split, reads, pack, device="cpu", params=DPParams())
    assert sum(len(x) for x in want) > sum(len(x) for x in alns)  # inversions found
    assert _fields(one_call) == _fields(want) == _fields(split)


def test_window_cigars_equal_host_traceback():
    """The rescue's cigars come from the device traceback; they equal the
    host traceback_one of ma_tpu's rescue on the same direction bytes."""
    pack, reads, alns = _inversion_case()
    segs = []
    for r, per in zip(reads, alns):
        for a in per:
            for sq, sr, eq, er in TI.for_all_drop_pos(a, 2, 4, 4, 2, 100):
                rs, re_ = pack.pos_to_reverse_strand(er), pack.pos_to_reverse_strand(sr)
                segs.append((np.asarray(r.codes[sq:eq], np.uint8),
                             np.asarray(pack.extract(int(rs), int(re_)), np.uint8)))
    cigars = TI._window_cigars(segs, 512, DPParams(), "cpu")
    for (qs, ts), cig in zip(segs, cigars):
        res = banded_align_wavefront(torch.as_tensor(qs[None]), torch.as_tensor(ts[None]),
                                     torch.tensor([len(qs)]), torch.tensor([len(ts)]),
                                     torch.tensor([512]), DPParams(), -1, True)
        assert cig == traceback_one(res.dirs[0].numpy(), len(qs) - 1, len(ts) - 1)
    assert len(cigars) == 3


def _short_fixture(pkg="ma_tpu_torch"):
    """The 60 kbp genome and 150 bp reads of tests/test_torch_slice.py, plus
    three 220 bp reads of 80 forward + 60 inverted (mutated every 12 bases)
    + 80 forward bases, as tests/test_inversions.py builds them; objects of
    package `pkg`."""
    from test_torch_slice import _fixture

    NucSeq = importlib.import_module(pkg + ".containers.nucseq").NucSeq
    pack, reads = _fixture(pkg)
    genome = np.asarray(pack.codes, np.uint8)
    for k, p in enumerate((4000, 21000, 47000)):
        inv = revcomp_codes(genome[p + 80 : p + 140]).copy()
        for j in (6, 18, 30, 42, 54):
            inv[j] = (inv[j] + 1) % 4
        codes = np.concatenate([genome[p : p + 80], inv, genome[p + 140 : p + 220]])
        if k == 1:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"invread{k}"))
    return pack, reads


def test_short_reads_sam_identical_to_ma_tpu(monkeypatch):
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.pipeline.aligner import Aligner as JAligner
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack, reads = _short_fixture()
    jpack, jreads = _short_fixture("ma_tpu")
    port = Aligner(pack, device="cpu")
    port.pset.set("Seeding Technique", "minimizers")
    port.pset.set("Detect Small Inversions", True)
    got = io.StringIO()
    assert port.align_to_sam(iter(reads), got, batch_size=32, cmd="ma_tpu") == len(reads)

    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    jax.clear_caches()
    try:
        ref = JAligner(jpack, FMDIndex.build(jpack))
        ref.pset.set("Seeding Technique", "minimizers")
        ref.pset.set("Detect Small Inversions", True)
        want = io.StringIO()
        ref.align_to_sam(iter(jreads), want, batch_size=32)
    finally:
        jax.clear_caches()
    assert got.getvalue() == want.getvalue()
    recs = [r.split("\t") for r in got.getvalue().splitlines() if not r.startswith("@")]
    assert any(f[0].startswith("invread") and int(f[1]) & 2048 and f[4] == "0" for f in recs)
