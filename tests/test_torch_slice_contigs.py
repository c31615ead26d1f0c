"""The ported slice on a second fixture: two contigs, one holding a tandem
repeat, with a repeat read and a poly-A read whose seed slots / minimizer
lanes overflow and go through the overflow-rescue pass. SAM byte-identical
to ma_tpu on both of its reference paths."""
import importlib
import io

import numpy as np
import pytest
import torch


# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)


def _fixture(pkg="ma_tpu_torch"):
    """The pack and reads as objects of package `pkg` (ma_tpu_torch or
    ma_tpu), from the same numpy draws."""
    nucseq = importlib.import_module(pkg + ".containers.nucseq")
    NucSeq, decode_seq, revcomp_codes = nucseq.NucSeq, nucseq.decode_seq, nucseq.revcomp_codes
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    rng = np.random.default_rng(2024)
    a = rng.integers(0, 4, 40_000).astype(np.uint8)
    a[20_000:20_420] = np.tile(rng.integers(0, 4, 7), 60).astype(np.uint8)
    b = rng.integers(0, 4, 30_000).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrA", a)
    pack.append("chrB", b)
    reads = []
    for i in range(22):
        src = a if i % 3 else b
        p = int(rng.integers(0, len(src) - 150))
        codes = src[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.02)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        if i == 4:
            codes[[10, 11, 90]] = 4
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"r{i}"))
    reads.append(NucSeq.from_str(decode_seq(a[20_330:20_480].copy()), name="repeat"))
    reads.append(NucSeq.from_str("A" * 150, name="polyA"))
    return pack, reads


@pytest.fixture(scope="module")
def port():
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack, reads = _fixture()
    al = Aligner(pack, device="cpu")
    al.pset.set("Seeding Technique", "minimizers")
    out = io.StringIO()
    al.align_to_sam(iter(reads), out, batch_size=32, cmd="ma_tpu")
    return al, out.getvalue()


def test_port_rescues_overflow_reads(port):
    al, sam = port
    assert al.n_overflow_reads >= 2
    assert al.n_rescued_reads == al.n_overflow_reads
    assert "\nrepeat\t" in sam


@pytest.mark.parametrize("path", ["default", "fused_native"])
def test_sam_identical_to_ma_tpu(port, path, monkeypatch):
    jax = pytest.importorskip("jax")
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.pipeline.aligner import Aligner

    if path == "fused_native":
        monkeypatch.setenv("MA_TPU_DP", "fused")
        monkeypatch.setenv("MA_TPU_FINISH", "native")
    # a fresh compilation cache per run: ma_tpu's jitted device stage can
    # replay a program compiled for another run's index in this process
    jax.clear_caches()
    pack, reads = _fixture("ma_tpu")
    al = Aligner(pack, FMDIndex.build(pack))
    al.pset.set("Seeding Technique", "minimizers")
    out = io.StringIO()
    al.align_to_sam(iter(reads), out, batch_size=32)
    assert al.n_rescued_reads == port[0].n_rescued_reads
    assert port[1] == out.getvalue()


@pytest.mark.parametrize("preset", ["Default", "Illumina"])
def test_fmd_rescue_sam_identical_to_ma_tpu(preset, monkeypatch):
    """The same fixture through FMD seeding (maxSpan, SMEMs): reads that
    overflow re-align through the cap_boost'ed FMD device stage, and the SAM
    equals ma_tpu's under MA_TPU_DP=fused MA_TPU_FINISH=native."""
    jax = pytest.importorskip("jax")
    from ma_tpu.index.fmd_index import FMDIndex as JFMDIndex
    from ma_tpu.pipeline.aligner import Aligner as JAligner
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.pipeline.aligner import Aligner

    def params(pkg):
        mgr = importlib.import_module(pkg + ".config.parameters").ParameterSetManager()
        mgr.set_selected(preset)
        return mgr

    pack, reads = _fixture()
    al = Aligner(pack, params("ma_tpu_torch"), device="cpu", fmd=FMDIndex.build(pack))
    port = io.StringIO()
    al.align_to_sam(iter(reads), port, batch_size=32, cmd="ma_tpu")
    assert al.n_overflow_reads >= 1 and al.n_rescued_reads == al.n_overflow_reads

    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    jax.clear_caches()
    try:
        jpack, jreads = _fixture("ma_tpu")
        jal = JAligner(jpack, JFMDIndex.build(jpack), params("ma_tpu"))
        want = io.StringIO()
        jal.align_to_sam(iter(jreads), want, batch_size=32)
    finally:
        jax.clear_caches()
    assert jal.n_rescued_reads == al.n_rescued_reads
    assert port.getvalue() == want.getvalue()
