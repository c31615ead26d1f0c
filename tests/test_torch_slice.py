"""The ported slice end to end on the CPU: ma_tpu_torch's
Aligner(device="cpu").align_to_sam gives SAM byte-identical to ma_tpu's, on
its default CPU path and on the fused-DP + native-finish path; and running
the slice imports no jax."""
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

# `fixture(pkg)` builds the pack and reads of package `pkg` (ma_tpu_torch or
# ma_tpu) from the same numpy draws
FIXTURE = """
import importlib
import numpy as np

def fixture(pkg="ma_tpu_torch"):
    nucseq = importlib.import_module(pkg + ".containers.nucseq")
    NucSeq, decode_seq, revcomp_codes = nucseq.NucSeq, nucseq.decode_seq, nucseq.revcomp_codes
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    rng = np.random.default_rng(99)
    G = 60_000
    genome = rng.integers(0, 4, size=G).astype(np.uint8)
    pack = Pack.empty()
    pack.append("g", genome)
    reads = []
    for i in range(24):
        p = int(rng.integers(0, G - 150))
        codes = genome[p : p + 150].copy()
        for j in np.nonzero(rng.random(150) < 0.02)[0]:
            codes[j] = (codes[j] + rng.integers(1, 4)) % 4
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"r{i}"))
    return pack, reads
"""


def _fixture(pkg="ma_tpu_torch"):
    """60 kbp random genome, 24 x 150 bp reads at 2% substitutions, half
    reverse complemented (the fixture of tests/test_dp_fused.py), as objects
    of package `pkg`."""
    scope: dict = {}
    exec(FIXTURE, scope)
    return scope["fixture"](pkg)


def _port_sam(pack, reads):
    from ma_tpu_torch.pipeline.aligner import Aligner

    al = Aligner(pack, device="cpu")
    al.pset.set("Seeding Technique", "minimizers")
    out = io.StringIO()
    assert al.align_to_sam(iter(reads), out, batch_size=24, cmd="ma_tpu") == len(reads)
    return out.getvalue()


@pytest.fixture(scope="module")
def port_sam():
    return _port_sam(*_fixture())


@pytest.mark.parametrize("path", ["default", "fused_native"])
def test_sam_identical_to_ma_tpu(port_sam, path, monkeypatch):
    pytest.importorskip("jax")
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.pipeline.aligner import Aligner

    if path == "fused_native":
        monkeypatch.setenv("MA_TPU_DP", "fused")
        monkeypatch.setenv("MA_TPU_FINISH", "native")
    pack, reads = _fixture("ma_tpu")
    al = Aligner(pack, FMDIndex.build(pack))
    al.pset.set("Seeding Technique", "minimizers")
    out = io.StringIO()
    al.align_to_sam(iter(reads), out, batch_size=24)
    assert out.getvalue().count("\n") > len(reads)
    assert port_sam == out.getvalue()


def test_slice_imports_no_jax():
    """Run the slice in a fresh interpreter and check that jax stayed out
    of sys.modules (skipped only where the interpreter starts with jax)."""
    script = textwrap.dedent("""
        import sys
        if "jax" in sys.modules:
            print("JAX_AT_START")
            raise SystemExit(0)
        import io
        import ma_tpu_torch
        from ma_tpu_torch.pipeline.aligner import Aligner
    """) + FIXTURE + textwrap.dedent("""
        pack, reads = fixture()
        al = Aligner(pack, device="cpu")
        al.pset.set("Seeding Technique", "minimizers")
        out = io.StringIO()
        al.align_to_sam(iter(reads), out, batch_size=24)
        assert out.getvalue().count("\\n") > len(reads)
        print("JAX_LOADED" if "jax" in sys.modules else "NO_JAX")
        assert not [m for m in sys.modules if m == "ma_tpu" or m.startswith("ma_tpu.")]
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    if "JAX_AT_START" in res.stdout:
        pytest.skip("this interpreter imports jax at start-up")
    assert "NO_JAX" in res.stdout, res.stdout


OPTIONS = {"sdust": ("Minimizers - SDUST Threshold", 20), "paired": ("Use Paired Reads", True),
           "ngmlr": ("Emulate NGMLR's tag output", True)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_port_rejects_options_outside_the_slice(option, monkeypatch):
    """The three options that were outside the slice until paired reads,
    SDUST and NGMLR tags were ported: the port no longer raises on them, and
    its single-end SAM equals ma_tpu's under its reference setting (with
    "Use Paired Reads" set, align_to_sam still writes single-end records,
    as ma_tpu's does)."""
    jax = pytest.importorskip("jax")
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.pipeline.aligner import Aligner as RefAligner
    from ma_tpu_torch.pipeline.aligner import Aligner

    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    name, value = OPTIONS[option]
    sams = []
    for pkg in ("ma_tpu_torch", "ma_tpu"):
        pack, reads = _fixture(pkg)
        if pkg == "ma_tpu":
            # ma_tpu reads MA_TPU_DP while tracing, and a second run may
            # replay a stale program (ROADMAP Queue 3): fresh caches
            jax.clear_caches()
            al = RefAligner(pack, FMDIndex.build(pack))
        else:
            al = Aligner(pack, device="cpu")
        al.pset.set("Seeding Technique", "minimizers")
        al.pset.set(name, value)
        out = io.StringIO()
        try:
            al.align_to_sam(iter(reads), out, batch_size=24, cmd="ma_tpu")
        finally:
            if pkg == "ma_tpu":
                jax.clear_caches()
        sams.append(out.getvalue())
    assert sams[0].count("\n") > len(reads)
    assert sams[0] == sams[1]
