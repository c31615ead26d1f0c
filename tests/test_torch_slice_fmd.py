"""The FMD seeding slice end to end on the CPU: ma_tpu_torch's
Aligner(device="cpu").align_to_sam gives SAM byte-identical to ma_tpu's
under its reference setting (MA_TPU_DP=fused MA_TPU_FINISH=native) for
maxSpan (the Default preset), SMEMs (Illumina) and MEMs, against ma_tpu
with MA_TPU_DP_V2 unset and set to 1 (ma_tpu then runs its fused DP as
_kernel_v2; the port, which reads no such variable, makes one SAM per
technique); and the FMD path imports no jax."""
import importlib
import io
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_slice import FIXTURE, _fixture

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

# technique -> (preset, technique set on top of it)
CASES = {"maxSpan": ("Default", None), "SMEMs": ("Illumina", None), "MEMs": ("Default", "MEMs")}


def _params(technique, pkg="ma_tpu_torch"):
    ParameterSetManager = importlib.import_module(pkg + ".config.parameters").ParameterSetManager
    preset, override = CASES[technique]
    mgr = ParameterSetManager()
    mgr.set_selected(preset)
    if override:
        mgr.selected.set("Seeding Technique", override)
    assert mgr.selected.get("Seeding Technique") == technique
    return mgr


@pytest.fixture(scope="module")
def port_sams():
    """The port's SAM per technique, with one FMD index."""
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack, reads = _fixture()
    fmd = FMDIndex.build(pack)
    out = {}
    for technique in CASES:
        al = Aligner(pack, _params(technique), device="cpu", fmd=fmd)
        buf = io.StringIO()
        assert al.align_to_sam(iter(reads), buf, batch_size=24, cmd="ma_tpu") == len(reads)
        out[technique] = buf.getvalue()
    return out


@pytest.mark.parametrize("v2", ["0", "1"])
@pytest.mark.parametrize("technique", list(CASES))
def test_sam_identical_to_ma_tpu(port_sams, technique, v2, monkeypatch):
    jax = pytest.importorskip("jax")
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.ops import dp_fused as JF
    from ma_tpu.pipeline.aligner import Aligner

    traced = []
    orig = JF._kernel_v2

    def counted(*args, **kw):
        traced.append(kw["N"])
        return orig(*args, **kw)

    monkeypatch.setattr(JF, "_kernel_v2", counted)
    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    monkeypatch.setenv("MA_TPU_DP_V2", v2)
    # ma_tpu reads MA_TPU_DP / MA_TPU_DP_V2 while tracing: fresh caches
    jax.clear_caches()
    try:
        pack, reads = _fixture("ma_tpu")
        al = Aligner(pack, FMDIndex.build(pack), _params(technique, "ma_tpu"))
        out = io.StringIO()
        al.align_to_sam(iter(reads), out, batch_size=24)
    finally:
        jax.clear_caches()
    sam = out.getvalue()
    assert sam.count("\n") > len(reads)
    assert bool(traced) == (v2 == "1")
    assert port_sams[technique] == sam


def test_fmd_slice_imports_no_jax():
    """maxSpan and SMEMs through the port in a fresh interpreter: jax stays
    out of sys.modules (skipped only where the interpreter starts with
    jax)."""
    script = textwrap.dedent("""
        import sys
        if "jax" in sys.modules:
            print("JAX_AT_START")
            raise SystemExit(0)
        import io
        from ma_tpu_torch.config.parameters import ParameterSetManager
        from ma_tpu_torch.pipeline.aligner import Aligner
    """) + FIXTURE + textwrap.dedent("""
        pack, reads = fixture()
        for preset in ("Default", "Illumina"):
            mgr = ParameterSetManager()
            mgr.set_selected(preset)
            al = Aligner(pack, mgr, device="cpu")
            out = io.StringIO()
            al.align_to_sam(iter(reads[:8]), out, batch_size=8)
            assert out.getvalue().count("\\n") > 8
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
