"""Long reads through ma_tpu_torch on the CPU: the PacBio preset with
minimizers and small inversions, from Aligner(device="cpu").align_to_sam
to SAM byte-identical to ma_tpu's under its reference setting
(MA_TPU_DP=fused, MA_TPU_FINISH=native), which takes the Python NW path for
these batches; the chunked long extension against ma_tpu's and a monolithic
DP; the fused bucket edge past the fused ladder; the Python path against the
native path on short reads; and no jax on the long-read path."""
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

# `fixture(pkg)` and `params(pkg)` build objects of package `pkg`
# (ma_tpu_torch or ma_tpu) from the same numpy draws
FIXTURE = """
import importlib
import numpy as np

def simulate(rng, genome, p, L, err):
    out, i = [], p
    while len(out) < L:
        r = rng.random()
        if r < err * 0.4:
            out.append(int(rng.integers(0, 4)))
            continue
        if r < err * 0.8:
            i += 1
            continue
        c = int(genome[i])
        if r < err:
            c = (c + int(rng.integers(1, 4))) % 4
        out.append(c)
        i += 1
    return np.asarray(out, np.uint8)

def fixture(pkg="ma_tpu_torch"):
    nucseq = importlib.import_module(pkg + ".containers.nucseq")
    NucSeq, decode_seq, revcomp_codes = nucseq.NucSeq, nucseq.decode_seq, nucseq.revcomp_codes
    Pack = importlib.import_module(pkg + ".containers.pack").Pack
    rng = np.random.default_rng(31)
    G = 100_000
    genome = rng.integers(0, 4, size=G).astype(np.uint8)
    pack = Pack.empty()
    pack.append("chrL", genome)
    reads = []
    for i, L in enumerate((2500, 2200, 3000, 2600)):
        p = int(rng.integers(0, G - 2 * L))
        codes = simulate(rng, genome, p, L, 0.05)
        if i == 1:  # a 400-base low-identity stretch: a seedless gap > 256 bases
            s = codes[1000:1400]
            codes[1000:1400] = np.where(rng.random(400) < 0.35, rng.integers(0, 4, 400), s)
        if i == 2:  # a planted 200-base inversion
            mid = len(codes) // 2
            codes[mid : mid + 200] = revcomp_codes(codes[mid : mid + 200]).copy()
        if i % 2:
            codes = revcomp_codes(codes)
        reads.append(NucSeq.from_str(decode_seq(codes), name=f"L{i}_{p}"))
    return pack, reads

def params(pkg="ma_tpu_torch"):
    mgr = importlib.import_module(pkg + ".config.parameters").ParameterSetManager()
    mgr.set_selected("PacBio")
    mgr.selected.set("Seeding Technique", "minimizers")
    mgr.selected.set("Detect Small Inversions", True)
    return mgr
"""


def _fixture(pkg="ma_tpu_torch"):
    """~100 kbp random genome, four 2.2-3 kb reads at 5% error (40%
    insertions, 40% deletions, 20% substitutions), two reverse complemented;
    read 1 carries a 400-base stretch at 35% substitutions and read 2 a
    200-base inverted stretch."""
    scope: dict = {}
    exec(FIXTURE, scope)
    return scope["fixture"](pkg), scope["params"]


def _port_sam(pack, reads, pset, **kw):
    from ma_tpu_torch.pipeline.aligner import Aligner

    al = Aligner(pack, pset, device="cpu")
    out = io.StringIO()
    assert al.align_to_sam(iter(reads), out, cmd="ma_tpu", **kw) == len(reads)
    return out.getvalue()


@pytest.fixture
def fused_ma_tpu(monkeypatch):
    """ma_tpu under its reference setting; its jit caches are cleared around
    the test so no other test replays a trace made under this setting."""
    jax = pytest.importorskip("jax")
    monkeypatch.setenv("MA_TPU_DP", "fused")
    monkeypatch.setenv("MA_TPU_FINISH", "native")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_long_sam_identical_to_ma_tpu(fused_ma_tpu, monkeypatch):
    from ma_tpu.index.fmd_index import FMDIndex
    from ma_tpu.pipeline.aligner import Aligner as JAligner
    from ma_tpu_torch.pipeline import aligner as TA
    from ma_tpu_torch.pipeline.nw import NWAligner

    (jpack, jreads), params = _fixture("ma_tpu")
    ref = io.StringIO()
    JAligner(jpack, FMDIndex.build(jpack), params=params("ma_tpu")).align_to_sam(iter(jreads), ref)
    (pack, reads), _ = _fixture()

    seen = {"python": 0, "chunked": 0}
    plan_python, chunked = TA.Aligner._plan_python, NWAligner._chunked_ext

    def spy_plan(self, *a):
        seen["python"] += 1
        return plan_python(self, *a)

    def spy_chunked(self, idxs):
        seen["chunked"] += len(idxs)
        return chunked(self, idxs)

    monkeypatch.setattr(TA.Aligner, "_plan_python", spy_plan)
    monkeypatch.setattr(NWAligner, "_chunked_ext", spy_chunked)
    got = _port_sam(pack, reads, params())
    assert seen["python"] == 1 and seen["chunked"] >= 2
    assert got == ref.getvalue()
    recs = [r.split("\t") for r in got.splitlines() if not r.startswith("@")]
    # the inversion: a supplementary record with MAPQ 0 on the other strand
    assert any(f[0].startswith("L2_") and int(f[1]) & 2048 and f[4] == "0" for f in recs)


def test_python_path_matches_native_path(monkeypatch):
    """Short reads: forcing the Python planner and assembler gives the
    native path's SAM."""
    from ma_tpu_torch.pipeline import aligner as TA
    from test_torch_slice import _fixture as short_fixture

    pack, reads = short_fixture()
    pset = TA.ParameterSetManager()
    pset.selected.set("Seeding Technique", "minimizers")
    native = _port_sam(pack, reads, pset, batch_size=24)
    monkeypatch.setattr(TA.Aligner, "_plan_native", lambda self, *a: None)
    assert _port_sam(pack, reads, pset, batch_size=24) == native


def _nw_pair(genome, q):
    """The two packages' NWAligner over one genome and a one-read batch."""
    import jax.numpy as jnp
    from ma_tpu.containers.pack import Pack as JPack
    from ma_tpu.pipeline.nw import NWAligner as JNW
    from ma_tpu_torch.containers.nucseq import revcomp_codes
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.pipeline.nw import NWAligner as TNW
    from ma_tpu_torch.pipeline.nw import NWConfig

    jpack, pack = JPack.empty(), Pack.empty()
    jpack.append("c", genome)
    pack.append("c", genome)
    text = np.concatenate([genome, revcomp_codes(genome)])
    jnw = JNW(jpack, text_dev=jnp.asarray(text), seqs_dev=jnp.asarray(q[None]))
    tnw = TNW(pack, NWConfig(), torch.as_tensor(text), torch.as_tensor(q[None]), text,
              q[None], None)
    return jnw, tnw


def _same_problem(jnw, tnw, pi):
    jp, tp = jnw._problems[pi], tnw._problems[pi]
    assert (tp.max_i, tp.max_j, tp.cigar) == (jp.max_i, jp.max_j, jp.cigar)
    return tp


def test_chunked_ext_vs_ma_tpu_and_monolithic(fused_ma_tpu):
    """A ~1.5 kb clean extension through the chunked path: the same cigar
    and end cell as ma_tpu's, and the end cell of the monolithic row DP."""
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_rows import banded_align_rows

    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, size=20_000).astype(np.uint8)
    q = genome[5_000:6_500].copy()
    for j in np.nonzero(rng.random(len(q)) < 0.02)[0]:
        q[j] = (q[j] + 1) % 4
    jnw, tnw = _nw_pair(genome, q)
    for nw in (jnw, tnw):
        pi = nw._new_problem(*((None, None) if nw is jnw else ()), band=512, is_global=False,
                             q_off=0, q_len=len(q), t_start=5_000, t_len=2_100)
        nw._chunked_ext([pi])
    p = _same_problem(jnw, tnw, pi)
    assert p.max_i == len(q) - 1
    res = banded_align_rows(torch.as_tensor(q[None]), torch.as_tensor(genome[None, 5_000:7_100]),
                            torch.tensor([len(q)]), torch.tensor([2_100]), torch.tensor([512]),
                            DPParams(), 200, False)
    assert (int(res.max_i[0]), int(res.max_j[0])) == (p.max_i, p.max_j)
    assert sum(ln for op, ln in p.cigar if op != 2) == p.max_i + 1
    assert sum(ln for op, ln in p.cigar if op != 1) == p.max_j + 1


def test_chunked_ext_stops_on_dropped_last_row(fused_ma_tpu):
    """A chunk whose last row holds no undropped cell (lastrow_max is
    NEG_INF) stops the extension whatever lastrow_arg holds there (ma_tpu's
    Pallas kernel leaves a lane of its first tile, the port 0): the same
    cigar and end cell as ma_tpu's. Z-drop 3 drops a row at its first
    mismatch: the ksw2 rule tolerates a pure gap by 2 per base, so at
    z-drop 200 a 256-row chunk of unrelated sequence rarely drops."""
    from ma_tpu_torch.ops.dp import NEG_INF, DPParams, _dp_desc_runs_fused

    rng = np.random.default_rng(12)
    genome = rng.integers(0, 4, size=20_000).astype(np.uint8)
    q = genome[5_000:5_700].copy()
    q[300:] = rng.integers(0, 4, len(q) - 300)  # unrelated after 300 bases
    jnw, tnw = _nw_pair(genome, q)
    for nw in (jnw, tnw):
        nw.cfg.zdrop = 3
        pi = nw._new_problem(*((None, None) if nw is jnw else ()), band=512, is_global=False,
                             q_off=0, q_len=len(q), t_start=5_000, t_len=1_300)
        nw._chunked_ext([pi])
    assert _same_problem(jnw, tnw, pi).max_i == 299
    # the second chunk (query 256..511, entered at the first chunk's last-row cell)
    desc = torch.tensor([[0], [256], [256], [0], [5_256], [768], [0], [512]], dtype=torch.int32)
    comb, _ = _dp_desc_runs_fused(tnw.text_dev, tnw.seqs_dev, desc, M=256, N=768,
                                  params=DPParams(), zdrop=3, is_global=False,
                                  tb_last=torch.ones(1, dtype=torch.int32))
    assert int(comb[6, 0]) == NEG_INF and int(comb[4, 0]) == 1


def test_fused_bucket_past_the_fused_ladder(fused_ma_tpu):
    """An extension with m = 256, n = 769 leaves the fused buckets for the
    (256, 4096) bucket, which ma_tpu still gives the fused kernel
    (M <= 256); the port runs kernel C as wide as the reference needs:
    the same cigar and end cell."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=5_000).astype(np.uint8)
    q = genome[1_000:1_256].copy()
    q[rng.random(256) < 0.03] = 0
    jnw, tnw = _nw_pair(genome, q)
    for nw in (jnw, tnw):
        pi = nw._new_problem(*((None, None) if nw is jnw else ()), band=512, is_global=False,
                             q_off=0, q_len=256, t_start=1_000, t_len=769)
        assert nw._bucket_shape_fused(256, 769) == (256, 4096)
        nw.dispatch_batches()
        nw.collect_batches()
    assert _same_problem(jnw, tnw, pi).max_i == 255


def test_non_fused_bucket_through_kernel_d(fused_ma_tpu):
    """A global problem past the fused buckets (about 300 x 300, which the
    planner makes only under a Maximal Gap Size of 300 or more) goes to
    kernel D + the traceback kernel; its runs exceed MAX_RUNS, so the cigar
    is decoded from the ops row: the same cigar as ma_tpu's."""
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=5_000).astype(np.uint8)
    q = genome[1_000:1_300].copy()
    r = rng.random(300)
    q = np.insert(q[r >= 0.07], np.flatnonzero(r[r >= 0.07] > 0.93),
                  rng.integers(0, 4, int((r[r >= 0.07] > 0.93).sum()))).astype(np.uint8)
    jnw, tnw = _nw_pair(genome, q)
    for nw in (jnw, tnw):
        pi = nw._new_problem(*((None, None) if nw is jnw else ()), band=40, is_global=True,
                             q_off=0, q_len=len(q), t_start=1_000, t_len=300)
        assert nw._bucket_shape_fused(len(q), 300) == (1024, 768)
        nw.dispatch_batches()
        nw.collect_batches()
    p = _same_problem(jnw, tnw, pi)
    assert len(p.cigar) > 32


def test_long_path_imports_no_jax():
    """The long-read fixture through the port in a fresh interpreter keeps
    jax out of sys.modules (skipped only where the interpreter starts with
    jax)."""
    script = textwrap.dedent("""
        import sys
        if "jax" in sys.modules:
            print("JAX_AT_START")
            raise SystemExit(0)
        import io
        from ma_tpu_torch.pipeline.aligner import Aligner
    """) + FIXTURE + textwrap.dedent("""
        pack, reads = fixture()
        out = io.StringIO()
        Aligner(pack, params(), device="cpu").align_to_sam(iter(reads), out)
        assert sum(not r.startswith("@") for r in out.getvalue().splitlines()) >= len(reads)
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
