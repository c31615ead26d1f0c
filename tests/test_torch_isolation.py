"""The port stands alone: no module of ma_tpu_torch and no line of
chip_smoke.py imports ma_tpu (at any depth, inside functions too), and a
fresh interpreter that imports every module of ma_tpu_torch and aligns a
few reads on the CPU with minimizers, maxSpan and MEMs, or runs the command
line (paired reads, --Sv), has loaded no jax and no ma_tpu module."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "ma_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    """(line, module) of every import statement in the file, nested ones too."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_ma_tpu_import(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod == "ma_tpu" or mod.startswith("ma_tpu.") or mod == "jax"
           or mod.startswith("jax.")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_nested_imports():
    """The scan finds an import inside a function body."""
    src = "def f():\n    from ma_tpu.ops.mem_seeding import mem_seeding\n"
    tree = ast.parse(src)
    found = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert found == ["ma_tpu.ops.mem_seeding"]


SCRIPT = textwrap.dedent("""
    import importlib, io, pkgutil, sys
    import numpy as np
    import ma_tpu_torch
    for m in pkgutil.walk_packages(ma_tpu_torch.__path__, "ma_tpu_torch."):
        importlib.import_module(m.name)
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.containers.nucseq import NucSeq, decode_seq
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.pipeline.aligner import Aligner

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    pack = Pack.empty()
    pack.append("g", genome)
    reads = []
    for i in range(4):
        p = int(rng.integers(0, len(genome) - 150))
        reads.append(NucSeq.from_str(decode_seq(genome[p : p + 150].copy()), name=f"r{i}"))
    for technique in ("minimizers", "maxSpan", "MEMs"):
        mgr = ParameterSetManager()
        mgr.selected.set("Seeding Technique", technique)
        out = io.StringIO()
        assert Aligner(pack, mgr, device="cpu").align_to_sam(iter(reads), out) == 4
        assert out.getvalue().count("\\n") > 4, technique
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("ma_tpu", "jax"))
    print("LOADED", loaded)
""")


def test_port_loads_no_jax_and_no_ma_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-3000:]


CLI_SCRIPT = textwrap.dedent("""
    import runpy, sys
    import numpy as np

    d = sys.argv[1]
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 20_000))
    open(d + "/g.fa", "w").write(">g\\n" + seq + "\\n")
    with open(d + "/r1.fq", "w") as f1, open(d + "/r2.fq", "w") as f2:
        for i, p in enumerate(rng.integers(0, 19_000, 4)):
            p = int(p)
            f1.write(f"@r{i}\\n{seq[p : p + 150]}\\n+\\n{'I' * 150}\\n")
            f2.write(f"@r{i}\\n{seq[p + 250 : p + 400]}\\n+\\n{'I' * 150}\\n")
    donor = seq[:10_000] + seq[10_500:]  # a 500 bp deletion
    with open(d + "/s.fq", "w") as f:
        for i, p in enumerate(range(9_000, 10_000, 100)):
            f.write(f"@s{i}\\n{donor[p : p + 1000]}\\n+\\n{'I' * 1000}\\n")
    for argv in (["--Create_Index", d + "/g.fa," + d + ",idx"],
                 ["-x", d + "/idx", "-i", d + "/r1.fq", "-m", d + "/r2.fq", "-o", d + "/o.sam",
                  "--Device", "cpu"],
                 ["-x", d + "/idx", "-i", d + "/s.fq", "--Sv", "-o", d + "/c.tsv",
                  "--Device", "cpu"]):
        sys.argv = ["ma_tpu_torch"] + argv
        try:
            runpy.run_module("ma_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as ex:
            assert ex.code == 0, ex.code
    assert open(d + "/o.sam").read().count("\\n") == 3 + 8
    assert open(d + "/c.tsv").read().splitlines()[1].startswith("9999\\t10499\\t")
    assert "<svg" in open(d + "/c.tsv.html").read()
    assert "const D = " in open(d + "/c.tsv.view.html").read()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("ma_tpu", "jax"))
    print("LOADED", loaded)
""")


def test_cli_loads_no_jax_and_no_ma_tpu(tmp_path):
    """`python -m ma_tpu_torch` (--Create_Index, then a paired run and an
    --Sv run with --Device cpu) in a fresh interpreter loads no jax and no
    ma_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(tmp_path)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-3000:]
