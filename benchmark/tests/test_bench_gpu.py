"""On the card: each cell's run prints a last line with its metrics and
`correct` true. Skips without a CUDA device (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from bench_tiny import BENCH_DIR, ROOT
from harness import spec

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    need_card()
    res = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", cell,
                          "--seed", "8589934593", "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    want = spec.cell_metrics(spec.load_benchmark(ROOT), cell,
                             "per_layer" if trace else "end_to_end")
    if not trace:
        assert {m["name"] for m in want} == set(line["metrics"])
    assert line["device"]["platform"] == "gpu"
