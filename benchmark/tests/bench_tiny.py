"""A tiny cell on the CPU for the benchmark's tests: the harness's run with
its configuration, traffic and limits shrunk, the port on device="cpu"."""
from __future__ import annotations

import copy
import json
import sys
import time
import types
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import cell, spec  # noqa: E402

# the tests run in several workers at once: one thread each keeps the CPU
# port's runs from crowding each other out
torch.set_num_threads(1)

GENOME = {"length": 200_000, "contig": "tiny", "repeats": [
    {"name": "a", "families": 1, "copies": 4, "min_len": 2000, "max_len": 2000,
     "divergence": 0.001},
    {"name": "b", "families": 2, "copies": 6, "min_len": 500, "max_len": 800,
     "divergence": 0.005}]}
SIZES = {
    # more donor indels than the cell's, so that a small window holds reads
    # with the 2-5 bp indels a narrowed DP band cannot place
    "se150_default_b4096": dict(pool_reads=2048, batch_size=256,
                                donor={"snp_rate": 0.001, "indel_rate": 0.002,
                                       "indel_len": [1, 5]},
                                judge={"reads": 300, "inside_copies": 100, "longest": 0}),
    "pacbio_ln12k_b256": dict(pool_reads=48, batch_size=64,
                               length={"median": 2500, "sigma": 0.3, "min": 1025, "max": 4000},
                               judge={"reads": 8, "inside_copies": 0, "longest": 2}),
}


def tiny(cell_name: str, seed: int, seconds: float = 2.0, control=None, limits=None):
    """cell.run on a tiny copy of the cell (its configuration and traffic
    files with the genome, pool, batch and sample cut as SIZES says) on the
    CPU. Returns run()'s result."""
    bench = spec.load_benchmark(ROOT)
    w = spec.workload(bench, cell_name)
    cfg = copy.deepcopy(spec.config_file(bench, w["config"]))
    cfg["genome"] = GENOME
    traffic = dict(spec.traffic_file(w["traffic"]), **SIZES[cell_name])
    lim = limits if limits is not None else spec.limits_file(cell_name)
    saved = spec.config_file, spec.traffic_file, spec.limits_file
    spec.config_file = lambda b, n: cfg
    spec.traffic_file = lambda n: traffic
    spec.limits_file = lambda n: lim
    try:
        args = types.SimpleNamespace(workload=cell_name, seed=seed, seconds=seconds, trace=0,
                                     control=control)
        return cell.run(args, bench, time.time(), device="cpu")
    finally:
        spec.config_file, spec.traffic_file, spec.limits_file = saved


def dumps(res) -> str:
    return json.dumps({k: v for k, v in res.items() if k != "breakdown"}, default=str)
