#!/usr/bin/env python3
"""Run one cell of the ma_tpu_torch benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic and
limits are found by name from BENCHMARK.json (see benchmark/README.md).
With --trace 0 the last line of standard output is a JSON object with the
cell's end-to-end metrics; with --trace 1 with its per-layer metrics, the
device's busy time and a breakdown. Either way the reference's comparison
decides `correct`, and each number compared is printed beside its limit as
the last lines of standard error and under the key `compared`, last in the
JSON line. Exits non-zero, printing no result, without as many CUDA
devices as the cell asks for, or if a module of jax, jaxlib, flax or the
JAX package ma_tpu is loaded once the window has closed.
"""
import os
import sys
import time


def _process_start() -> float:
    """The epoch time this process started, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROC_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ma_tpu")
# build and kernel caches: fixed directories inside the checkout
CACHE_DIR = ROOT / ".bench_cache"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell of ma_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="run the configuration's named control (parameters that break one "
                         "of its guarantees) in the program's place")
    args = ap.parse_args()

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import cell, spec

    bench = spec.load_benchmark(ROOT)
    want = int(spec.workload(bench, args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"run.py: the cell needs {want} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    res = cell.run(args, bench, PROC_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: modules of jax or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": want,
              "memory_peak_bytes": res["memory_peak_bytes"], "power_limit": power_limit()}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["info"] = {k: res["numbers"][k] for k in sorted(res["numbers"])}
    line["info"].update(window_s=res["window_s"], mbases=res["mbases"], cycles=res["cycles"],
                        batches=res["batches"], host=res["host"])
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in res["compared"]}
    print(f"card: {device['kind']}, power limit {device['power_limit']}", file=sys.stderr)
    for name, v, lim in res["compared"]:
        print(f"compared {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
