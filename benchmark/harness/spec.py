"""BENCHMARK.json and the files it names, found by name.

A cell names its configuration and its traffic; each lives in a file of its
own (`configs/<config>.json`, `traffic/<traffic>.json`), the compared
numbers' limits in `limits/<cell>.json`, and each per-layer metric's reader
in `metrics/<metric>.py`. Adding a configuration, a traffic mix, a metric or
a cell is adding files and entries: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(rel: str, root: Path = ROOT) -> dict:
    return json.loads((root / rel).read_text())


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return read_json(config_entry(bench, name)["file"], root)


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def limits_file(cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "limits" / f"{cell}.json").read_text())


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of a per-layer metric: `READS` (the trace data it
    needs) and `read(ctx)`, which returns a number or None."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") the cell
    reports: those without a workloads list, and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
