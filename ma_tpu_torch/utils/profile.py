"""Per-stage runtime accounting.

Re-design of the reference profiling subsystem
(reference: per-pledge exec/wait timers in libs/ms/inc/ms/module/module.h
:425-426,557-577,698-709, aggregated into a runtime/ratio table by
libs/ms/python/analyzeRuntimes.py:4-56).

Pledges don't exist here; the unit of accounting is a pipeline stage
(device seeding program, DP bucket solve, host assembly, ...). Timers are
wall-clock and include device time because callers block on results.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple


class AnalyzeRuntimes:
    """Collects (stage -> accumulated seconds, count) and prints the
    analyzeRuntimes-style table."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def register(self, stage: str, seconds: float) -> None:
        self.times[stage] = self.times.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.register(stage, time.perf_counter() - t0)

    def rows(self) -> List[Tuple[str, float, int, float]]:
        total = sum(self.times.values()) or 1.0
        return sorted(
            (
                (name, secs, self.counts[name], 100.0 * secs / total)
                for name, secs in self.times.items()
            ),
            key=lambda r: -r[1],
        )

    def analyze(self, out=None) -> str:
        """Print the table (AnalyzeRuntimes.analyze, analyzeRuntimes.py:23-56)."""
        lines = [f"{'stage':<28}{'runtime [s]':>12}{'calls':>8}{'ratio [%]':>11}"]
        for name, secs, count, ratio in self.rows():
            lines.append(f"{name:<28}{secs:>12.3f}{count:>8}{ratio:>11.1f}")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


@contextlib.contextmanager
def stage_timer(profiler, stage: str):
    """No-op when profiler is None."""
    if profiler is None:
        yield
    else:
        with profiler.time(stage):
            yield
