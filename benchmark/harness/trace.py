"""What a traced run reads: the program's stage spans, the device's
operations from torch.profiler, and the inputs of kernels C and D.

All times are in seconds of `time.perf_counter()`. The profiler's
timestamps are epoch nanoseconds; they are moved onto the perf_counter
clock by the offset taken at the window's start.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from ma_tpu_torch.utils.profile import AnalyzeRuntimes

COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 160  # of a device operation's name in the breakdown


class SpanRecorder(AnalyzeRuntimes):
    """The program's stage timer, keeping each stage's (name, start, end)."""

    def __init__(self) -> None:
        super().__init__()
        self.spans: list = []

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.append((stage, t0, t1))
            self.register(stage, t1 - t0)


class LaunchRecorder:
    """Keeps, for each launch of a kernel, the inputs its work is counted
    from: a device copy of the per-problem lengths and the launch's sizes.
    `lens_arg` is the index of the [P, k] int32 lengths tensor among the
    launch's arguments, `sizes` the indices of its int sizes."""

    def __init__(self, kernel, lens_arg: int, sizes: tuple) -> None:
        self.kernel = kernel
        self.lens_arg = lens_arg
        self.sizes = sizes
        self.launches: list = []
        self._orig = kernel.launch

    def __enter__(self):
        def launch(*args, **kw):
            self._orig(*args, **kw)
            self.launches.append((args[self.lens_arg].clone(),
                                  tuple(int(args[i]) for i in self.sizes)))
        self.kernel.launch = launch
        return self

    def __exit__(self, *exc):
        del self.kernel.launch  # the class's method again

    def host(self) -> list:
        return [(t.cpu().numpy(), s) for t, s in self.launches]


def device_events(prof, offset_s: float) -> list:
    """[(start, end, name)] of every device operation the profiler saw,
    sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns() * 1e-9 + offset_s
        out.append((s, s + e.duration_ns() * 1e-9, e.name()))
    out.sort()
    return out


def merge(intervals) -> list:
    """Union of [(start, end)] as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def union_s(intervals, lo: float, hi: float) -> float:
    return float(sum(e - s for s, e in merge(clip(intervals, lo, hi))))


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


class Stages:
    """The innermost program stage at any time, for many times at once:
    spans nest, so the innermost one holding t is the latest-starting span
    at or before t, or the nearest of its enclosing spans still open."""

    def __init__(self, spans) -> None:
        spans = sorted(spans, key=lambda x: (x[1], -x[2]))
        self.names = [n for n, _, _ in spans]
        self.starts = np.asarray([s for _, s, _ in spans], np.float64)
        self.ends = [e for _, _, e in spans]
        self.parent = []
        stack: list = []
        for i, (_, s, e) in enumerate(spans):
            while stack and self.ends[stack[-1]] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, times) -> list:
        out = []
        for t, j in zip(times, np.searchsorted(self.starts, times, side="right") - 1):
            while j >= 0 and self.ends[j] < t:
                j = self.parent[j]
            out.append(self.names[j] if j >= 0 else "outside any program stage")
        return out


def breakdown(ctx: dict, top: int = 10) -> dict:
    """The device operations with most time, and the idle time between
    them summed by the program stage the host was in."""
    lo, hi = ctx["window"]
    by_op: dict = {}
    for s, e, name in ctx["device"]:
        if e > lo and s < hi:
            name = name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + min(e, hi) - max(s, lo)
    busy = merge((s, e) for s, e, _ in ctx["device"])
    gaps, prev = [], lo
    for s, e in clip(busy, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    by_stage: dict = {}
    names = Stages(ctx["spans"]).at(np.asarray([0.5 * (s + e) for s, e in gaps]))
    for (s, e), name in zip(gaps, names):
        by_stage[name] = by_stage.get(name, 0.0) + e - s
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_stage)}


def stage_union_s(ctx: dict, match) -> float:
    lo, hi = ctx["window"]
    return union_s([(s, e) for name, s, e in ctx["spans"] if match(name)], lo, hi)


def kernel_time_s(ctx: dict, needle: str) -> tuple:
    """(device seconds, count) of the kernels whose name holds `needle`,
    inside the window."""
    lo, hi = ctx["window"]
    sel = [(s, e) for s, e, name in ctx["device"] if needle in name and e > lo and s < hi]
    return float(sum(e - s for s, e in sel)), len(sel)


def lens_columns(lens: np.ndarray) -> tuple:
    return lens[:, 0], lens[:, 1], lens[:, 2]
