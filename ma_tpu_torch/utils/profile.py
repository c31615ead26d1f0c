"""Per-stage runtime accounting: the process's tracer.

Re-design of the reference profiling subsystem
(reference: per-pledge exec/wait timers in libs/ms/inc/ms/module/module.h
:425-426,557-577,698-709, aggregated into a runtime/ratio table by
libs/ms/python/analyzeRuntimes.py:4-56).

Pledges don't exist here; the unit of accounting is a pipeline stage
(device seeding program, DP bucket solve, host assembly, ...). Timers are
wall-clock and include device time because callers block on results.

One `AnalyzeRuntimes` at a time is the process's tracer (`install`;
`Aligner.profiler` reads and sets it). Code below the Aligner opens spans
(`span`, `batch`) and adds to counters (`count`, `host_sync`) through the
helpers at the end of this module; with no tracer installed each returns
after one None check. Each span is timed by the tracer's `time()` (the
table's sums) and recorded besides, on a path `time()` does not take, as a
`Span`: name, start and end on `time.perf_counter`, its parent span, and
the batch it ran in (the ordinal of `Aligner.align_to_sam`'s batches). On a
CUDA device each span also records a CUDA event at entry and at exit on the
current stream; they are turned into times on the same clock only when the
tracer is read (`device_intervals`, `analyze`), so a stage's device time is
its own and not that of the stage that waits for it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

HOST_SYNCS = "host syncs"


class Span:
    """One traced span: `parent` is the index of the enclosing span in the
    tracer's `records` (-1 at the top), `batch` the batch ordinal (-1 outside
    a batch), `events` its CUDA events at entry and exit (None off a CUDA
    device, or once read), `device` their (start, end) on the perf_counter
    clock, once read."""

    __slots__ = ("name", "start", "end", "parent", "batch", "events", "device")

    def __init__(self, name: str, start: float, parent: int, batch: int, events) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.parent = parent
        self.batch = batch
        self.events = events
        self.device: Optional[Tuple[float, float]] = None


class AnalyzeRuntimes:
    """Collects (stage -> accumulated seconds, count), the spans with their
    parents, batches and device intervals, and named counters; prints the
    analyzeRuntimes-style table."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.records: List[Span] = []
        # (batch, perf_counter_ns, time_ns) at the start of each batch
        self.clocks: List[Tuple[int, int, int]] = []
        self.batch = -1  # the batch open now
        self._batches = 0
        self._open: List[int] = []
        self._device = None  # the CUDA device whose stream the events go on
        self._anchor = None  # (CUDA event, perf_counter seconds), taken together

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

    def add(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # ------------------------------------------------------- the span records
    def attach(self, device) -> None:
        """Take the device clock's anchor on a CUDA device: a synchronize,
        then an event, then perf_counter. Once per tracer."""
        import torch

        dev = torch.device(device) if device is not None else None
        if self._anchor is not None or dev is None or dev.type != "cuda":
            return
        torch.cuda.synchronize(dev)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        self._anchor = (ev, time.perf_counter())
        self._device = dev

    def _event(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def _enter(self, name: str) -> Span:
        events = [self._event()] if self._device is not None else None
        sp = Span(name, time.perf_counter(), self._open[-1] if self._open else -1,
                  self.batch, events)
        self._open.append(len(self.records))
        self.records.append(sp)
        return sp

    def _exit(self, sp: Span) -> None:
        sp.end = time.perf_counter()
        if sp.events is not None:
            sp.events.append(self._event())
        self._open.pop()

    def next_batch(self) -> None:
        self.batch = self._batches
        self._batches += 1
        self.clocks.append((self.batch, time.perf_counter_ns(), time.time_ns()))

    def device_intervals(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of each closed span's device interval on the
        perf_counter clock: when the stream reached the span's entry and its
        exit. Synchronizes the device once; empty off a CUDA device."""
        if self._anchor is None:
            return []
        import torch

        todo = [sp for sp in self.records if sp.events is not None and len(sp.events) == 2]
        if todo:
            torch.cuda.synchronize(self._device)
            ev0, pc0 = self._anchor
            for sp in todo:
                a, b = sp.events
                sp.device = (pc0 + 1e-3 * ev0.elapsed_time(a), pc0 + 1e-3 * ev0.elapsed_time(b))
                sp.events = None
        return [(sp.name, *sp.device) for sp in self.records if sp.device is not None]

    def self_times(self) -> Dict[str, float]:
        """Each stage's time less the part its recorded child spans cover."""
        child: Dict[str, float] = {}
        for sp in self.records:
            if sp.parent >= 0 and sp.end is not None:
                name = self.records[sp.parent].name
                child[name] = child.get(name, 0.0) + sp.end - sp.start
        return {k: max(0.0, v - child.get(k, 0.0)) for k, v in self.times.items()}

    # ------------------------------------------------------------- the table
    def rows(self) -> List[Tuple[str, float, int, float]]:
        """(stage, seconds, calls, ratio): the ratio is the stage's self time
        over the sum of self times, its share of the traced time (its
        seconds' share where no span nests in another)."""
        own = self.self_times()
        total = sum(own.values()) or 1.0
        return sorted(
            (
                (name, secs, self.counts[name], 100.0 * own[name] / total)
                for name, secs in self.times.items()
            ),
            key=lambda r: -r[1],
        )

    def analyze(self, out=None) -> str:
        """Print the table (AnalyzeRuntimes.analyze, analyzeRuntimes.py:23-56):
        per stage its host time, self time, device time (the sum of its
        spans' device intervals; blank off a CUDA device), calls and ratio,
        then the counters."""
        own = self.self_times()
        dev: Dict[str, float] = {}
        for name, s, e in self.device_intervals():
            dev[name] = dev.get(name, 0.0) + e - s
        lines = [f"{'stage':<28}{'runtime [s]':>12}{'self [s]':>10}{'device [s]':>12}"
                 f"{'calls':>8}{'ratio [%]':>11}"]
        for name, secs, count, ratio in self.rows():
            d = f"{dev[name]:>12.3f}" if name in dev else " " * 12
            lines.append(f"{name:<28}{secs:>12.3f}{own[name]:>10.3f}{d}{count:>8}{ratio:>11.1f}")
        if self.counters:
            lines.append(f"{'counter':<28}{'value':>12}")
            for name in sorted(self.counters):
                lines.append(f"{name:<28}{self.counters[name]:>12}")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


# ---------------------------------------------------------------- the tracer
_tracer: Optional[AnalyzeRuntimes] = None
_NULL = contextlib.nullcontext()


def current() -> Optional[AnalyzeRuntimes]:
    """The process's tracer, or None."""
    return _tracer


def install(tracer: Optional[AnalyzeRuntimes], device=None) -> None:
    """Make `tracer` the process's tracer (None: no tracing). On a CUDA
    `device` its spans also record device events."""
    global _tracer
    _tracer = tracer
    if tracer is not None:
        tracer.attach(device)


@contextlib.contextmanager
def _traced(tr: AnalyzeRuntimes, name: str):
    sp = tr._enter(name)
    try:
        with tr.time(name):
            yield
    finally:
        tr._exit(sp)


@contextlib.contextmanager
def _batch(tr: AnalyzeRuntimes):
    tr.next_batch()
    try:
        with _traced(tr, "batch"):
            yield
    finally:
        tr.batch = -1


def stage_timer(profiler: Optional[AnalyzeRuntimes], stage: str):
    """A span of `profiler`; a no-op when it is None."""
    if profiler is None:
        return _NULL
    return _traced(profiler, stage)


def span(name: str):
    """A span of the process's tracer; a no-op without one."""
    return stage_timer(_tracer, name)


def batch():
    """The span `batch` of the next batch ordinal; a no-op without a tracer."""
    tr = _tracer
    if tr is None:
        return _NULL
    return _batch(tr)


def tracing() -> bool:
    return _tracer is not None


def count(counter: str, n: int = 1) -> None:
    tr = _tracer
    if tr is None:
        return
    tr.add(counter, n)


def host_sync(n: int = 1) -> None:
    """Counts `n` waits of the host on the device; every such site of the
    align path calls this just before it waits."""
    tr = _tracer
    if tr is None:
        return
    tr.add(HOST_SYNCS, n)
