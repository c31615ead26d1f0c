"""Pledge-graph runtime — the libs/ms Modular-System core.

A copy of ma_tpu/ms/graph.py, changed only in its imports.

The reference's execution model (reference: libs/ms/inc/ms/module/module.h —
Module :63-122, Pledge :212-727, simultaneousGet :268-396, promiseMe :735;
libs/ms/inc/ms/module/splitter.h — Lock/UnLock/Splitter/Collector;
libs/ms/inc/ms/container/cyclic_queue_container.h): a lazy memoizing
promise graph of compute modules, replicated once per worker thread and
pulled from sink pledges until the volatile sources run dry.

The *hot path* is the batched device pipeline over read batches
(pipeline/), so this runtime serves the reference's orchestration
roles: composing host-side stages (file readers, batch formers, device
dispatch, SAM writing, MSV stage pipelines) into restartable graphs, the
Python-extensibility surface (users add modules without touching the
pipeline), and the per-pledge profiling/race-detection debugging aids.

Kept semantics:
* Module.execute(*inputs) -> output; VolatileModule yields a new value per
  get() and signals EoF with None.
* Pledge.get(): pull deps, run module, memoize; reset() invalidates
  downstream; exec/wait timers per pledge (module.h:425-426,557-577).
* simultaneous_get(sinks, n_threads): one worker per graph replica, loops
  while the graph has volatile modules and sources are not EoF; the first
  exception cancels all workers and is re-raised (module.h:268-396).
* Graph-construction-time detection of thread-unsafe modules shared across
  replicas (module.h:460-477) — raises instead of racing.
* Lock pins a volatile value for one pass; UnLock re-triggers it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence


class Container:
    """Base marker for graph data (container.h:41). Any Python object can
    flow through pledges; this class exists for API familiarity."""


class _Eof:
    """End-of-stream sentinel (the reference's nullptr from a volatile
    module, module.h:88-100). Propagates through pledges without running
    their modules, so None stays available as an ordinary value."""

    def __repr__(self) -> str:  # pragma: no cover
        return "EOF"


EOF = _Eof()


class Module:
    """Compute node (module.h:63). Subclass and implement execute()."""

    #: volatile modules yield a fresh value per get(); None = end of stream
    IS_VOLATILE = False

    def execute(self, *inputs):  # pragma: no cover - abstract
        raise NotImplementedError

    def requires_lock(self) -> bool:
        """Shared modules that are not thread-safe return True
        (module.h:114-117); their pledges serialize on a mutex."""
        return False


class VolatileModule(Module):
    """Stream source (IS_VOLATILE=true modules, module.h:88-100)."""

    IS_VOLATILE = True


class FunctionModule(Module):
    """Wrap a plain callable as a module (PyModule role)."""

    def __init__(self, fn: Callable, name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def execute(self, *inputs):
        return self.fn(*inputs)


class Pledge:
    """Lazy memoizing promise (module.h:212): value of running `module` on
    the values of `deps`. get() pulls, caches; reset() invalidates this and
    all successors."""

    _GRAPH_BUILD_THREAD: Optional[int] = None  # replica being built

    def __init__(
        self,
        module: Optional[Module] = None,
        deps: Sequence["Pledge"] = (),
        value: Any = None,
    ):
        self.module = module
        self.deps = list(deps)
        self._value = value
        self._set = module is None  # value pledges start fulfilled
        self.successors: List["Pledge"] = []
        self.exec_time = 0.0  # xExecTime (module.h:425)
        self.wait_on_lock_time = 0.0  # xWaitOnLockTime (module.h:426)
        self._lock = threading.Lock()
        self._build_thread = Pledge._GRAPH_BUILD_THREAD
        for d in self.deps:
            d._add_successor(self)

    # ------------------------------------------------------------ structure
    def _add_successor(self, succ: "Pledge") -> None:
        """Cross-replica sharing check (module.h:460-477): a pledge built in
        one replica may only be consumed from another if its module is
        thread-safe (requires_lock) or it is a plain value pledge."""
        if (
            succ._build_thread is not None
            and self._build_thread is not None
            and succ._build_thread != self._build_thread
            and self.module is not None
            and not self.module.requires_lock()
        ):
            raise RuntimeError(
                f"pledge of {type(self.module).__name__} is shared across "
                "graph replicas but its module is not lock-protected "
                "(module.h:460-477 race check)"
            )
        self.successors.append(succ)

    def set(self, value: Any) -> None:
        """Fulfill manually (Pledge::set, module.h:632)."""
        self._value = value
        self._set = True

    def reset(self, downstream_only: bool = False) -> None:
        """Invalidate this pledge and everything after it (module.h:641)."""
        if not downstream_only:
            if self.module is not None:
                self._set = False
                self._value = None
        for s in self.successors:
            s._set = False
            s._value = None
            s.reset(downstream_only=True)

    def has_volatile(self) -> bool:
        if self.module is not None and self.module.IS_VOLATILE:
            return True
        return any(d.has_volatile() for d in self.deps)

    def reset_pass(self) -> None:
        """Invalidate this replica's dependency cone for the next streaming
        pass (what the reference gets from UnLock::execute resetting the
        Lock pledge + per-replica pledge ownership, splitter.h:69-101).
        Pledges belonging to other replicas (shared, lock-protected) and
        plain value pledges are left alone; volatile pledges re-execute on
        every get() anyway."""
        seen = set()

        def visit(p: "Pledge"):
            if id(p) in seen:
                return
            seen.add(id(p))
            if p.module is not None and p._build_thread == self._build_thread:
                p._set = False
                p._value = None
            for d in p.deps:
                visit(d)

        visit(self)

    # ------------------------------------------------------------ execution
    def get(self):
        """Pull-evaluate (module.h:674-721)."""
        if self._set and not (self.module is not None and self.module.IS_VOLATILE):
            return self._value
        if self.module is None:
            return self._value
        needs_lock = self.module.requires_lock() or self.module.IS_VOLATILE
        if needs_lock:
            t0 = time.perf_counter()
            self._lock.acquire()
            self.wait_on_lock_time += time.perf_counter() - t0
        try:
            args = [d.get() for d in self.deps]
            if any(a is EOF for a in args):
                # upstream EoF propagates without executing (module.h:690-696)
                self._value = EOF
                self._set = True
                return EOF
            t0 = time.perf_counter()
            out = self.module.execute(*args)
            self.exec_time += time.perf_counter() - t0
            if self.module.IS_VOLATILE and out is None:
                out = EOF  # a dry volatile source (nullptr convention)
            self._value = out
            self._set = True
            return out
        finally:
            if needs_lock:
                self._lock.release()


def promise_me(module: Module, *deps: Pledge) -> Pledge:
    """Type-inferring graph builder (promiseMe, module.h:735)."""
    return Pledge(module, deps)


def value_pledge(value: Any) -> Pledge:
    return Pledge(value=value)


# ------------------------------------------------------------- glue modules
class Lock(Module):
    """Pin a volatile value for one graph pass (splitter.h:29)."""

    def execute(self, x):
        return x

    def requires_lock(self) -> bool:
        return True


class UnLock(VolatileModule):
    """Marks the end of a pass: resets the paired Lock pledge so the next
    pass pulls a fresh volatile value (splitter.h:69)."""

    def __init__(self, locked: Pledge):
        self.locked = locked

    def execute(self, x):
        self.locked.reset()
        return x


class Splitter(VolatileModule):
    """Vector -> stream (splitter.h:104)."""

    def __init__(self, vec: Iterable):
        self._it = iter(vec)
        self._lock = threading.Lock()

    def execute(self):
        with self._lock:
            return next(self._it, None)

    def requires_lock(self) -> bool:
        return True


class Collector(Module):
    """Mutex-protected result gathering (splitter.h:178)."""

    def __init__(self):
        self.collected: List[Any] = []
        self._lock = threading.Lock()

    def execute(self, *xs):
        item = xs if len(xs) > 1 else xs[0]
        with self._lock:
            self.collected.append(item)
        return item  # echo so downstream glue (UnLock) keeps flowing

    def requires_lock(self) -> bool:
        return True


class Join(Module):
    """Tuple-up inputs (splitter.h:224)."""

    def execute(self, *xs):
        return tuple(xs)


class TupleGet(Module):
    """TupleGet<N> (splitter.h:141)."""

    def __init__(self, n: int):
        self.n = n

    def execute(self, t):
        return t[self.n]


class CyclicQueue:
    """Two-level blocking queue of streams (cyclic_queue_container.h:27):
    N workers share M input streams; a worker picks an untouched stream
    first, else a touched one; dry streams are retired; EoF when all dry."""

    def __init__(self, streams: Sequence[Iterable]):
        self._untouched: List[Iterable] = [iter(s) for s in streams]
        self._touched: List[Iterable] = []
        self._lock = threading.Lock()

    def pick(self):
        """QueuePicker (cyclic_queue_modules.h:12): a stream or None=EoF."""
        with self._lock:
            if self._untouched:
                return self._untouched.pop()
            if self._touched:
                return self._touched.pop()
            return None

    def place(self, stream) -> None:
        """QueuePlacer: return a stream that still has items."""
        with self._lock:
            self._touched.append(stream)


class QueuePicker(VolatileModule):
    def __init__(self, queue: CyclicQueue):
        self.queue = queue

    def execute(self):
        while True:
            stream = self.queue.pick()
            if stream is None:
                return None
            item = next(stream, None)
            if item is None:
                continue  # stream dry: retire (don't place back)
            self.queue.place(stream)
            return item

    def requires_lock(self) -> bool:
        return True


# --------------------------------------------------------------- execution
def simultaneous_get(
    sinks: Sequence[Pledge],
    n_threads: Optional[int] = None,
    callback: Optional[Callable[[], bool]] = None,
) -> None:
    """Run the graph to exhaustion (BasePledge::simultaneousGet,
    module.h:268-396): one worker per sink pledge; each loops get()/reset()
    while its subgraph has volatile sources; sinks without volatile sources
    are evaluated once. The first exception cancels all workers and is
    re-raised after join. n_threads=0 runs inline (single-thread mode,
    threadPool.h's 0-thread convention)."""
    errors: List[BaseException] = []
    cancel = threading.Event()

    def run(sink: Pledge) -> None:
        try:
            if not sink.has_volatile():
                sink.get()
                return
            while not cancel.is_set():
                if sink.get() is EOF:
                    break
                sink.reset_pass()
                if callback is not None and callback() is False:
                    break
        except BaseException as e:  # noqa: BLE001 — rethrown below
            errors.append(e)
            cancel.set()

    if n_threads == 0 or len(sinks) == 1:
        for s in sinks:
            run(s)
    else:
        threads = [threading.Thread(target=run, args=(s,)) for s in sinks]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]


def parallel_graph(n: int, setup: Callable[[int], Pledge]) -> List[Pledge]:
    """Build N replica subgraphs (BasePledge::parallelGraph, module.h:386).
    setup(i) builds replica i and returns its sink pledge. During each call
    the build-thread id is pinned so cross-replica sharing of thread-unsafe
    modules raises at construction time."""
    sinks = []
    for i in range(n):
        Pledge._GRAPH_BUILD_THREAD = i
        try:
            sinks.append(setup(i))
        finally:
            Pledge._GRAPH_BUILD_THREAD = None
    return sinks


def analyze_graph_runtimes(sinks: Sequence[Pledge], out=None) -> str:
    """Aggregate per-pledge timers by module type — the analyzeRuntimes
    table (libs/ms/python/analyzeRuntimes.py:4-56)."""
    from ma_tpu_torch.utils.profile import AnalyzeRuntimes

    prof = AnalyzeRuntimes()
    seen = set()

    def visit(p: Pledge):
        if id(p) in seen:
            return
        seen.add(id(p))
        if p.module is not None and (p.exec_time or p.wait_on_lock_time):
            prof.register(type(p.module).__name__, p.exec_time)
            if p.wait_on_lock_time:
                prof.register(
                    f"{type(p.module).__name__} [lock wait]", p.wait_on_lock_time
                )
        for d in p.deps:
            visit(d)

    for s in sinks:
        visit(s)
    return prof.analyze(out)
