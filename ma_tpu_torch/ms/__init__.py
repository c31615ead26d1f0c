"""Modular-System core (libs/ms role): pledge-graph runtime for host-side
orchestration and Python extensibility (a copy of ma_tpu/ms/__init__.py,
changed only in its imports)."""
from ma_tpu_torch.ms.graph import (  # noqa: F401
    EOF,
    Collector,
    Container,
    CyclicQueue,
    FunctionModule,
    Join,
    Lock,
    Module,
    Pledge,
    QueuePicker,
    Splitter,
    TupleGet,
    UnLock,
    VolatileModule,
    analyze_graph_runtimes,
    parallel_graph,
    promise_me,
    simultaneous_get,
    value_pledge,
)
