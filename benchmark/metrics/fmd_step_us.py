"""Microseconds of host clock per FMD seeding state-machine step: the union
of the program's `seeding` spans inside the window over the counter `fmd
steps` of the tracer the harness installed (the state machine's host checks
included; in the FMD cells every `seeding` span is FMD seeding)."""
from harness import trace

READS = ("spans", "counters")
STAGES = ("seeding",)
COUNTER = "fmd steps"


def counters() -> dict:
    """The counters of the process's tracer; empty where the program has no
    such tracer or none is installed."""
    try:
        from ma_tpu_torch.utils import profile
    except ImportError:
        return {}
    tr = getattr(profile, "current", lambda: None)()
    return dict(getattr(tr, "counters", None) or {})


def read(ctx):
    n = counters().get(COUNTER)
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not n or not s:
        return None
    return 1e6 * s / n
