"""FMD seeding state-machine steps (ops/seeding.py `_run`, one batched
extension of every read a step) per Mbase aligned: the counter `fmd steps`
of the tracer the harness installed for the window."""
READS = ("counters",)
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
    if not n or not ctx["mbases"]:
        return None
    return n / ctx["mbases"]
