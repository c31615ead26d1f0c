"""Waits of the host on the device per Mbase aligned: the counter `host
syncs` of the tracer the harness installed (the FMD state machine's checks,
the sampled-SA walk's rounds, the downloads of the packed seed sets and of
the DP results, and the other waits of the align path, each counted where
it waits)."""
READS = ("counters",)
COUNTER = "host syncs"


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
