"""Share of the FMD state machine's lane steps spent on live reads: 100 x
the counter `fmd live lane steps` over `fmd lane steps` (B x steps) of the
tracer the harness installed. An upper bound on the useful lanes: the live
reads are counted at each host check (every 16 steps), so a read that
finishes between two checks counts as live to the next."""
READS = ("counters",)


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
    c = counters()
    live, lanes = c.get("fmd live lane steps"), c.get("fmd lane steps")
    if live is None or not lanes:
        return None
    return 100.0 * live / lanes
