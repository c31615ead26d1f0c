"""Pairs of runs that mapping quality's overlap test walks per Mbase aligned
(containers/alignment.py `Alignment.overlap`: runs of one alignment x runs
of the other, once a call): the counter `mapq run pairs` of the tracer the
harness installed."""
READS = ("counters",)
COUNTER = "mapq run pairs"


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
