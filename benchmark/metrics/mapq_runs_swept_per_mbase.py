"""Runs that mapping quality's overlap test reads per Mbase aligned
(containers/alignment.py `Alignment.overlap`: one merge of the two run
lists, runs of one alignment + runs of the other, once a call whose windows
meet): the counter `mapq runs swept` of the tracer the harness installed.
A program without the counter reports nothing."""
READS = ("counters",)
COUNTER = "mapq runs swept"


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
