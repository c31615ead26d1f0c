"""Share of the window in which no operation (kernel or copy) ran on the
device: 100 x (1 - union of the profiler's device intervals / window)."""
from harness import trace

READS = ("device",)


def read(ctx):
    lo, hi = ctx["window"]
    if not ctx["device"] or hi <= lo:
        return None
    return 100.0 * (1.0 - trace.union_s([(s, e) for s, e, _ in ctx["device"]], lo, hi)
                    / (hi - lo))
