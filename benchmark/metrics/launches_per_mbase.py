"""CUDA kernel launches the profiler saw in the window, per Mbase aligned."""
from harness import trace

READS = ("device",)


def read(ctx):
    lo, hi = ctx["window"]
    n = sum(1 for s, e, name in ctx["device"] if trace.is_kernel(name) and e > lo and s < hi)
    if not n or not ctx["mbases"]:
        return None
    return n / ctx["mbases"]
