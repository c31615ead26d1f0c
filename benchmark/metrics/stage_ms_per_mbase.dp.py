"""Milliseconds per Mbase aligned in the DP: planning, dispatch and the wait for kernels C / C' (and the
Python NW path's chunked extensions, redo and collect stages): the union
of the program's stage spans of that name inside the window (nested spans
count once)."""
from harness import trace

READS = ("spans",)
STAGES = ("host DP planning", "dp dispatch", "device banded DP + traceback",
          "dp chunked long ext", "dp redo batched")


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES or name.startswith("dp collect"))
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
