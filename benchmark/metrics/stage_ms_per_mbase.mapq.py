"""Milliseconds per Mbase aligned in host mapping quality: the union
of the program's stage spans of that name inside the window (nested spans
count once)."""
from harness import trace

READS = ("spans",)
STAGES = ("host mapping quality",)


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
