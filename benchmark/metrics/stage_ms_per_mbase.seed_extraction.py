"""Milliseconds per Mbase aligned in FMD seed extraction (extract_seeds with
its sampled-SA walk, sa_lookup), inside the device stage: the union of the
program's `seed extraction` spans inside the window."""
from harness import trace

READS = ("spans",)
STAGES = ("seed extraction",)


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
