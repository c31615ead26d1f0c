"""Milliseconds per Mbase aligned in the device stage's tail: SoC (kernel
A), harmonization (kernel B) and set packing: the union of the program's
`soc`, `harmonization` and `set packing` spans inside the window."""
from harness import trace

READS = ("spans",)
STAGES = ("soc", "harmonization", "set packing")


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
