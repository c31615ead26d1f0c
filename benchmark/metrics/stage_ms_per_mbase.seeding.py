"""Milliseconds per Mbase aligned in seeding, inside the device stage (FMD:
max_spanning_seeding / smem_seeding, the state machine's steps and host
checks; minimizers: sketch + lookup, seed_lump, min_length; MEMs: the host
walk): the union of the program's `seeding` spans inside the window."""
from harness import trace

READS = ("spans",)
STAGES = ("seeding",)


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
