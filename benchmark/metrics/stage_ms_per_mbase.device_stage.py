"""Milliseconds per Mbase aligned in the device stage (Aligner.run_device_stage: seeding, SoC with kernel A,
harmonization with kernel B) and the wait that follows its launch: the union
of the program's stage spans of that name inside the window (nested spans
count once)."""
from harness import trace

READS = ("spans",)
STAGES = ("device seed+soc+harmonize", "device stage wait")


def read(ctx):
    s = trace.stage_union_s(ctx, lambda name: name in STAGES)
    if not s or not ctx["mbases"]:
        return None
    return 1e3 * s / ctx["mbases"]
