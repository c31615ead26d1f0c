"""Kernel C's (csrc/dp_fused.cu) share of its roofline in the window: the sum of
each launch's bound (benchmark/roofline/counts.py, from the launch's own
lengths and band) over the sum of the device time of its launches."""
from harness import trace
from roofline import counts

READS = ("device", "launches")
NEEDLE = "dp_fused_kernel"


def read(ctx):
    launches = ctx["launches"]["dp_fused"]
    t, n = trace.kernel_time_s(ctx, NEEDLE)
    if not launches or not t or n != len(launches):
        return None
    bound = 0.0
    for lens, P, M, N, R in ((ln, *s) for ln, s in launches):
        ql, tl, bd = trace.lens_columns(lens)
        nbytes, ops = counts.dp_fused_work(ql, tl, bd, M, N, R)
        bound += counts.bound_s(nbytes, ops)
    return 100.0 * bound / t
