"""One run of one cell: set-up, warm-up, the measured window, the metrics,
and the reference's comparison.

The window drives one `Aligner.align_to_sam` call over a seeded stream of
reads at the cell's batch size. Its `progress` callback, called after each
batch, notes the time and stops the call at the first batch boundary past
`--seconds` (the call then raises KeyboardInterrupt). The SAM goes to an
in-memory sink; parsing, counting and the comparison run after the window.
"""
from __future__ import annotations

import io
import os
import resource
import time

import numpy as np

from reference import judge as ref_judge
from reference.sam import parse as parse_sam

from . import spec, trace, workload

FMD_TECHNIQUES = ("maxSpan", "SMEMs", "MEMs")


def next_pow2(n: int, lo: int = 32) -> int:
    return max(lo, 1 << max(0, int(n) - 1).bit_length())


def make_params(cfg: dict, control: str | None):
    from ma_tpu_torch.config.parameters import ParameterSetManager

    mgr = ParameterSetManager()
    mgr.set_selected(cfg["preset"])
    overrides = dict(cfg.get("parameters", {}))
    if control:
        overrides.update(cfg["controls"][control])
    for k, v in overrides.items():
        mgr.selected.set(k, v)
    return mgr


class Stream:
    """The pool's reads in order, then again with fresh names (`r<i>.<c>`)
    for as long as the window asks; counts what it hands out."""

    def __init__(self, pool: workload.Pool) -> None:
        from ma_tpu_torch.containers.nucseq import NucSeq

        self._nucseq = NucSeq
        self.pool = pool
        self.yielded = 0
        self.cycles = 0
        self.seqs = [pool.seq_of(i) for i in range(len(pool))]

    def __iter__(self):
        n = len(self.pool)
        i = 0
        while True:
            k = i % n
            self.cycles = i // n
            name = f"r{k}" if self.cycles == 0 else f"r{k}.{self.cycles}"
            self.yielded += 1
            yield self._nucseq(self.seqs[k], name=name)
            i += 1


def steal_s() -> float:
    """Seconds the machine's CPUs were taken by the hypervisor (the steal
    column of /proc/stat, summed over CPUs); 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def host_usage(before, after, steal: float) -> dict:
    """What the host did for this process over the window: CPU seconds in
    user and system mode, context switches given up (voluntary, as a wait on
    the device) and taken (involuntary, preempted), and the machine's steal."""
    return {"user_s": after.ru_utime - before.ru_utime,
            "sys_s": after.ru_stime - before.ru_stime,
            "voluntary_switches": after.ru_nvcsw - before.ru_nvcsw,
            "involuntary_switches": after.ru_nivcsw - before.ru_nivcsw,
            "steal_s": steal, "cpus": len(os.sched_getaffinity(0))}


def warm_reads(pool: workload.Pool, batch_size: int) -> list:
    """From the pool's tail: one flush of each length bucket the traffic
    fills (align_to_sam flushes a bucket of padded length L at batch_size
    reads, or batch_size * 512 / L past 512 bases, at least 32)."""
    from ma_tpu_torch.containers.nucseq import NucSeq

    need: dict = {}
    keys = [next_pow2(x) for x in pool.lens]
    for key in sorted(set(keys)):
        need[key] = batch_size if key <= 512 else max(32, batch_size * 512 // key)
    out = []
    for i in range(len(pool) - 1, -1, -1):
        k = keys[i]
        if need.get(k, 0) > 0:
            out.append(NucSeq(pool.seq_of(i), name=f"w{i}"))
            need[k] -= 1
        if not any(v > 0 for v in need.values()):
            break
    return out


def placed(pool: workload.Pool, primaries: dict, unique: np.ndarray, tol: int):
    """(placed, counted): written unique-origin genome reads whose primary
    lies within `tol` of the read's first forward base on its strand."""
    ok = n = 0
    for k, (pos, rev) in primaries.items():
        if not unique[k]:
            continue
        n += 1
        first = pool.tpos[pool.off[k]]
        ok += abs(pos - 1 - int(first)) <= tol and rev == bool(pool.strand[k])
    return ok, n


def judge_sample(pool, written: list, copy: np.ndarray, jspec: dict, seed: int) -> list:
    """Pool indices to judge, drawn from the seed among the written reads:
    reads inside a planted copy (up to `inside_copies`), reads with a
    planted inversion (up to `inversions`), the `longest` longest, and
    `reads` more at random."""
    rng = workload.rng_for(seed, "judge")
    written = np.asarray(sorted(set(written)), np.int64)
    inside = written[copy[written] >= 0]
    pick = list(rng.permutation(inside)[: int(jspec.get("inside_copies", 0))])
    inverted = written[pool.inv[written] >= 0]
    pick += list(rng.permutation(inverted)[: int(jspec.get("inversions", 0))])
    longest = int(jspec.get("longest", 0))
    if longest:
        pick += list(written[np.argsort(-pool.lens[written], kind="stable")[:longest]])
    rest = np.setdiff1d(written, np.asarray(pick, np.int64))
    pick += list(rng.permutation(rest)[: int(jspec["reads"])])
    return sorted(set(int(x) for x in pick))


def run(args, bench: dict, proc_start: float, device: str = "cuda") -> dict:
    """Run the cell `args.workload` once; returns the result's fields and
    the compared numbers (`compared`: [(name, value, limit)])."""
    import torch

    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.pipeline.aligner import Aligner

    cell = spec.workload(bench, args.workload)
    cfg = spec.config_file(bench, cell["config"])
    traffic = spec.traffic_file(cell["traffic"])
    limits = spec.limits_file(cell["name"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    genome = workload.make_genome(cfg["genome"], args.seed)
    pack = Pack.empty()
    pack.append(genome.name, genome.codes)
    mgr = make_params(cfg, getattr(args, "control", None))
    fmd = (FMDIndex.build(pack)
           if str(mgr.selected.get("Seeding Technique")) in FMD_TECHNIQUES else None)
    aligner = Aligner(pack, mgr, device=dev, fmd=fmd)
    pool = workload.make_pool(genome, traffic, args.seed)
    batch = int(traffic["batch_size"])
    stream = Stream(pool)

    # warm-up: the cell's own batch shapes, every library loaded and built
    aligner.align_to_sam(iter(warm_reads(pool, batch)), io.StringIO(), batch_size=batch)
    if cuda:
        torch.cuda.synchronize()
    aligner.n_overflow_reads = aligner.n_rescued_reads = 0
    aligner.n_inversion_windows = aligner.n_inversions = 0

    traced = bool(args.trace)
    recorders = []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        from ma_tpu_torch import kernels

        aligner.profiler = trace.SpanRecorder()
        recorders = [trace.LaunchRecorder(kernels.DP_FUSED, 2, (6, 7, 8, 9)),
                     trace.LaunchRecorder(kernels.DP_WAVEFRONT, 2, (7, 8, 9))]
        for r in recorders:
            r.__enter__()
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
        prof.__enter__()

    marks = []  # (time, reads done) after each batch
    sink = io.StringIO()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    offset = t0 - time.time_ns() * 1e-9
    setup_s = time.time() - proc_start
    usage0, steal0 = resource.getrusage(resource.RUSAGE_SELF), steal_s()
    deadline = t0 + float(args.seconds)

    def progress(n_done: int) -> bool:
        now = time.perf_counter()
        marks.append((now, n_done))
        return now < deadline

    try:
        aligner.align_to_sam(iter(stream), sink, batch_size=batch, progress=progress)
        raise RuntimeError("the read stream ended inside the window")
    except KeyboardInterrupt:
        pass
    if cuda:
        torch.cuda.synchronize()
    t_end, n_done = marks[-1]
    host = host_usage(usage0, resource.getrusage(resource.RUSAGE_SELF), steal_s() - steal0)
    if traced:
        prof.__exit__(None, None, None)
        for r in recorders:
            r.__exit__(None, None, None)
    window_s = t_end - t0
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # ---- after the window: what was written, the rate, placement
    records = parse_sam(sink.getvalue())
    by_read: dict = {}
    for rec in records:
        by_read.setdefault(rec.name, []).append(rec)
    idx_of = {name: workload.parse_name(name, len(pool), stream.yielded) for name in by_read}
    # records naming no read of the stream are faults of their own
    foreign = sum(len(by_read.pop(name)) for name, k in list(idx_of.items()) if k is None)
    idx_of = {name: k for name, k in idx_of.items() if k is not None}
    written = list(idx_of.values())
    lens = pool.lens
    bases = int(sum(int(lens[k]) for k in idx_of.values()))
    mbases = bases / 1e6
    lo, hi = pool.ref_span()
    copy, touches = workload.copy_of(genome, lo, hi)
    unique = (pool.kind == workload.KIND_GENOME) & ~touches
    prim = {}
    for name, recs in by_read.items():
        p = [r for r in recs if r.primary]
        if p:
            prim[idx_of[name]] = (p[0].pos, p[0].reverse)
    ok, n_unique = placed(pool, prim, unique, int(traffic["place_tol"]))
    # reads the window processed that got no record (random reads aside)
    first = np.arange(n_done) % len(pool)
    random_unwritten = int(np.sum((pool.kind[first] == workload.KIND_RANDOM)
                                  & ~np.isin(first, np.asarray(written, np.int64))))
    unwritten = n_done - len(idx_of) - random_unwritten

    metrics = {}
    out = {"attempted": n_done, "failed": max(0, int(unwritten)), "cycles": stream.cycles,
           "window_s": window_s, "mbases": mbases, "memory_peak_bytes": mem_peak,
           "batches": [[round(t - t0, 3), n] for t, n in marks], "host": host}
    if not traced:
        e2e = {"mbases_per_s": mbases / window_s, "placed_pct": 100.0 * ok / max(n_unique, 1),
               "setup_s": setup_s}
        for m in spec.cell_metrics(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"window": (t0, t_end), "mbases": mbases,
               "spans": aligner.profiler.spans,
               "device": trace.device_events(prof, offset) if cuda else [],
               "launches": {"dp_fused": recorders[0].host(), "dp_wavefront": recorders[1].host()}}
        for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
            v = spec.load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = trace.union_s([(s, e) for s, e, _ in ctx["device"]], t0, t_end)
        out["busy_s"] = busy
        out["breakdown"] = trace.breakdown(ctx)
        del ctx
    out["metrics"] = metrics

    # ---- the program's state goes before the reference runs
    del aligner, fmd, prof, recorders, sink
    if cuda:
        torch.cuda.empty_cache()
    sample = judge_sample(pool, written, copy, traffic["judge"], args.seed)
    names_of: dict = {}
    for name, k in idx_of.items():
        names_of.setdefault(k, []).append(name)
    truths = [ref_judge.ReadTruth(
        name=name, seq=pool.seq_of(k), fwd=pool.fwd_of(k), tpos=pool.tpos_of(k),
        strand=int(pool.strand[k]), random=bool(pool.kind[k] == workload.KIND_RANDOM),
        inv=int(pool.inv[k]), inv_len=pool.inv_len, copy=int(copy[k]),
        touches_copy=bool(touches[k])) for name, k in idx_of.items()]
    g = mgr.selected.get
    t_ref = time.perf_counter()
    numbers = ref_judge.judge(
        truths, by_read, genome.codes, genome.name, genome.copies,
        ref_judge.Scoring(match=int(g("Match Score")), min_score=int(g("Minimal Alignment Score")),
                          inversion_min=2 * int(g("Minimal Harmonization Score")) + 1),
        unwritten=int(unwritten), sampled={n for k in sample for n in names_of[k]})
    numbers["field_faults"] += foreign
    # unique-origin reads whose primary lies off their origin (exact)
    numbers["misplaced_reads"] = n_unique - ok
    numbers["reference_s"] = time.perf_counter() - t_ref
    correct, compared = ref_judge.decide(numbers, limits["limits"])
    out.update(correct=correct, compared=compared, numbers=numbers)
    return out
