"""The plain reference: its DP against a full-matrix one, its verdict on the
port's own records (the CPU path, a tiny genome), and records it must
refuse: a shifted position, a changed CIGAR operation, a changed MAPQ. Then
the control and the faults a cell can have, each driven through a whole
run, must come out not correct."""
import copy
import dataclasses

import numpy as np
import pytest

from bench_tiny import tiny
from reference import dp, judge
from reference.sam import FLAG_SECONDARY, cigar_ops


def full_matrix(q, g, local):
    NEG = -(10**9)
    n, m = len(q), len(g)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, :] = 0
    best = NEG
    for i in range(1, n + 1):
        for j in range(m + 1):
            v = H[i - 1, j - 1] + (2 if q[i - 1] == g[j - 1] else -4) if j else NEG
            v = max([v] + [H[k, j] - dp.gap_cost(i - k) for k in range(i)]
                    + [H[i, k] - dp.gap_cost(j - k) for k in range(j) if H[i, k] > NEG])
            H[i, j] = max(v, 0) if local else v
            best = max(best, H[i, j])
    return best if local else H[n, :].max()


@pytest.mark.parametrize("case", range(24))
def test_banded_dp_equals_the_full_matrix(case):
    rng = np.random.default_rng(case)
    g = rng.integers(0, 4, 48).astype(np.uint8)
    q = g[6:34].copy()
    q[rng.integers(0, len(q), 3)] = rng.integers(0, 4, 3)
    if case % 3 == 0:
        q = np.delete(q, [9, 10, 11])
    elif case % 3 == 1:
        q = np.insert(q, 8, [0, 1, 2, 3, 1, 1, 2])
    local = bool(case % 2)
    got = dp.best_scores([q], [np.full(len(q), -1, np.int64)], 50, g, local)[0]
    assert got == full_matrix(q, g, local)


@pytest.fixture(scope="module")
def short_run():
    """The tiny short cell's run, with what the reference was handed."""
    seen = {}
    orig = judge.judge

    def keep(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return orig(*args, **kw)

    judge.judge = keep
    try:
        res = tiny("se150_default_b4096", 424242)
    finally:
        judge.judge = orig
    return res, seen


def rejudge(seen, edit):
    reads, records, genome, contig, copies, sc = seen["args"]
    records = copy.deepcopy(records)
    edit(records)
    return judge.judge(reads, records, genome, contig, copies, sc, **seen["kw"])


def limits():
    from harness import spec

    return spec.limits_file("se150_default_b4096")["limits"]


def test_reference_accepts_the_ports_cpu_records(short_run):
    res, _ = short_run
    assert res["correct"], res["compared"]
    assert res["numbers"]["judged_records"] > 100


def judged_primaries(seen):
    reads, records = seen["args"][0], seen["args"][1]
    out = []
    for rd in reads:
        for r in records.get(rd.name, []):
            if r.primary and len(cigar_ops(r.cigar)) == 1 and r.mapq >= 100:
                out.append(r.name)
    return out


def edit_first(seen, fn):
    name = judged_primaries(seen)[0]

    def edit(records):
        rec = next(r for r in records[name] if r.primary)
        fn(rec)
    return edit


@pytest.mark.parametrize("shift", [-3, 1, 40])
def test_reference_rejects_a_shifted_position(short_run, shift):
    _, seen = short_run
    out = rejudge(seen, edit_first(seen, lambda r: setattr(r, "pos", r.pos + shift)))
    assert not judge.decide(out, limits())[0], out


@pytest.mark.parametrize("new", ["{a}M1I{b}M", "{a}M1D{c}M", "{a}M2I{d}M"])
def test_reference_rejects_a_changed_cigar_operation(short_run, new):
    _, seen = short_run

    def change(rec):
        n = int(rec.cigar[:-1])
        a = n // 2
        rec.cigar = new.format(a=a, b=n - a - 1, c=n - a, d=n - a - 2)
    out = rejudge(seen, edit_first(seen, change))
    assert not judge.decide(out, limits())[0], out


def test_reference_rejects_a_changed_mapq(short_run):
    _, seen = short_run
    out = rejudge(seen, edit_first(seen, lambda r: setattr(r, "mapq", 1)))
    assert out["mapq_faults"] == 1 and not judge.decide(out, limits())[0]

    def secondary(records):
        rec = next(r for rs in records.values() for r in rs if r.flag & FLAG_SECONDARY)
        rec.mapq = 7
    out = rejudge(seen, secondary)
    assert out["field_faults"] == 1 and not judge.decide(out, limits())[0]


def test_mapq_rule_by_hand():
    sc = judge.Scoring()
    # a runner-up written: (300 - 294) / 300, halved or doubled
    assert judge.mapq_admissible(6, 300, [294], 150, sc)
    assert judge.mapq_admissible(3, 300, [294], 150, sc)
    assert not judge.mapq_admissible(60, 300, [294], 150, sc)
    assert judge.mapq_admissible(0, 300, [300], 150, sc)
    # none written: s1 / (2 * 150), or a runner-up below 75 not written
    assert judge.mapq_admissible(254, 300, [], 150, sc)
    assert judge.mapq_admissible(127, 300, [], 150, sc)
    assert not judge.mapq_admissible(20, 300, [], 150, sc)


# ---- the control and the faults, each through a whole run


def test_control_narrow_band_is_not_correct():
    res = tiny("se150_default_b4096", 515151, control="narrow_band")
    assert not res["correct"], res["compared"]


def test_long_control_without_inversions_is_not_correct():
    res = tiny("pacbio_ln12k_b256", 616161, seconds=3.0, control="no_inversions")
    assert not res["correct"], res["compared"]


def broken_emit(kind):
    """finish_native.emit_sam with one fault planted where the SAM text is
    produced."""
    from ma_tpu_torch.pipeline import finish_native

    orig = finish_native.emit_sam
    state = {}

    def emit(*args, **kw):
        res = orig(*args, **kw)
        if res is None:
            return res
        text, n = res
        lines = text.decode().splitlines(keepends=True)
        if kind == "half_batch":
            names = sorted({ln.split("\t", 1)[0] for ln in lines})
            gone = set(names[::2])
            lines = [ln for ln in lines if ln.split("\t", 1)[0] not in gone]
        elif kind == "stale_state":
            prev = state.get("prev")
            state["prev"] = lines
            lines = prev if prev is not None else lines
        elif kind == "altered_answer":
            f = lines[0].split("\t")
            f[3] = str(int(f[3]) + 5)
            lines[0] = "\t".join(f)
        return "".join(lines).encode(), n
    return finish_native, orig, emit


@pytest.mark.parametrize("kind", ["half_batch", "stale_state", "altered_answer"])
def test_a_broken_timed_path_is_not_correct(kind):
    mod, orig, emit = broken_emit(kind)
    mod.emit_sam = emit
    try:
        res = tiny("se150_default_b4096", 717171)
    finally:
        mod.emit_sam = orig
    assert not res["correct"], (kind, res["compared"])


def broken_writer(kind):
    """SamWriter.write (the long path's per-read SAM output) with one fault
    planted where the records are produced."""
    from ma_tpu_torch.io.sam import SamWriter

    orig = SamWriter.write
    state = {"calls": 0}

    def write(self, alignments, query):
        state["calls"] += 1
        alignments = list(alignments)
        if kind == "half_batch" and state["calls"] % 2:
            return
        if kind == "stale_state":
            prev = state.get("prev")
            state["prev"] = (alignments, query)
            if prev is not None:
                alignments, query = prev
        if kind == "altered_answer" and alignments and state["calls"] % 8 == 1:
            alignments[0].begin_on_ref += 5
            alignments[0].end_on_ref += 5
        if kind == "misplaced_answer" and alignments and state["calls"] % 8 == 1:
            alignments[0].begin_on_ref += 5000
            alignments[0].end_on_ref += 5000
        return orig(self, alignments, query)
    return SamWriter, orig, write


@pytest.mark.parametrize("kind", ["half_batch", "stale_state", "altered_answer",
                                  "misplaced_answer"])
def test_a_broken_long_path_is_not_correct(kind):
    cls, orig, write = broken_writer(kind)
    cls.write = write
    try:
        res = tiny("pacbio_ln12k_b256", 818181, seconds=3.0)
    finally:
        cls.write = orig
    assert not res["correct"], (kind, res["compared"])
    if kind == "misplaced_answer":
        assert res["numbers"]["misplaced_reads"] > 0, res["compared"]


def test_inversions_are_judged_over_every_written_read():
    """inv_missed_pct counts every written read with a planted inversion,
    not only the reads whose DPs the sample runs."""
    from reference.sam import FLAG_REVERSE, FLAG_SUPPLEMENTARY, Record

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    reads, records = [], {}
    for k, start in enumerate((200, 2000)):
        tpos = np.arange(start, start + 600)
        reads.append(judge.ReadTruth(
            name=f"r{k}", seq=genome[tpos], fwd=genome[tpos], tpos=tpos, strand=0,
            random=False, inv=300, inv_len=200, copy=-1, touches_copy=False))
        records[f"r{k}"] = [Record(f"r{k}", 0, "c", start + 1, 60, "600M", "A" * 600)]
    # only r0's inverted stretch has its record on the other strand
    records["r0"].append(Record("r0", FLAG_REVERSE | FLAG_SUPPLEMENTARY, "c", 501, 0,
                                "300H200M100H", "A" * 200))
    out = judge.judge(reads, records, genome, "c", np.zeros((0, 4), np.int64),
                      judge.Scoring(), sampled=set())
    assert out["inversion_reads"] == 2 and out["inv_missed_pct"] == 50.0
    assert out["judged_reads"] == 0


def test_read_truth_fields_are_what_the_judge_reads():
    names = {f.name for f in dataclasses.fields(judge.ReadTruth)}
    assert {"seq", "fwd", "tpos", "strand", "inv", "copy", "touches_copy"} <= names
