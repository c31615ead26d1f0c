"""The port's tracer (ma_tpu_torch/utils/profile.py): spans with parents and
batch ids, the counters of the FMD state machine, host syncs and mapping
quality, a subclass that overrides `time()` and `spans` as the benchmark's
recorder does, the SAM unchanged by tracing, and the `sv` spans of `--Sv`
under MA_TPU_PROFILE. CPU, on tests/test_torch_slice_contigs.py's two-contig
fixture (its repeat and poly-A reads take the overflow rescue)."""
import contextlib
import io
import time

import numpy as np
import pytest
import torch

from ma_tpu_torch.utils import profile

torch.set_num_threads(1)

DEVICE_CHILDREN = ("seeding", "seed extraction", "soc", "harmonization", "set packing")


def _fixture():
    from test_torch_slice_contigs import _fixture as contigs

    return contigs()


class Recorder(profile.AnalyzeRuntimes):
    """The benchmark harness's stage recorder, as it is written there."""

    def __init__(self) -> None:
        super().__init__()
        self.spans: list = []

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.append((stage, t0, t1))
            self.register(stage, t1 - t0)


def _aligner(technique: str):
    from ma_tpu_torch.config.parameters import ParameterSetManager
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.pipeline.aligner import Aligner

    pack, reads = _fixture()
    mgr = ParameterSetManager()
    mgr.set_selected("Illumina" if technique == "SMEMs" else "Default")
    if technique == "minimizers":
        mgr.selected.set("Seeding Technique", "minimizers")
    fmd = None if technique == "minimizers" else FMDIndex.build(pack)
    return Aligner(pack, mgr, device="cpu", fmd=fmd), reads


@pytest.fixture(scope="module", params=["maxSpan", "minimizers"])
def runs(request):
    """One untraced and one traced align_to_sam of the fixture (batch 8):
    (technique, untraced SAM, traced SAM, tracer, `step` calls counted by a
    wrapper of seeding._run, calls of AnalyzeRuntimes' recording methods in
    the untraced run, the aligner)."""
    from ma_tpu_torch.ops import seeding

    technique = request.param
    al, reads = _aligner(technique)
    assert profile.current() is None
    calls = {"n": 0}
    saved = {k: getattr(profile.AnalyzeRuntimes, k) for k in ("_enter", "add", "next_batch")}

    def spy(fn):
        def wrapped(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    for k, fn in saved.items():
        setattr(profile.AnalyzeRuntimes, k, spy(fn))
    try:
        off = io.StringIO()
        al.align_to_sam(iter(reads), off, batch_size=8, cmd="ma_tpu")
    finally:
        for k, fn in saved.items():
            setattr(profile.AnalyzeRuntimes, k, fn)
    untraced_calls = calls["n"]

    steps = {"n": 0}
    run = seeding._run

    def counted(step, st, done_phase, iter_cap):
        def one(x):
            steps["n"] += 1
            return step(x)
        return run(one, st, done_phase, iter_cap)

    seeding._run = counted
    tr = Recorder()
    al.profiler = tr
    try:
        on = io.StringIO()
        al.align_to_sam(iter(reads), on, batch_size=8, cmd="ma_tpu")
    finally:
        al.profiler = None
        seeding._run = run
    return technique, off.getvalue(), on.getvalue(), tr, steps["n"], untraced_calls, al


def test_sam_identical_with_tracer_on_and_off_and_nothing_recorded_without(runs):
    technique, off, on, tr, _, untraced_calls, al = runs
    assert off == on and off.count("\n") > 20
    assert untraced_calls == 0
    assert profile.current() is None and al.profiler is None


def test_spans_nest_under_their_parents_with_one_batch_id_per_batch(runs):
    technique, _, _, tr, _, _, _ = runs
    recs = tr.records
    parent = lambda sp: recs[sp.parent].name if sp.parent >= 0 else None  # noqa: E731
    batches = [sp for sp in recs if sp.name == "batch"]
    # 24 reads in batches of 8, and every batch span at the top
    assert [sp.batch for sp in batches] == [0, 1, 2]
    assert all(sp.parent == -1 for sp in batches)
    assert [c[0] for c in tr.clocks] == [0, 1, 2]
    for sp in recs:
        assert sp.start <= sp.end
        if sp.parent >= 0:
            up = recs[sp.parent]
            # a child inside its parent, in the parent's batch
            assert up.start <= sp.start and sp.end <= up.end
            assert sp.batch == up.batch
        else:
            assert sp.name == "batch"
    for sp in recs:
        if sp.name in DEVICE_CHILDREN:
            assert parent(sp) == "device seed+soc+harmonize", sp.name
        if sp.name in ("device seed+soc+harmonize", "host batch prep"):
            assert parent(sp) in ("batch", "overflow rescue")
        if sp.name == "overflow rescue":
            assert parent(sp) == "batch"
    names = {sp.name for sp in recs}
    want = {"seeding", "soc", "harmonization", "set packing"}
    if technique != "minimizers":
        want.add("seed extraction")
    else:
        assert "seed extraction" not in names
    assert want <= names
    # one batch id a batch: every span of a batch lies in its batch span
    for b in batches:
        inside = [sp for sp in recs if b.start <= sp.start and sp.end <= b.end]
        assert {sp.batch for sp in inside} == {b.batch}
    # each device stage holds one span of each child (or a rescue's own)
    stages = [i for i, sp in enumerate(recs) if sp.name == "device seed+soc+harmonize"]
    for i in stages:
        kids = sorted(sp.name for sp in recs if sp.parent == i)
        assert kids == sorted(want), kids


def test_overflow_rescue_spans_carry_the_batch_id(runs):
    technique, _, _, tr, _, _, al = runs
    assert al.n_rescued_reads >= 1
    recs = tr.records
    rescues = [i for i, sp in enumerate(recs) if sp.name == "overflow rescue"]
    assert rescues
    for i in rescues:
        inner = [sp for sp in recs if sp.parent == i]
        assert [sp.name for sp in inner][:1] == ["device seed+soc+harmonize"]
        assert {sp.batch for sp in inner} == {recs[i].batch} and recs[i].batch >= 0


def test_fmd_steps_equal_the_step_calls_and_live_lanes_at_most_all(runs):
    technique, _, _, tr, steps, _, _ = runs
    c = tr.counters
    if technique == "minimizers":
        assert steps == 0 and "fmd steps" not in c
        return
    assert steps > 0 and c["fmd steps"] == steps
    assert 0 < c["fmd live lane steps"] <= c["fmd lane steps"]
    # every batch of 8 reads (the rescue's at 32) steps all its lanes
    assert c["fmd lane steps"] >= 8 * steps
    assert c["fmd lane steps"] % 8 == 0


def test_host_syncs_counted(runs):
    technique, _, _, tr, _, _, _ = runs
    c = tr.counters
    # at least the two downloads of each batch's packed seed sets
    n_stages = sum(sp.name == "device seed+soc+harmonize" for sp in tr.records)
    assert c["host syncs"] >= 2 * n_stages
    if technique != "minimizers":
        assert c["sa walk steps"] > 0


def test_a_time_overriding_subclass_sees_every_span_and_counter(runs):
    technique, _, _, tr, _, _, _ = runs
    seen = {name for name, _, _ in tr.spans}
    assert seen == {sp.name for sp in tr.records}
    assert len(tr.spans) == len(tr.records)
    assert set(tr.times) == seen
    for name in ("batch", "overflow rescue", "seeding", "soc", "harmonization",
                 "set packing", "device seed+soc+harmonize", "host SAM write"):
        assert name in seen, name
    assert {"host syncs", "mapq run pairs"} <= set(tr.counters)
    # the table: self times, the counters
    table = tr.analyze()
    assert "self [s]" in table and "device [s]" in table and "host syncs" in table
    own = tr.self_times()
    assert own["batch"] <= tr.times["batch"] and all(v >= 0 for v in own.values())


def test_mapq_run_pairs_equal_a_brute_force_count(monkeypatch):
    from ma_tpu_torch.containers.alignment import DELETION, INSERTION, Alignment

    al, reads = _aligner("minimizers")
    pairs = {"n": 0, "calls": 0}
    overlap = Alignment.overlap

    def brute(self, other):
        pairs["calls"] += 1
        if max(self.begin_on_query, other.begin_on_query) < min(self.end_on_query,
                                                                  other.end_on_query):
            runs_of = lambda a: sum(op not in (DELETION, INSERTION) for op, _ in a.data)  # noqa: E731
            pairs["n"] += runs_of(self) * runs_of(other)
        return overlap(self, other)

    monkeypatch.setattr(Alignment, "overlap", brute)
    tr = profile.AnalyzeRuntimes()
    al.profiler = tr
    try:
        # the objects path (mapping quality in Python) for every batch
        al.pset.set("Emulate NGMLR's tag output", True)
        al.align_to_sam(iter(reads), io.StringIO(), batch_size=8, cmd="ma_tpu")
    finally:
        al.profiler = None
    assert pairs["calls"] > 0 and pairs["n"] > 0
    assert tr.counters["mapq run pairs"] == pairs["n"]


def test_mapq_runs_swept_equal_a_brute_force_count(monkeypatch):
    """The merge reads each run of both lists once a call whose windows
    meet: `mapq runs swept` is the sum of Ra + Rb over those calls, and
    `mapq run pairs` (Ra x Rb) is counted over the same calls."""
    from ma_tpu_torch.containers.alignment import DELETION, INSERTION, Alignment

    al, reads = _aligner("minimizers")
    runs = {"swept": 0, "pairs": 0}
    overlap = Alignment.overlap

    def brute(self, other):
        if max(self.begin_on_query, other.begin_on_query) < min(self.end_on_query,
                                                                  other.end_on_query):
            ra, rb = (sum(op not in (DELETION, INSERTION) for op, _ in a.data)
                      for a in (self, other))
            runs["swept"] += ra + rb
            runs["pairs"] += ra * rb
        return overlap(self, other)

    monkeypatch.setattr(Alignment, "overlap", brute)
    tr = profile.AnalyzeRuntimes()
    al.profiler = tr
    try:
        al.pset.set("Emulate NGMLR's tag output", True)
        al.align_to_sam(iter(reads), io.StringIO(), batch_size=8, cmd="ma_tpu")
    finally:
        al.profiler = None
    assert runs["swept"] > 0
    assert tr.counters["mapq runs swept"] == runs["swept"]
    assert tr.counters["mapq run pairs"] == runs["pairs"]


def test_helpers_are_no_ops_without_a_tracer():
    assert profile.current() is None
    with profile.span("x"), profile.batch(), profile.stage_timer(None, "y"):
        profile.count("c", 3)
        profile.host_sync()
    assert profile.span("x") is profile.span("y")  # one shared no-op
    tr = profile.AnalyzeRuntimes()
    with profile.stage_timer(tr, "outer"):
        with profile.stage_timer(tr, "inner"):
            pass
    assert [sp.name for sp in tr.records] == ["outer", "inner"]
    assert tr.records[1].parent == 0 and tr.records[0].parent == -1
    assert tr.counts == {"outer": 1, "inner": 1} and tr.device_intervals() == []


def test_analyze_self_time_and_ratio_by_hand():
    tr = profile.AnalyzeRuntimes()
    profile.install(tr)
    try:
        with profile.batch():
            with profile.span("a"):
                with profile.span("b"):
                    time.sleep(0.02)
            profile.count("k", 5)
            profile.host_sync(2)
    finally:
        profile.install(None)
    own = tr.self_times()
    assert own["b"] == pytest.approx(tr.times["b"])
    assert own["a"] < 0.01 and own["batch"] < 0.01
    rows = {name: (secs, calls, ratio) for name, secs, calls, ratio in tr.rows()}
    assert rows["b"][2] > 90 and rows["a"][1] == 1
    assert tr.counters == {"k": 5, "host syncs": 2}
    assert [sp.batch for sp in tr.records] == [0, 0, 0] and tr.batch == -1
    text = tr.analyze()
    assert text.splitlines()[0].split()[:2] == ["stage", "runtime"]
    assert "k" in text.split("counter")[1]


def test_sv_spans_in_the_profile_table(tmp_path, monkeypatch, capsys):
    """--Sv --Device cpu under MA_TPU_PROFILE prints the four `sv` spans."""
    from ma_tpu_torch.cli import main
    from ma_tpu_torch.containers.nucseq import decode_seq
    from test_torch_msv import sv_data

    ref, reads = sv_data()
    seq = decode_seq(ref)
    (tmp_path / "genome.fa").write_text(
        ">chrR\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
    (tmp_path / "reads.fq").write_text("".join(
        f"@sv{i}\n{decode_seq(c)}\n+\n{'I' * len(c)}\n" for i, c in enumerate(reads[:40])))
    assert main(["--Create_Index", f"{tmp_path}/genome.fa,{tmp_path}/idx,g"]) == 0
    capsys.readouterr()
    monkeypatch.setenv("MA_TPU_PROFILE", "1")
    assert main(["-x", f"{tmp_path}/idx/g", "-i", str(tmp_path / "reads.fq"), "--Sv",
                 "-o", str(tmp_path / "calls.tsv"), "--Device", "cpu"]) == 0
    err = capsys.readouterr().err
    table = err[err.index("stage"):]
    for name in ("sv dispatch", "sv soc download", "sv enumerate", "sv jumps"):
        assert f"\n{name} " in table, name
    assert profile.current() is None


@pytest.mark.gpu
def test_device_intervals_on_the_card():
    """On a CUDA device each span's device interval lies on the host's
    clock: it starts no earlier than its host span, ends no earlier than
    the work enqueued in it, and nests as the host spans do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device intervals are CUDA events")
    dev = torch.device("cuda")
    tr = profile.AnalyzeRuntimes()
    profile.install(tr, dev)
    try:
        x = torch.randn(2048, 2048, device=dev)
        with profile.batch():
            with profile.span("work"):
                t0 = time.perf_counter()
                for _ in range(20):
                    x = x @ x
                    x = x / x.norm()
                t1 = time.perf_counter()
            with profile.span("idle"):
                pass
    finally:
        profile.install(None)
    iv = {name: (s, e) for name, s, e in tr.device_intervals()}
    assert set(iv) == {"batch", "work", "idle"}
    host = {sp.name: (sp.start, sp.end) for sp in tr.records}
    s, e = iv["work"]
    assert host["work"][0] - 1e-3 <= s <= e
    # the matrix products take longer on the device than to enqueue
    assert e - s > 0.5 * (t1 - t0)
    assert iv["batch"][0] <= s + 1e-6 and e <= iv["batch"][1] + 1e-6
    assert iv["idle"][0] >= e - 1e-6
    assert "device [s]" in tr.analyze()
    np.testing.assert_array_less(0, [e - s for s, e in iv.values()])
