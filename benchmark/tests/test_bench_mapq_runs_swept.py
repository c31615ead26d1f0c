"""`mapq_runs_swept_per_mbase`: the counter `mapq runs swept` of the tracer
the harness installed, per Mbase, from a synthetic window and from the
port's own overlap test; None where the program has no such counter or
tracer, as on a program older than the counter."""
import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from harness import spec

from ma_tpu_torch.containers.alignment import DELETION, INSERTION, MATCH, SEED, Alignment
from ma_tpu_torch.utils import profile

NAME = "mapq_runs_swept_per_mbase"
CTX = {"window": (0.0, 10.0), "mbases": 2.0, "spans": [], "device": [],
       "launches": {"dp_fused": [], "dp_wavefront": []}}


@pytest.fixture
def tracer():
    tr = profile.AnalyzeRuntimes()
    profile.install(tr)
    yield tr
    profile.install(None)


def test_reads_the_installed_tracer(tracer):
    mod = spec.load_metric(NAME)
    assert "counters" in mod.READS
    tracer.counters.update({"mapq runs swept": 90_000, "mapq run pairs": 5_000_000})
    assert mod.read(CTX) == pytest.approx(45_000)


def test_counts_the_runs_of_the_overlap_test(tracer):
    """Two alignments of 3 and 2 runs over one window: 5 runs swept, 6
    pairs; a call whose windows do not meet counts nothing."""
    a = Alignment(begin_on_query=0)
    for op, size in ((MATCH, 10), (INSERTION, 2), (SEED, 20), (DELETION, 3), (MATCH, 5)):
        a.append(op, size)
    b = Alignment(begin_on_query=4)
    for op, size in ((SEED, 12), (INSERTION, 1), (MATCH, 9)):
        b.append(op, size)
    far = Alignment(begin_on_query=100)
    far.append(MATCH, 10)
    assert a.overlap(b) == (6 + 4 + 9) / 37
    assert a.overlap(far) == 0.0
    assert tracer.counters == {"mapq runs swept": 5, "mapq run pairs": 6}
    assert spec.load_metric(NAME).read(CTX) == pytest.approx(5 / 2.0)


def test_is_none_without_tracer_or_counter(tracer):
    mod = spec.load_metric(NAME)
    tracer.counters["mapq run pairs"] = 7
    assert mod.read(CTX) is None
    profile.install(None)
    assert mod.read(CTX) is None


def test_is_none_on_a_program_without_the_tracer(monkeypatch):
    monkeypatch.delattr(profile, "current")
    assert spec.load_metric(NAME).read(CTX) is None


def test_declared_for_the_long_cell():
    bench = spec.load_benchmark(ROOT)
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["pacbio_ln12k_b256"] and m["moves"] == "mbases_per_s"
    assert m["layer"] == "mapping quality" and m["source"] == "program_counter"
