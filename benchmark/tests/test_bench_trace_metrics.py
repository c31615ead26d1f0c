"""The per-layer metrics that read the program's tracer: the spans inside
the device stage (from ctx["spans"]) and the counters of the tracer the
harness installed (through ma_tpu_torch.utils.profile), each from a
synthetic window, and None where their spans or counters are absent."""
import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from harness import spec

from ma_tpu_torch.utils import profile

SPANS = [("batch", 0.0, 10.0),
         ("device seed+soc+harmonize", 0.5, 9.0),
         ("seeding", 0.5, 6.5),
         ("seed extraction", 6.5, 8.0),
         ("soc", 8.0, 8.25),
         ("harmonization", 8.25, 8.75),
         ("set packing", 8.75, 9.0),
         ("seeding", 11.0, 12.0)]  # past the window: clipped away
CTX = {"window": (0.0, 10.0), "mbases": 2.0, "spans": SPANS, "device": [],
       "launches": {"dp_fused": [], "dp_wavefront": []}}
COUNTERS = {"fmd steps": 400, "fmd lane steps": 400 * 4096, "fmd live lane steps": 300 * 4096,
            "host syncs": 330, "mapq run pairs": 5_000_000}

SPAN_METRICS = {"stage_ms_per_mbase.seeding": 1e3 * 6.0 / 2.0,
                "stage_ms_per_mbase.seed_extraction": 1e3 * 1.5 / 2.0,
                "stage_ms_per_mbase.soc_harmonization": 1e3 * 1.0 / 2.0}
COUNTER_METRICS = {"fmd_steps_per_mbase": 400 / 2.0,
                   "fmd_lane_use_pct": 75.0,
                   "host_syncs_per_mbase": 330 / 2.0,
                   "mapq_run_pairs_per_mbase": 5_000_000 / 2.0,
                   "fmd_step_us": 1e6 * 6.0 / 400}


@pytest.fixture
def tracer():
    tr = profile.AnalyzeRuntimes()
    tr.counters.update(COUNTERS)
    profile.install(tr)
    yield tr
    profile.install(None)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_reads_its_spans(name):
    mod = spec.load_metric(name)
    assert "spans" in mod.READS
    assert mod.read(CTX) == pytest.approx(SPAN_METRICS[name])
    assert mod.read(dict(CTX, spans=[s for s in SPANS if s[0] not in mod.STAGES])) is None
    assert mod.read(dict(CTX, spans=[])) is None


@pytest.mark.parametrize("name", sorted(COUNTER_METRICS))
def test_counter_metric_reads_the_installed_tracer(name, tracer):
    mod = spec.load_metric(name)
    assert "counters" in mod.READS
    assert mod.read(CTX) == pytest.approx(COUNTER_METRICS[name])


@pytest.mark.parametrize("name", sorted(COUNTER_METRICS))
def test_counter_metric_is_none_without_tracer_or_counter(name, tracer):
    mod = spec.load_metric(name)
    tr = profile.current()
    tr.counters.clear()
    assert mod.read(CTX) is None
    profile.install(None)
    assert mod.read(CTX) is None


def test_counter_reader_is_none_on_a_program_without_the_tracer(monkeypatch):
    """The parent program's profile module has no `current`: no number, no
    error."""
    monkeypatch.delattr(profile, "current")
    for name in COUNTER_METRICS:
        assert spec.load_metric(name).read(CTX) is None


def test_device_stage_children_cover_the_stage():
    """The three device-stage metrics add up to the stage's own span when
    its children cover it, as the tracer's spans do."""
    total = sum(spec.load_metric(n).read(CTX) for n in SPAN_METRICS)
    stage = spec.load_metric("stage_ms_per_mbase.device_stage").read(CTX)
    assert total == pytest.approx(stage)


def test_new_metrics_are_declared_for_their_cells():
    bench = spec.load_benchmark(ROOT)
    by = {m["name"]: m for m in bench["per_layer"]}
    fmd = ["se150_default_b4096", "se150_default_b256"]
    every = ["se150_default_b4096", "pacbio_ln12k_b256", "se150_default_b256"]
    want = {"stage_ms_per_mbase.seeding": every, "stage_ms_per_mbase.seed_extraction": fmd,
            "stage_ms_per_mbase.soc_harmonization": every, "fmd_step_us": fmd,
            "fmd_steps_per_mbase": fmd, "fmd_lane_use_pct": fmd,
            "host_syncs_per_mbase": every, "mapq_run_pairs_per_mbase": ["pacbio_ln12k_b256"]}
    for name, cells in want.items():
        assert by[name]["workloads"] == cells and by[name]["moves"] == "mbases_per_s"
