"""The harness: inputs from the seed, the rate, the roofline counts, the
names and units of BENCHMARK.json, and each cell's files found by name."""
import itertools
import json

import numpy as np
import pytest

from bench_tiny import BENCH_DIR, ROOT, tiny
from harness import spec, trace, workload
from roofline import counts

BENCH = spec.load_benchmark(ROOT)
GENOME = {"length": 60_000, "contig": "g", "repeats": [
    {"name": "a", "families": 1, "copies": 3, "min_len": 1000, "max_len": 1000,
     "divergence": 0.001}]}


def pool_for(cell: str, seed: int, n: int = 64):
    traffic = dict(spec.traffic_file(spec.workload(BENCH, cell)["traffic"]), pool_reads=n)
    if "median" in traffic["length"]:
        traffic["length"] = {"median": 3000, "sigma": 0.5, "min": 1025, "max": 6000}
    g = workload.make_genome(GENOME, seed)
    return g, workload.make_pool(g, traffic, seed)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_same_seed_same_inputs_other_seed_others(cell):
    big = 3_000_000_000  # seeds beyond 32 bits
    g1, p1 = pool_for(cell, big + 7)
    g2, p2 = pool_for(cell, big + 7)
    g3, p3 = pool_for(cell, big + 8)
    assert np.array_equal(g1.codes, g2.codes) and np.array_equal(g1.copies, g2.copies)
    for a in ("fwd", "seq", "tpos", "off", "strand", "kind", "inv"):
        assert np.array_equal(getattr(p1, a), getattr(p2, a)), a
    assert not np.array_equal(g1.codes, g3.codes)
    assert not np.array_equal(p1.seq[:1000], p3.seq[:1000])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_reads_lie_where_their_truth_says(cell):
    g, p = pool_for(cell, 11)
    for i in range(len(p)):
        f, t = p.fwd_of(i), p.tpos_of(i)
        if p.kind[i] == workload.KIND_RANDOM:
            assert (t == -1).all()
            continue
        keep = np.ones(len(f), bool)
        if p.inv[i] >= 0:
            keep[p.inv[i] : p.inv[i] + p.inv_len] = False
        assert (g.codes[t[keep]] == f[keep]).mean() > 0.9
        s = p.seq_of(i)
        assert np.array_equal(workload.revcomp(s) if p.strand[i] else s, f)


def test_planted_copies_do_not_overlap_and_are_found():
    g = workload.make_genome(GENOME, 5)
    cp = g.copies[np.argsort(g.copies[:, 1])]
    assert (cp[1:, 1] >= cp[:-1, 1] + cp[:-1, 2]).all()
    s = int(cp[0, 1])
    inside, touches = workload.copy_of(g, np.array([s + 10, s - 5, 0]),
                                       np.array([s + 200, s + 100, 5]))
    assert inside[0] >= 0 and inside[1] == -1 and inside[2] == -1
    assert touches[0] and touches[1] and not touches[2]


def test_stream_cycles_with_fresh_names():
    from harness.cell import Stream

    _, p = pool_for("se150_default_b4096", 3, n=5)
    st = Stream(p)
    names = [r.name for r in itertools.islice(iter(st), 12)]
    assert names[:5] == ["r0", "r1", "r2", "r3", "r4"]
    assert names[5:7] == ["r0.1", "r1.1"] and st.cycles == 2
    assert len(set(names)) == 12
    assert [workload.parse_name(n, 5, st.yielded) for n in names] == list(range(5)) * 2 + [0, 1]
    # names the stream never handed out are no read of it
    assert [workload.parse_name(n, 5, st.yielded) for n in
            ("w3", "r5", "r0.0", "r2.2", "rx", "r1.a")] == [None] * 6


def test_rate_is_all_bases_over_all_time_with_the_last_batch():
    res = tiny("se150_default_b4096", 20261017, seconds=1.0)
    rate = res["metrics"]["mbases_per_s"]["value"]
    # the window runs to the end of the batch that overran --seconds
    assert res["window_s"] >= 1.0
    assert rate == pytest.approx(res["mbases"] / res["window_s"])
    # every written read's bases, in whole batches of 256
    assert res["mbases"] > 0 and res["attempted"] % 256 == 0
    assert res["correct"], res["compared"]


def test_inband_cells_by_hand():
    # M = N = 4, band 1: rows 0..3 hold 2, 3, 3, 2 cells
    assert counts.inband_cells([4], [4], [1], 4, 4) == 10
    # qlen 2 keeps rows 0, 1; tlen 3 cuts row 1's right edge at column 2
    assert counts.inband_cells([2], [3], [5], 4, 4) == 6
    # lengths past the bucket are cut to it; two problems add
    assert counts.inband_cells([9, 1], [9, 9], [0, 0], 3, 3) == 3 + 1


def test_bounds_by_hand():
    assert counts.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    nb, ops = counts.dp_fused_work([4], [4], [1], 4, 4, 8)
    assert nb == 4 * (4 + 4 + 4) + 4 * (8 + 8)
    assert ops == 46 * 10
    # 112 bytes outweigh 460 operations
    assert counts.bound_s(nb, ops) == pytest.approx(112 / 3.35e12)
    assert counts.bound_s(nb, 1000 * ops) == pytest.approx(460e3 / counts.INT32_OPS_PER_S)
    nb, ops = counts.dp_wavefront_work([2, 2], [3, 3], [9, 9], 2, 3)
    assert nb == 2 * (4 * 2 + 3 + 12) + 2 * (4 * 2 + 16 + 8 * 4)
    assert ops == 46 * 12
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)


def test_stage_union_counts_nested_spans_once():
    ctx = {"window": (0.0, 10.0), "spans": [("dp dispatch", 1.0, 3.0),
                                             ("host DP planning", 2.0, 4.0),
                                             ("dp collect 32", 2.5, 2.6),
                                             ("host SAM write", 5.0, 6.0),
                                             ("dp dispatch", 9.0, 12.0)]}
    mod = spec.load_metric("stage_ms_per_mbase.dp")
    assert mod.read(dict(ctx, mbases=2.0)) == pytest.approx(1e3 * (3.0 + 1.0) / 2.0)
    assert spec.load_metric("stage_ms_per_mbase.mapq").read(dict(ctx, mbases=2.0)) is None


def test_device_readers_and_breakdown():
    ctx = {"window": (0.0, 4.0), "mbases": 2.0,
           "spans": [("device seed+soc+harmonize", 0.0, 2.0), ("host SAM write", 2.0, 4.0)],
           "device": [(0.5, 1.0, "dp_fused_kernel"), (0.8, 1.5, "Memcpy HtoD"),
                      (3.0, 3.5, "soc_sweep_kernel")],
           "launches": {"dp_fused": [], "dp_wavefront": []}}
    idle = spec.load_metric("device_idle_pct").read(ctx)
    assert idle == pytest.approx(100.0 * (1 - 1.5 / 4.0))
    assert spec.load_metric("launches_per_mbase").read(ctx) == pytest.approx(1.0)
    assert spec.load_metric("dp_fused_roofline").read(ctx) is None
    bd = trace.breakdown(ctx)
    assert bd["device_ops"][:2] == [["Memcpy HtoD", pytest.approx(0.7)],
                                    ["dp_fused_kernel", pytest.approx(0.5)]]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "device seed+soc+harmonize": pytest.approx(0.5),
        "host SAM write": pytest.approx(1.5 + 0.5)}


def test_roofline_reader_sums_bounds_over_time():
    lens = np.array([[4, 4, 1, 0]], np.int32)
    ctx = {"window": (0.0, 1.0), "mbases": 1.0, "spans": [],
           "device": [(0.1, 0.1 + 1e-9, "void dp_fused_kernel<1>(int)")],
           "launches": {"dp_fused": [(lens, (1, 4, 4, 8))], "dp_wavefront": []}}
    got = spec.load_metric("dp_fused_roofline").read(ctx)
    nb, ops = counts.dp_fused_work([4], [4], [1], 4, 4, 8)
    assert got == pytest.approx(100.0 * counts.bound_s(nb, ops) / 1e-9, rel=1e-6)


NAME_KEYS = ("name", "config", "traffic")


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for sec in ("end_to_end", "per_layer") for m in BENCH[sec]]
    names += [w[k] for w in BENCH["workloads"] for k in NAME_KEYS]
    names += [c["name"] for c in BENCH["configs"]] + [k for c in BENCH["configs"]
                                                     for k in c["reduced"]]
    assert all(spec.NAME_RE.match(n) for n in names), names
    units = [m["unit"] for sec in ("end_to_end", "per_layer") for m in BENCH[sec]]
    assert all(spec.UNIT_RE.match(u) for u in units), units
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_each_cell_finds_its_files_by_name():
    for w in BENCH["workloads"]:
        cfg = spec.config_file(BENCH, w["config"])
        assert cfg["name"] == w["config"] and cfg["preset"]
        assert spec.config_entry(BENCH, w["config"])["file"].startswith("benchmark/configs/")
        traffic = spec.traffic_file(w["traffic"])
        assert traffic["batch_size"] > 0 and traffic["pool_reads"] > 0
        assert spec.limits_file(w["name"])["limits"]
        for m in spec.cell_metrics(BENCH, w["name"], "per_layer"):
            mod = spec.load_metric(m["name"])
            assert callable(mod.read) and mod.READS
        e2e = {m["name"] for m in spec.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert {"setup_s", "mbases_per_s"} <= e2e


def test_benchmark_paths_and_command():
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert (BENCH_DIR / "run.py").is_file()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
