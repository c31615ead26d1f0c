"""The port's copies of ma_tpu's SQL layer (db/), SV database (msv/sv_db.py)
and pledge-graph runtime (ms/) against ma_tpu: tests/test_sv_db.py's and
tests/test_ms_graph.py's cases run on both packages, from the same numpy
inputs, and must give the same rows, values and exceptions. Then a CPU
JumpBatch of the port's SV caller goes through SvDb: the loaded jumps equal
the stored ones field by field, and their sweep gives the list's calls."""
import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_msv_host import PKGS, convert, mod, pack_of, rows, sv_genome

torch.set_num_threads(1)


def both(case, *args):
    """case(pkg, *args) for each package; the port's result must equal
    ma_tpu's. Returns ma_tpu's."""
    out = {pkg: case(pkg, *args) for pkg in PKGS}
    assert out["ma_tpu_torch"] == out["ma_tpu"]
    return out["ma_tpu"]


# ------------------------------------------------------------- SQL layer
def typed_table(pkg, tmp_path):
    sql = mod(pkg, "db.sql_api")
    with sql.SQLDB() as db:
        t = sql.SQLTableWithAutoPriKey(
            db, "t", [("name", str), ("x", int), ("w", float), ("blob", bytes)])
        ids = (t.insert("a", 1, 0.5, b"\x00\x01"), t.insert("b", 2, 1.5, b""))
        return ids, t.select(order="id"), t.count("x >= ?", (2,)), db.has_table("t")


def bulk_inserter(pkg, tmp_path):
    sql = mod(pkg, "db.sql_api")
    with sql.SQLDB() as db:
        t = sql.SQLTable(db, "b", [("x", int)])
        with t.bulk_inserter(buffer_rows=10) as bi:
            for i in range(1234):
                bi.insert(i)
        return t.count(), bi.inserted, t.select(order="x")[-3:]


def rectangle_index(pkg, tmp_path):
    """R*Tree queries against a brute filter of every row."""
    sql = mod(pkg, "db.sql_api")
    rng = np.random.default_rng(0)
    got = []
    with sql.SQLDB() as db:
        t = sql.SQLTable(db, "r", [("x", int), ("w", int), ("y", int), ("h", int)])
        with t.bulk_inserter() as bi:
            for (x, w, y, h) in rng.integers(0, 1000, (300, 4)):
                bi.insert(int(x), int(w % 50), int(y), int(h % 50))
        t.gen_rectangle_index("x", "w", "y", "h")
        for qx, qy in rng.integers(0, 1000, (20, 2)):
            hit = sorted(t.select_rectangle(qx, qx + 100, qy, qy + 100))
            brute = sorted(r for r in t.select()
                           if r[0] + r[1] >= qx and r[0] < qx + 100
                           and r[2] + r[3] >= qy and r[2] < qy + 100)
            assert hit == brute
            got.append(hit)
    return got


def pool_inserts(pkg, tmp_path):
    sql, pool = mod(pkg, "db.sql_api"), mod(pkg, "db.pool")
    path = str(tmp_path / f"{pkg}.db")
    with sql.SQLDB(path) as db:
        sql.SQLTable(db, "p", [("worker", int), ("v", int)])
        db.commit()

    def task(i):
        def run(d):
            for k in range(50):
                d.execute("INSERT INTO p (worker, v) VALUES (?, ?)", (i, k))
            d.commit()
            return i
        return lambda con: con.do_pool_safe(run)

    with pool.SQLDBConPool(4, path) as p:
        done = [f.result(timeout=30) for f in [p.enqueue(task(i)) for i in range(16)]]
    with sql.SQLDB(path) as db:
        return done, db.query("SELECT worker, v FROM p ORDER BY worker, v")


@pytest.mark.parametrize("case", [typed_table, bulk_inserter, rectangle_index, pool_inserts],
                         ids=lambda c: c.__name__)
def test_sql_layer_as_ma_tpu(case, tmp_path):
    both(case, tmp_path)


def test_closed_pool_refuses_as_ma_tpu(tmp_path):
    def closed(pkg, tmp_path):
        p = mod(pkg, "db.pool").SQLDBConPool(1, str(tmp_path / f"{pkg}.db"))
        p.close()
        with pytest.raises(RuntimeError) as ex:
            p.enqueue(lambda con: None)
        return str(ex.value)

    assert both(closed, tmp_path) == "pool closed"


def test_rectangle_query_without_index_raises_as_ma_tpu():
    def unindexed(pkg):
        sql = mod(pkg, "db.sql_api")
        with sql.SQLDB() as db:
            t = sql.SQLTable(db, "u", [("x", int)])
            with pytest.raises(RuntimeError) as ex:
                t.select_rectangle(0, 1, 0, 1)
            return str(ex.value)

    assert both(unindexed) == "no spatial index on u"


# --------------------------------------------------------------- SvDb
def svdb_reads(pkg, tmp_path):
    nucseq = mod(pkg, "containers.nucseq")
    rng = np.random.default_rng(3)
    codes = [np.array([0, 1, 2, 3, 4, 4, 0, 1, 2, 3, 0, 1, 2, 3], np.uint8),
             np.array([3, 3, 3, 3], np.uint8),
             rng.integers(0, 5, 1000).astype(np.uint8)]
    with mod(pkg, "msv.sv_db").SvDb(str(tmp_path / f"{pkg}.db")) as sv:
        seq_id = sv.new_sequencer("seq0")
        reads = [nucseq.NucSeq(c, name=f"r{i}") for i, c in enumerate(codes)]
        ids = sv.insert_reads(seq_id, reads)
        pairs = sv.insert_paired_reads(seq_id, [(reads[0], reads[1])])
        got = [(g.id, g.name, g.codes.tolist()) for g in sv.fetch_reads(seq_id)]
        every = [g.id for g in sv.fetch_reads()]
        other = list(sv.fetch_reads(seq_id + 1))
    assert ids == [1, 2, 3] and got[0][2] == codes[0].tolist()
    assert got[2][2] == codes[2].tolist()
    return ids, pairs, got, every, other


def svdb_jumps_and_calls(pkg, tmp_path):
    """tests/test_sv_db.py's jumps and calls round trip, every field."""
    jumps_mod, calls_mod = mod(pkg, "msv.jumps"), mod(pkg, "msv.calls")
    rng = np.random.default_rng(1)
    jumps = [
        jumps_mod.SvJump(
            from_pos=int(a), to_pos=int(b), query_from=int(q), query_to=int(q) + 20,
            from_forward=bool(a % 2), to_forward=bool(b % 3), num_supporting_nt=20,
            read_id=int(i), was_mirrored=bool(i % 3 == 0), id=int(i) + 100)
        for i, (a, b, q) in enumerate(rng.integers(0, 10000, (100, 3)))
    ]
    calls = [
        calls_mod.SvCall(from_pos=100, to_pos=300, from_size=5, to_size=7, supp_reads=3,
                         supp_nt=60, inserted_sequence=np.array([0, 1, 2, 3], np.uint8),
                         supporting_jump_ids=[1, 2, 3], from_forward=False,
                         reference_ambiguity=4, order_id=2, ctg_order_id=1, mirrored=True),
        calls_mod.SvCall(from_pos=5000, to_pos=6000, supp_reads=1, supp_nt=9),
    ]
    with mod(pkg, "msv.sv_db").SvDb(str(tmp_path / f"{pkg}.db")) as sv:
        run = sv.new_run("test", "desc")
        sv.insert_jumps(run, jumps)
        sv.create_jump_indices(run)
        back = sv.load_jumps(run)
        # every field survives but the id, which is the row's
        assert [r[:-2] for r in rows(back)] == [r[:-2] for r in rows(jumps)]
        assert [j.id for j in back] == list(range(1, 101))
        sections = []
        for start, end in ((2000, 4000), (0, 1), (9000, 20000)):
            sec = sv.jumps_in_section(run, start, end)
            brute = sorted((min(j.from_pos, j.to_pos), j.id - 99) for j in jumps
                           if min(j.from_pos, j.to_pos) < end
                           and max(j.from_pos, j.to_pos) >= start)
            assert [(min(j.from_pos, j.to_pos), j.id) for j in sec] == brute
            sections.append(rows(sec))
        ids = sv.insert_calls(run, calls)
        sv.create_call_indices(run)
        loaded = sv.load_calls(run)
        assert [c.id for c in loaded] == ids
        assert rows(loaded) == rows(convert_ids(calls, ids))
        assert loaded[1].inserted_sequence is None
        hit = sv.calls_overlapping(run, 0, 200, 0, 400)
        assert [c.id for c in hit] == [ids[0]]
        ranged = sv.load_calls(run, from_range=(4000, 7000), to_range=(5000, 6001))
        assert [c.id for c in ranged] == [ids[1]]
        return (rows(back), sections, rows(loaded), rows(hit), rows(ranged),
                rows(sv.calls_overlapping(run + 1, 0, 10_000, 0, 10_000)))


def convert_ids(calls, ids):
    """The calls as SvDb returns them: each with its row id, and its
    supporting jump ids in id order (load_calls sorts them, in ma_tpu too)."""
    return [dataclasses.replace(c, id=i, supporting_jump_ids=sorted(c.supporting_jump_ids))
            for c, i in zip(calls, ids)]


def svdb_restartable(pkg, tmp_path):
    """Run-id model: state survives reopening the file."""
    path = str(tmp_path / f"{pkg}.db")
    sv_db, jumps_mod = mod(pkg, "msv.sv_db"), mod(pkg, "msv.jumps")
    with sv_db.SvDb(path) as sv:
        run = sv.new_run("stage1")
        sv.insert_jumps(run, [jumps_mod.SvJump(
            from_pos=1, to_pos=2, query_from=0, query_to=5, from_forward=True,
            to_forward=True, num_supporting_nt=5, read_id=0)])
        sv.db.commit()
    with sv_db.SvDb(path) as sv:
        first = rows(sv.load_jumps(1))
        run2 = sv.new_run("stage2")
        names = sv.runs.select("id, name, desc", order="id")
    assert len(first) == 1 and run2 == 2
    return first, run2, names


@pytest.mark.parametrize("case", [svdb_reads, svdb_jumps_and_calls, svdb_restartable],
                         ids=lambda c: c.__name__)
def test_svdb_as_ma_tpu(case, tmp_path):
    both(case, tmp_path)


def test_svdb_drop_on_closure_as_ma_tpu(tmp_path):
    def dropped(pkg, tmp_path):
        path = str(tmp_path / f"{pkg}.db")
        sv = mod(pkg, "msv.sv_db").SvDb(path, drop_on_closure=True)
        sv.new_run("r")
        sv.close()
        sql = mod(pkg, "db.sql_api")
        with sql.SQLDB(path) as db:
            return [db.has_table(t) for t in ("sv_jump_table", "sv_call_table", "read_table")]

    assert both(dropped, tmp_path) == [False, False, False]


@pytest.fixture(scope="module")
def cpu_batch():
    """A CPU JumpBatch of the port's SV caller over sv_genome(2025): 700 bp
    reads tiled every 60 bp at 1% substitutions, every second one reverse
    complemented."""
    from ma_tpu_torch.containers.nucseq import NucSeq
    from ma_tpu_torch.index.minimizer import MinimizerIndex
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch, sweep_sv_jumps

    g, donor = sv_genome(2025)
    pack = pack_of("ma_tpu_torch", g)
    rng = np.random.default_rng(5)
    reads = []
    for p in range(0, len(donor) - 700, 60):
        r = donor[p : p + 700].copy()
        sub = rng.random(700) < 0.01
        r[sub] = (r[sub] + 1) % 4
        reads.append(r)
    reads[1::2] = [(3 - r)[::-1].copy() for r in reads[1::2]]
    jb = compute_sv_jumps_batch([NucSeq(r, name=f"r{i}") for i, r in enumerate(reads)], pack,
                                MinimizerIndex.build(pack), device="cpu")
    calls = sweep_sv_jumps(jb)
    assert len(jb) > 1000 and len(calls) >= 3
    return jb, calls


def test_svdb_round_trip_of_a_jump_batch(cpu_batch, tmp_path):
    """The JumpBatch's jumps through SvDb in each package: the loaded jumps
    equal the stored list field by field (ids become row ids, in order),
    and sweep_sv_jumps on them gives the in-memory sweep's calls, the
    supporting jump ids mapped to row ids; then the calls survive
    insert_calls / load_calls / calls_overlapping."""
    jb, mem_calls = cpu_batch
    stored = jb.to_jumps()
    out = {}
    for pkg in PKGS:
        sweep = mod(pkg, "msv.pipeline").sweep_sv_jumps
        with mod(pkg, "msv.sv_db").SvDb(str(tmp_path / f"{pkg}.db")) as sv:
            run = sv.new_run("jumps")
            sv.insert_jumps(run, convert(stored, pkg))
            sv.create_jump_indices(run)
            loaded = sv.load_jumps(run, params=convert(jb.params, pkg))
            # every field but the id, which becomes the row's, in order
            assert ([r[:-2] + r[-1:] for r in rows(loaded)]
                    == [r[:-2] + r[-1:] for r in rows(stored)])
            to_row = {j.id: r.id for j, r in zip(stored, loaded)}
            assert sorted(to_row.values()) == list(range(1, len(stored) + 1))
            calls = sweep(loaded)
            want = [dataclasses.replace(c, supporting_jump_ids=[
                to_row[i] for i in c.supporting_jump_ids]) for c in mem_calls]
            assert rows(calls) == rows(want)
            ids = sv.insert_calls(run, calls)
            sv.create_call_indices(run)
            assert rows(sv.load_calls(run)) == rows(convert_ids(calls, ids))
            for c, i in zip(calls, ids):
                hit = sv.calls_overlapping(run, c.from_pos, c.from_pos + 1, c.to_pos,
                                           c.to_pos + 1)
                assert i in [h.id for h in hit]
            out[pkg] = (rows(loaded), rows(calls), rows(sv.load_calls(run)))
    assert out["ma_tpu_torch"] == out["ma_tpu"]


# ---------------------------------------------------------- pledge graph
def lazy_memoized_get(ms):
    calls = []

    def f(x):
        calls.append(x)
        return x * 2

    p = ms.promise_me(ms.FunctionModule(f), ms.value_pledge(21))
    got = [p.get(), p.get(), list(calls)]
    p.reset()
    return got + [p.get(), calls]


def reset_invalidates_downstream(ms):
    a = ms.value_pledge(1)
    b = ms.promise_me(ms.FunctionModule(lambda x: x + 1), a)
    c = ms.promise_me(ms.FunctionModule(lambda x: x * 10), b)
    first = c.get()
    a.set(5)
    a.reset()
    return first, c.get()


def volatile_stream_to_collector(ms):
    col = ms.Collector()
    stream = ms.promise_me(ms.Splitter(range(5)))
    sink = ms.promise_me(col, ms.promise_me(ms.FunctionModule(lambda x: x * x), stream))
    ms.simultaneous_get([sink], n_threads=0)
    return col.collected


def lock_unlock_pins_value(ms):
    locked = ms.promise_me(ms.Lock(), ms.promise_me(ms.Splitter(range(4))))
    a = ms.promise_me(ms.FunctionModule(lambda x: ("a", x)), locked)
    b = ms.promise_me(ms.FunctionModule(lambda x: ("b", x)), locked)
    col = ms.Collector()
    joined = ms.promise_me(ms.FunctionModule(lambda u, v: (u, v)), a, b)
    sink = ms.promise_me(ms.UnLock(locked), ms.promise_me(col, joined))
    ms.simultaneous_get([sink], n_threads=0)
    assert all(u[1] == v[1] for u, v in col.collected)
    return col.collected


def replicas_share_splitter(ms):
    stream = ms.promise_me(ms.Splitter(range(100)))
    col = ms.Collector()
    sinks = ms.parallel_graph(4, lambda i: ms.promise_me(
        col, ms.promise_me(ms.FunctionModule(lambda x: x + 1), stream)))
    ms.simultaneous_get(sinks)
    return sorted(col.collected)


def cyclic_queue_drains(ms):
    q = ms.CyclicQueue([iter(range(0, 5)), iter(range(10, 13)), iter(range(20, 24))])
    col = ms.Collector()
    sinks = ms.parallel_graph(3, lambda i: ms.promise_me(col, ms.promise_me(ms.QueuePicker(q))))
    ms.simultaneous_get(sinks)
    return sorted(col.collected)


def join_and_tuple_get(ms):
    j = ms.promise_me(ms.Join(), ms.value_pledge(1), ms.value_pledge("x"))
    return j.get(), ms.promise_me(ms.TupleGet(1), j).get()


def eof_propagates(ms):
    """A dry volatile source gives EOF downstream without running modules."""
    ran = []
    src = ms.promise_me(ms.Splitter([]))
    p = ms.promise_me(ms.FunctionModule(lambda x: ran.append(x)), src)
    return p.get() is ms.EOF, ran


def exec_timers(ms):
    p = ms.promise_me(ms.FunctionModule(lambda: time.sleep(0.01) or 7))
    value = p.get()
    assert p.exec_time >= 0.01
    table = ms.analyze_graph_runtimes([p])
    return value, "FunctionModule" in table


@pytest.mark.parametrize("case", [
    lazy_memoized_get, reset_invalidates_downstream, volatile_stream_to_collector,
    lock_unlock_pins_value, replicas_share_splitter, cyclic_queue_drains, join_and_tuple_get,
    eof_propagates, exec_timers], ids=lambda c: c.__name__)
def test_pledge_graph_as_ma_tpu(case):
    out = {pkg: case(importlib.import_module(f"{pkg}.ms")) for pkg in PKGS}
    assert out["ma_tpu_torch"] == out["ma_tpu"]


def race_check(ms):
    shared = ms.promise_me(ms.FunctionModule(lambda: object()))
    shared._build_thread = 0  # built inside replica 0
    ms.parallel_graph(2, lambda i: ms.promise_me(ms.FunctionModule(lambda x: x), shared))


def exception_cancels_workers(ms):
    stream = ms.promise_me(ms.Splitter(range(1000)))

    def boom(x):
        if x == 5:
            raise ValueError("boom")
        return x

    sinks = ms.parallel_graph(3, lambda i: ms.promise_me(ms.FunctionModule(boom), stream))
    ms.simultaneous_get(sinks)


@pytest.mark.parametrize("case,exc", [(race_check, RuntimeError),
                                      (exception_cancels_workers, ValueError)],
                         ids=["race_check", "exception_cancels_workers"])
def test_pledge_graph_raises_as_ma_tpu(case, exc):
    got = {}
    for pkg in PKGS:
        with pytest.raises(exc) as ex:
            case(importlib.import_module(f"{pkg}.ms"))
        got[pkg] = str(ex.value)
    assert got["ma_tpu_torch"] == got["ma_tpu"]
    assert "race check" in got["ma_tpu"] or got["ma_tpu"] == "boom"
    assert threading.active_count() < 50
