"""ma_tpu_torch fused DP (kernel C's plain version: dp_rows forward +
traceback + run packing) against ma_tpu's fused Pallas kernel in interpret
mode, and the descriptor-mode entry against ma_tpu's. Exact equality, with
one exception named below: where lastrow_max is NEG_INF (no undropped cell
in the last row), the Pallas kernel leaves the first lane of its first
tile in lastrow_arg and the port 0."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.ops import dp as JD  # noqa: E402
from ma_tpu.ops.dp_fused import banded_align_runs as pallas_runs  # noqa: E402
from ma_tpu_torch.ops import dp as TD  # noqa: E402
from ma_tpu_torch.ops.dp_fused import banded_align_runs, banded_align_runs_plain  # noqa: E402
from ma_tpu_torch.pipeline.nw import fused_results  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

NEG = -(2**30)


def _problems(seed, P, M, N, is_global):
    """Targets are mutated copies of the queries (substitutions, indels,
    Ns) with random flanks; every sixth query uses two letters only (score
    ties); every fifth extension target turns random after a few bases
    (z-drop); every fourth extension problem traces back from its last
    row."""
    rng = np.random.default_rng(seed)
    q = np.full((P, M), 4, np.int32)
    t = np.full((P, N), 4, np.int32)
    qlen = rng.integers(1, M + 1, P).astype(np.int32)
    tlen = np.zeros(P, np.int32)
    for p in range(P):
        qs = rng.integers(0, 2 if p % 6 == 3 else 4, qlen[p])
        qs[rng.random(qlen[p]) < 0.02] = 4
        q[p, : qlen[p]] = qs
        r = rng.random(qlen[p])
        keep = r >= 0.04
        ts = np.where(r < 0.12, rng.integers(0, 4, qlen[p]), qs)[keep]
        ins = np.flatnonzero((r > 0.96)[keep]) + 1
        ts = np.insert(ts, ins, rng.integers(0, 4, len(ins)))
        if not is_global and p % 5 == 0:
            ts[min(len(ts), 6):] = rng.integers(0, 4, max(0, len(ts) - 6))
        ts = np.concatenate([ts, rng.integers(0, 4, rng.integers(0, N // 2))])
        n = max(1, min(N, len(ts)))
        t[p, :n] = ts[:n]
        tlen[p] = n
    band = (np.maximum(20, np.abs(tlen - qlen) + 10) if is_global
            else np.full(P, 64)).astype(np.int32)
    tb_last = np.zeros(P, np.int32) if is_global else (np.arange(P) % 4 == 1).astype(np.int32)
    return q, t, qlen, tlen, band, tb_last


def _compare(M, N, is_global, zdrop, R, seed, P=40):
    return _compare_on(_problems(seed, P, M, N, is_global), M, N, is_global, zdrop, R)


def _compare_on(problems, M, N, is_global, zdrop, R):
    q, t, qlen, tlen, band, tb_last = problems
    params = JD.DPParams()
    jr, jm = pallas_runs(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
                         jnp.asarray(band), M=M, N=N, params=params, zdrop=zdrop,
                         is_global=is_global, interpret=True, tb_last=jnp.asarray(tb_last), R=R)
    tr, tm = banded_align_runs(
        torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(qlen), torch.as_tensor(tlen),
        torch.as_tensor(band), M=M, N=N, params=TD.DPParams(*params), zdrop=zdrop,
        is_global=is_global, tb_last=torch.as_tensor(tb_last), R=R)
    jr, jm, tr, tm = np.asarray(jr), np.asarray(jm), tr.numpy(), tm.numpy()
    assert np.array_equal(jm[:7], tm[:7])
    lr_ok = jm[6] > NEG
    assert np.array_equal(jm[7][lr_ok], tm[7][lr_ok])
    assert (tm[7][~lr_ok] == (0 if not (is_global and zdrop < 0) else -1)).all()
    assert np.array_equal(jr, tr)
    return jm


@pytest.mark.parametrize("M,N", [(32, 128), (64, 128)])
def test_global(M, N):
    _compare(M, N, True, -1, TD.run_capacity(M), seed=M)


@pytest.mark.parametrize("M,N", [(32, 128), (64, 128)])
def test_extension_zdrop_tb_last(M, N):
    meta = _compare(M, N, False, 10, TD.run_capacity(M), seed=M + 1)
    assert meta[4].any()  # some problems z-dropped


# extension problems whose best cell ties with a cell of a later row on the
# same anti-diagonal (the earlier row keeps the max cell)
TIES = [
    ([0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1],
     [1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 1]),
    ([0, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0],
     [0, 1, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0]),
    ([1, 1, 0, 1, 0, 1, 1, 0, 0], [1, 0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1]),
]


def test_max_cell_anti_diagonal_ties():
    P, M, N = len(TIES), 32, 128
    q = np.full((P, M), 4, np.int32)
    t = np.full((P, N), 4, np.int32)
    for p, (qs, ts) in enumerate(TIES):
        q[p, : len(qs)], t[p, : len(ts)] = qs, ts
    lens = [np.asarray([len(x[k]) for x in TIES], np.int32) for k in (0, 1)]
    problems = (q, t, *lens, np.full(P, 64, np.int32), np.zeros(P, np.int32))
    meta = _compare_on(problems, M, N, False, -1, 32)
    assert meta[2].tolist() == [3, 6, 4] and meta[3].tolist() == [4, 8, 5]


@pytest.mark.parametrize("is_global", [True, False])
def test_run_overflow(is_global):
    """R = 4 runs: most problems overflow; stored runs, counts and the
    overflow flag still agree (later same-op emits merge into run R-1)."""
    meta = _compare(64, 128, is_global, -1 if is_global else 200, 4, seed=9)
    assert meta[5].sum() >= 5


def test_plain_is_the_cpu_route():
    """The wrapper runs the plain version for CPU tensors."""
    q, t, qlen, tlen, band, tb_last = (torch.as_tensor(a) for a in _problems(2, 8, 32, 128, False))
    kw = dict(M=32, N=128, zdrop=200, is_global=False, tb_last=tb_last, R=32)
    a = banded_align_runs(q, t, qlen, tlen, band, **kw)
    b = banded_align_runs_plain(q, t, qlen, tlen, band, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_desc_mode_matches():
    """Descriptor operands and the descriptor-mode fused DP entry: runs and
    meta as ma_tpu returns them (ma_tpu ships comb as int16 with the meta
    clipped to its range; the port keeps int32)."""
    rng = np.random.default_rng(11)
    B, L, T = 6, 256, 5000
    seqs = rng.integers(0, 5, (B, L)).astype(np.uint8)
    text = rng.integers(0, 4, T).astype(np.uint8)
    P, M, N = 24, 64, 128
    q_len = rng.integers(1, M + 1, P)
    t_len = rng.integers(1, N + 1, P)
    desc = np.stack([
        rng.integers(0, B, P), rng.integers(0, L - M, P), q_len, rng.integers(0, 2, P),
        rng.integers(0, T - N, P), t_len, rng.integers(0, 2, P), np.full(P, 40),
    ]).astype(np.int32)
    jq, jt, *_ = JD._desc_operands(jnp.asarray(text), jnp.asarray(seqs), jnp.asarray(desc), M, N)
    tq, tt, *_ = TD._desc_operands(torch.as_tensor(text), torch.as_tensor(seqs),
                                   torch.as_tensor(desc), M, N)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(jt), tt.numpy())
    for is_global, zdrop in ((True, -1), (False, 200)):
        jc, jr = JD._dp_desc_runs_fused(jnp.asarray(text), jnp.asarray(seqs), jnp.asarray(desc),
                                        M=M, N=N, params=JD.DPParams(), zdrop=zdrop,
                                        is_global=is_global, interpret=True)
        tc, tr = TD._dp_desc_runs_fused(torch.as_tensor(text), torch.as_tensor(seqs),
                                        torch.as_tensor(desc), M=M, N=N,
                                        params=TD.DPParams(), zdrop=zdrop, is_global=is_global)
        jc, tc = np.asarray(jc).astype(np.int64), tc.numpy()
        assert tc.dtype == np.int32 and tc.shape == jc.shape
        assert np.array_equal(jc[:7], np.clip(tc[:7], -32768, 32767))
        assert np.array_equal(jc[8:], tc[8:])
        assert np.array_equal(np.asarray(jr), tr.numpy())
        # the batch protocol's decode (comb whole, runs_t only past RUNS_HEAD)
        meta, fwd = fused_results(torch.as_tensor(tc), tr)
        assert np.array_equal(meta, tc[:8])
        cig = [[(v & 3, v >> 2) for v in fwd[k, : meta[0][k]].tolist()] for k in range(P)]
        assert cig == JD.packed_runs_to_cigars(np.asarray(jr), np.asarray(jc[0]))


@pytest.mark.parametrize("is_global", [True, False])
def test_run_overflow_redo_matches_ma_tpu(is_global, monkeypatch):
    """Problems whose runs overflow kernel C's run buffer (forced with
    R = 4) are redone through kernel D + the traceback kernel: the cigars of
    the batch protocol's redo, for a batch of one and for the whole batch,
    equal ma_tpu's _redo_one (MA_TPU_DP=fused: the XLA anti-diagonal DP);
    so do those `collect` returns for the overflowed rows of a dispatched
    batch, which keep the fused pass's max_i / max_j."""
    from ma_tpu.containers.pack import Pack as JPack
    from ma_tpu.pipeline.nw import DPProblem as JProblem
    from ma_tpu.pipeline.nw import NWAligner as JNW
    from ma_tpu_torch.pipeline import nw as TNW

    rng = np.random.default_rng(21)
    B, L, T, P, M, N = 2, 400, 4000, 10, 64, 128
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = rng.integers(0, 4, T).astype(np.uint8)
    desc = np.zeros((P, 8), np.int32)
    for k in range(P):
        q_off, q_rev, t_rev, t_start = int(rng.integers(0, L - M)), k % 2, (k // 2) % 2, 60 * k
        qs = seqs[k % B, q_off : q_off + M]
        qs = qs[::-1] if q_rev else qs
        r = rng.random(M)  # an indel every ~7 bases: many runs
        ts = np.insert(qs[r >= 0.07], np.flatnonzero(r[r >= 0.07] > 0.93),
                       rng.integers(0, 4, int((r[r >= 0.07] > 0.93).sum())))
        text[t_start : t_start + len(ts)] = ts[::-1] if t_rev else ts
        desc[k] = (k % B, q_off, M, q_rev, t_start, len(ts), t_rev, 40)
    d8 = torch.as_tensor(desc.T.copy())
    q, t, qlen, tlen, band = TD._desc_operands(torch.as_tensor(text), torch.as_tensor(seqs),
                                               d8, M, N)
    zdrop = -1 if is_global else 200
    _, meta = banded_align_runs(q, t, qlen, tlen, band, M=M, N=N, zdrop=zdrop,
                                is_global=is_global, R=4)
    over = np.flatnonzero(meta[5].numpy())
    assert len(over) >= P // 2

    jpack = JPack.empty()
    jpack.append("g", text)
    monkeypatch.setenv("MA_TPU_DP", "fused")
    jax.clear_caches()
    try:
        jnw = JNW(jpack, text_dev=jnp.asarray(text), seqs_dev=jnp.asarray(seqs))
        want = []
        for k in over:
            jnw._problems.append(JProblem(q=None, t=None, band=40, is_global=is_global,
                                          read_idx=int(desc[k, 0]), q_off=int(desc[k, 1]),
                                          q_len=M, q_rev=int(desc[k, 3]),
                                          t_start=int(desc[k, 4]), t_len=int(desc[k, 5]),
                                          t_rev=int(desc[k, 6])))
            want.append(jnw._redo_one(len(jnw._problems) - 1, is_global))
    finally:
        jax.clear_caches()
    cfg = TNW.NWConfig()
    isg = np.full(P, is_global)
    redo = lambda rows: TNW._redo_cigars(desc[rows], isg[rows], text, seqs, cfg,  # noqa: E731
                                         torch.device("cpu"))
    assert [redo([k])[0] for k in over] == want and all(len(c) > 4 for c in want)
    assert redo(over) == want
    # through dispatch and collect, with the fused kernel's run buffer cut to
    # 4: one redo call takes every overflowed row
    monkeypatch.setattr(TD, "run_capacity", lambda M: 4)
    calls, redo_cigars = [], TNW._redo_cigars
    monkeypatch.setattr(TNW, "_redo_cigars",
                        lambda d, *a: calls.append(d[:, 4].tolist()) or redo_cigars(d, *a))
    dp = TNW.dispatch(desc, isg, torch.as_tensor(text), torch.as_tensor(seqs), cfg)
    runs, off, got_meta = TNW.collect(dp, text, seqs)
    got = [[tuple(r) for r in runs[off[k] : off[k + 1]].tolist()] for k in over]
    assert got == want
    assert [sorted(c) for c in calls] == [sorted(desc[over, 4].tolist())]
    assert np.array_equal(got_meta.T, meta.numpy()[2:4])


# ---- kernel C' (ma_tpu's _kernel_v2, under MA_TPU_DP_V2=1)
@pytest.fixture
def v2_traces(monkeypatch):
    """MA_TPU_DP_V2=1 for ma_tpu, with a count of its _kernel_v2 traces (the
    port reads no such variable: on the CPU C and C' share one plain
    version); jax's caches are cleared around it (ma_tpu reads the variable
    while tracing, and the jitted entry keys only on its static args)."""
    from ma_tpu.ops import dp_fused as JF

    calls = []
    orig = JF._kernel_v2

    def counted(*args, **kw):
        calls.append(kw["N"])
        return orig(*args, **kw)

    monkeypatch.setattr(JF, "_kernel_v2", counted)
    monkeypatch.setenv("MA_TPU_DP_V2", "1")
    jax.clear_caches()
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("M,N,is_global,zdrop,P", [
    (32, 128, True, -1, 40), (32, 128, False, 10, 40), (64, 768, False, 200, 24),
    (32, 1024, False, 10, 16), (32, 2048, False, 10, 8),
])
def test_v2_matches_kernel_v2(v2_traces, M, N, is_global, zdrop, P):
    """The port's banded_align_runs (C's plain version: the contract is the
    same) against _kernel_v2 in interpret
    mode: runs and all 8 meta rows, lastrow_arg included. N = 1024 and 2048
    run 4 and 8 static tiles of 256; every fourth extension problem traces
    back from its last row."""
    from ma_tpu.ops.dp_fused import _pick_tj_v2

    problems = _problems(M + N, P, M, N, is_global)
    meta = _compare_on(problems, M, N, is_global, zdrop, TD.run_capacity(M))
    assert v2_traces == [N]
    assert N // _pick_tj_v2(N) == {128: 1, 768: 3, 1024: 4, 2048: 8}[N]
    q, t, qlen, tlen, band, tb_last = (torch.as_tensor(a) for a in problems)
    _, tm = banded_align_runs(q, t, qlen, tlen, band, M=M, N=N, zdrop=zdrop,
                              is_global=is_global, tb_last=tb_last, R=TD.run_capacity(M))
    assert np.array_equal(meta[7], tm.numpy()[7])  # _kernel_v2 writes 0 where C leaves a lane


def test_v2_zdrop_empties_the_last_row(v2_traces):
    """Z-drop ends most extensions before their last row: lastrow_max is
    NEG_INF there, and the last-row tracebacks of those problems are empty."""
    P, M, N = 48, 32, 128
    q, t, qlen, tlen, band, _ = _problems(77, P, M, N, False)
    t[:, 4:] = np.random.default_rng(77).integers(0, 4, (P, N - 4))
    tb_last = (np.arange(P) % 2).astype(np.int32)
    meta = _compare_on((q, t, qlen, tlen, band, tb_last), M, N, False, 5, 32)
    empty = meta[6] == NEG
    assert empty.sum() >= P // 3 and meta[4][empty].all()
    assert (meta[0][empty & (tb_last == 1)] == 0).all()
    assert v2_traces == [N]


def test_v2_selection_matches_ma_tpu():
    """C''s static tile width is ma_tpu's `_pick_tj_v2`."""
    from ma_tpu.ops import dp_fused as JF
    from ma_tpu_torch.ops import dp_fused as TF

    for N in list(range(1, 1100)) + [1152, 1536, 2048, 2304, 3072, 3968, 4096, 16384]:
        assert TF._pick_tj_v2(N) == JF._pick_tj_v2(N), N


@pytest.mark.parametrize("N", [1, 128, 768, 1024, 1025, 2048, 4096, 4097])
def test_fused_kernel_routing(N):
    """The card's kernel by width alone: C up to its 1,024 columns, C' for
    every wider N, global or extension. `c_fits` stands for C's
    scratch-size query, which says N <= 1,024 on the card."""
    from ma_tpu_torch.ops.dp_fused import fused_kernel

    assert fused_kernel(N, N <= 1024) == ("C" if N <= 1024 else "C'")


# each point with its neighbours: every rung edge of the fused ladders (M 32 /
# 64 / 256, N 128 / 768, M >= 64 at N = 768) and of kernel D's ladders, and
# past their tops
BUCKET_EDGES = {
    (32, 100): (32, 128), (64, 100): (64, 128), (256, 100): (256, 128),
    (32, 128): (32, 128), (20, 768): (64, 768), (64, 768): (64, 768),
    (256, 768): (256, 768), (256, 769): (256, 4096), (300, 300): (1024, 768),
    (16, 1000): (16, 4096), (1024, 50): (1024, 64), (300, 64): (1024, 64),
    (300, 256): (1024, 256), (4096, 4096): (4096, 4096), (16384, 16384): (16384, 16384),
    (200, 65536): (256, 65536), (16385, 65537): (32768, 131072),
}


@pytest.mark.parametrize("m,n", list(BUCKET_EDGES))
def test_bucket_shapes_match_ma_tpu(m, n):
    """The batch protocol's bucket rule at (m, n) and its neighbours against
    ma_tpu's `NWAligner._bucket_shape_fused`."""
    from ma_tpu.pipeline.nw import NWAligner as JNW
    from ma_tpu_torch.pipeline.nw import bucket_shapes

    pts = [(m + a, n + b) for a in (-1, 0, 1) for b in (-1, 0, 1) if m + a > 0 and n + b > 0]
    Mb, Nb = bucket_shapes([x for x, _ in pts], [y for _, y in pts])
    assert list(zip(Mb.tolist(), Nb.tolist())) == [JNW._bucket_shape_fused(x, y) for x, y in pts]
    assert JNW._bucket_shape_fused(m, n) == BUCKET_EDGES[m, n]


@pytest.mark.parametrize("is_global,zdrop,M,P", [
    (False, 5, 24, 6), (False, 200, 16, 4), (True, -1, 24, 5), (True, 30, 16, 4),
])
def test_fused_past_4096_columns(is_global, zdrop, M, P):
    """Fused problems 4,224 columns wide (C' walks such rows in chunks on
    the card) through the port's banded_align_runs against
    ma_tpu's tiled `_kernel` in interpret mode: extensions with z-drop and
    last-row tracebacks, and global problems with and without z-drop (those
    without went through kernel D on the card before)."""
    N = 4224
    q, t, qlen, tlen, band, tb_last = _problems(N + M + int(is_global), P, M, N, is_global)
    rng = np.random.default_rng(N)
    qlen[::5] = M  # problems 0 and 5 (their targets turn random early) z-drop
    for p in range(0, P, 2):  # targets reaching past the first 4,096 columns
        t[p, tlen[p]:] = rng.integers(0, 4, N - tlen[p])
        tlen[p] = N - p
    band = (np.maximum(band, np.abs(tlen - qlen) + 10) if is_global
            else np.full(P, N)).astype(np.int32)
    meta = _compare_on((q, t, qlen, tlen, band, tb_last), M, N, is_global, zdrop,
                       TD.run_capacity(M))
    if not is_global and zdrop == 5:
        assert meta[4].any()


@pytest.mark.parametrize("M,N,is_global,zdrop,band,P", [
    (24, 4224, True, -1, 30, 5), (32, 768, True, 30, 20, 12), (24, 4224, False, 30, 5000, 4),
    (32, 200, False, 0, 64, 12),
])
def test_fused_band_edges(M, N, is_global, zdrop, band, P):
    """The cases C''s band skipping singles out on the card, through the
    port's banded_align_runs (its plain version) against ma_tpu's fused
    kernel in interpret mode: global problems whose end cell lies outside a
    narrow band (|m - n| > band: every cell computed), a band wider than
    one chunk of C''s rows (1,024 columns), z-drops in the first rows."""
    q, t, qlen, tlen, _, tb_last = _problems(N + M + band, P, M, N, is_global)
    if is_global:
        tlen[: P - 1] = np.minimum(N, qlen[: P - 1] + band + 1 + np.arange(P - 1) * 7)
        assert (np.abs(tlen - qlen) > band).sum() >= P - 1
    meta = _compare_on((q, t, qlen, tlen, np.full(P, band, np.int32), tb_last), M, N,
                       is_global, zdrop, TD.run_capacity(M))
    if zdrop == 0:
        assert meta[4].any()


def _pack_runs_scalar(ops, n_ops, fi, fj, started, R):
    """One problem at a time: emit each op, then fi + 1 inserts and fj + 1
    deletions, merging into the last stored run where the op is its op."""
    P = len(n_ops)
    runs = np.zeros((P, R), np.int64)
    cnt, over = np.zeros(P, np.int64), np.zeros(P, bool)
    for p in range(P):
        last = -1
        items = [(int(o), 1) for o in ops[p, : n_ops[p]]]
        if started[p]:
            items += [(TD.OP_I, fi[p] + 1), (TD.OP_D, fj[p] + 1)]
        for op, ln in items:
            if ln <= 0:
                continue
            if cnt[p] and op == last:
                runs[p, cnt[p] - 1] += 4 * ln
            elif cnt[p] >= R:
                over[p] = True
            else:
                runs[p, cnt[p]] = 4 * ln + op
                cnt[p] += 1
                last = op
    return runs, cnt, over


@pytest.mark.parametrize("seed", range(4))
def test_pack_runs_matches_scalar_emit(seed):
    """pack_runs (run packing on whole tensors) against the fused kernels'
    emit order done one op at a time, with run overflow and merges into the
    last stored run after it."""
    from ma_tpu_torch.ops.dp_fused import pack_runs

    rng = np.random.default_rng(seed)
    P, S = 40, 48
    ops = np.repeat(rng.integers(0, 3, (P, S)), rng.integers(1, 4), 1)[:, :S]
    n_ops = rng.integers(0, S + 1, P)
    ops = np.where(np.arange(S)[None, :] < n_ops[:, None], ops, TD.OP_NONE).astype(np.uint8)
    fi, fj = rng.integers(-1, 4, P), rng.integers(-1, 4, P)
    started = rng.random(P) < 0.8
    for R in (1, 3, 8, 32):
        got = pack_runs(torch.as_tensor(ops), torch.as_tensor(n_ops), torch.as_tensor(fi),
                        torch.as_tensor(fj), torch.as_tensor(started), R)
        want = _pack_runs_scalar(ops, n_ops, fi, fj, started, R)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), b)
        assert R == 32 or want[2].any()
