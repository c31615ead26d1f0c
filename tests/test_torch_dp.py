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
        cig = TD.packed_runs_to_cigars(tr.numpy(), tc[0])
        assert cig == JD.packed_runs_to_cigars(np.asarray(jr), np.asarray(jc[0]))


@pytest.mark.parametrize("is_global", [True, False])
def test_run_overflow_redo_matches_ma_tpu(is_global, monkeypatch):
    """Problems whose runs overflow kernel C's run buffer (forced with
    R = 4) are redone through kernel D + the traceback kernel: the cigars of
    the native path's redo_one and of the Python path's _redo_batched equal
    ma_tpu's _redo_one (MA_TPU_DP=fused: the XLA anti-diagonal DP)."""
    from ma_tpu.containers.pack import Pack as JPack
    from ma_tpu.pipeline.nw import DPProblem as JProblem
    from ma_tpu.pipeline.nw import NWAligner as JNW
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.pipeline.nw import DPProblem, NWAligner, NWConfig

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

    jpack, pack = JPack.empty(), Pack.empty()
    jpack.append("g", text)
    pack.append("g", text)
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
    nw = NWAligner(pack, NWConfig(), torch.as_tensor(text), torch.as_tensor(seqs), text, seqs)
    got = [nw.redo_one(DPProblem.from_desc(desc[k], is_global)) for k in over]
    assert got == want and all(len(c) > 4 for c in got)
    # a problem that carries its own host operands
    own = []
    for k in over:
        p = DPProblem.from_desc(desc[k], is_global)
        p.q, p.t = (a.numpy()[k, : int(n[k])] for a, n in ((q, qlen), (t, tlen)))
        p.read_idx = -1
        own.append(nw.redo_one(p))
    assert own == want
    nw._problems = [DPProblem.from_desc(desc[k], is_global) for k in over]
    for p in nw._problems:
        p.max_i = 0  # the fused forward pass's end cell: kept, only the cigar is redone
    nw._redo_batched(range(len(over)))
    assert [p.cigar for p in nw._problems] == want
    assert all(p.max_i == 0 for p in nw._problems)


# ---- kernel C' (ma_tpu's _kernel_v2, under MA_TPU_DP_V2=1)
@pytest.fixture
def v2_traces(monkeypatch):
    """MA_TPU_DP_V2=1 on both sides, with a count of ma_tpu's _kernel_v2
    traces; jax's caches are cleared around it (ma_tpu reads the variable
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
    """The port's banded_align_runs under MA_TPU_DP_V2=1 (C's plain
    version: the contract is the same) against _kernel_v2 in interpret
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


def test_v2_selection_matches_ma_tpu(monkeypatch):
    """use_v2 is ma_tpu's condition without its PB2 >= 32 term, which holds
    for every fused bucket up to (256, 4096) (PB2 = 64 there) and for any
    shape, as _pick_pb_v2 never goes below 32."""
    from ma_tpu.ops import dp_fused as JF
    from ma_tpu_torch.ops import dp_fused as TF

    for M in (32, 64, 256):
        for N in (128, 768, 4096):
            for sb in (2, 4):
                assert JF._pick_pb_v2(M, N, sb) >= 32
    assert JF._pick_pb_v2(256, 4096) == 64
    assert JF._pick_pb_v2(16384, 65536) == 32
    for flag in ("0", "1"):
        monkeypatch.setenv("MA_TPU_DP_V2", flag)
        for N in list(range(1, 1100)) + [1152, 1536, 2048, 2304, 3072, 3968, 4096, 16384]:
            tj = JF._pick_tj_v2(N)
            assert TF._pick_tj_v2(N) == tj
            want = flag == "1" and N % tj == 0 and N // tj <= 8 and JF._pick_pb_v2(256, N) >= 32
            assert TF.use_v2(N) == want, N
    assert all(TF.use_v2(N) for N in range(1, 20_000))  # the tile terms always hold
