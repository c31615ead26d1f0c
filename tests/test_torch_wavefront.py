"""ma_tpu_torch's wavefront DP (kernel D's plain version) and its traceback
against ma_tpu's XLA `banded_align` / `traceback_device` and the Pallas
wavefront kernel in interpret mode; the descriptor-mode entry and the host
decoders against ma_tpu's. Exact equality everywhere."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.ops import dp as JD  # noqa: E402
from ma_tpu.ops.dp_pallas import banded_align_pallas  # noqa: E402
from ma_tpu_torch.ops import dp as TD  # noqa: E402
from ma_tpu_torch.ops.dp_wavefront import (  # noqa: E402
    banded_align_wavefront,
    banded_align_wavefront_plain,
    traceback_dirs,
    traceback_dirs_plain,
    wavefront_book_from_keys,
    wavefront_diagonal_maxima_plain,
)

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)


def _problems(seed, P=8, M=32, N=64):
    """tests/test_dp_pallas.py's inputs, plus Ns, a two-letter query (score
    ties) and a target that turns random after a few bases (z-drop)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (P, M)).astype(np.uint8)
    t = rng.integers(0, 4, (P, N)).astype(np.uint8)
    for p in range(0, P, 2):
        t[p, 10 : 10 + M] = q[p]
    q[1] = rng.integers(0, 2, M)
    t[1, :M] = np.where(rng.random(M) < 0.9, q[1], 1 - q[1])
    q[3, 5:8] = 4
    t[4, 14:16] = 4
    t[6, 16:] = rng.integers(0, 4, N - 16)
    qlen = rng.integers(8, M + 1, P).astype(np.int32)
    tlen = rng.integers(16, N + 1, P).astype(np.int32)
    band = np.full(P, 64, np.int32)
    band[5] = 6  # a narrow band: the end cell of a global problem may fall outside
    return q, t, qlen, tlen, band


def _torch(*arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


CASES = [(True, -1), (False, 200), (False, 10)]


@pytest.mark.parametrize("is_global,zdrop", CASES)
def test_wavefront_matches_xla_and_pallas(is_global, zdrop):
    q, t, qlen, tlen, band = _problems(0)
    ref = JD.banded_align(q, t, qlen, tlen, band, JD.DPParams(), zdrop=zdrop,
                          is_global=is_global)
    pal = banded_align_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
                              jnp.asarray(tlen), jnp.asarray(band), params=JD.DPParams(),
                              zdrop=zdrop, is_global=is_global, interpret=True)
    got = banded_align_wavefront(*_torch(q, t, qlen, tlen, band), TD.DPParams(), zdrop,
                                 is_global)
    for want in (ref, pal):
        assert np.array_equal(np.asarray(want.dirs), got.dirs.numpy())
        for f in ("score", "max_i", "max_j", "zdropped"):
            assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f
    if zdrop == 10:
        assert got.zdropped.any() and not got.zdropped.all()


@pytest.mark.parametrize("is_global,zdrop", CASES)
@pytest.mark.parametrize("seed", [0, 3])
def test_book_rebuilt_from_diagonal_maxima(is_global, zdrop, seed):
    """Kernel D's post-sweep book: each diagonal's (maximum, first maximal
    lane), folded by a prefix argmax with strict > and the first drop
    diagonal, gives exactly the plain version's score (extension), max_i,
    max_j and zdropped, and so ma_tpu's."""
    q, t, qlen, tlen, band = _problems(seed)
    args = _torch(q, t, qlen, tlen, band)
    want = banded_align_wavefront_plain(*args, TD.DPParams(), zdrop, is_global)
    dmax, darg = wavefront_diagonal_maxima_plain(*args, TD.DPParams(), zdrop, is_global)
    gmax, gi, gj, dropped = wavefront_book_from_keys(
        dmax, darg, *args[2:], M=q.shape[1], params=TD.DPParams(), zdrop=zdrop,
        is_global=is_global)
    ref = JD.banded_align(q, t, qlen, tlen, band, JD.DPParams(), zdrop=zdrop,
                          is_global=is_global)
    for got, w, r in ((gi, want.max_i, ref.max_i), (gj, want.max_j, ref.max_j),
                      (dropped, want.zdropped, ref.zdropped)):
        assert torch.equal(got, w) and np.array_equal(got.numpy(), np.asarray(r))
    if not is_global:
        assert torch.equal(gmax, want.score)
    if zdrop == 10 and seed == 0:  # some problems drop, some do not
        assert dropped.any() and not dropped.all()


def test_plain_is_the_cpu_route():
    args = _torch(*_problems(1))
    a = banded_align_wavefront(*args, TD.DPParams(), 200, False)
    b = banded_align_wavefront_plain(*args, TD.DPParams(), 200, False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    si, sj = a.max_i, a.max_j
    assert all(torch.equal(x, y) for x, y in zip(traceback_dirs(a.dirs, si, sj),
                                                 traceback_dirs_plain(a.dirs, si, sj)))


@pytest.mark.parametrize("is_global,zdrop", CASES)
def test_traceback_matches_traceback_device_and_one(is_global, zdrop):
    q, t, qlen, tlen, band = _problems(2)
    res = JD.banded_align(q, t, qlen, tlen, band, JD.DPParams(), zdrop=zdrop,
                          is_global=is_global)
    dirs = np.asarray(res.dirs)
    if is_global:
        si, sj = qlen - 1, tlen - 1
    else:
        si, sj = np.asarray(res.max_i).copy(), np.asarray(res.max_j).copy()
        si[7] = -1  # a skipped problem
    want = JD.traceback_device(jnp.asarray(dirs), jnp.asarray(si), jnp.asarray(sj))
    got = traceback_dirs(*_torch(dirs, si.astype(np.int32), sj.astype(np.int32)))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    ops, n_ops, rem_i, rem_j = (g.numpy() for g in got)
    for p in range(len(q)):
        cig = TD.rle_ops(ops[p], int(n_ops[p]), int(rem_i[p]), int(rem_j[p]))
        assert cig == JD.rle_ops(ops[p], int(n_ops[p]), int(rem_i[p]), int(rem_j[p]))
        if si[p] >= 0:
            assert cig == TD.traceback_one(dirs[p], int(si[p]), int(sj[p]))
            assert cig == JD.traceback_one(dirs[p], int(si[p]), int(sj[p]))
    assert TD.rle_ops_batch(ops, n_ops, rem_i, rem_j) == JD.rle_ops_batch(ops, n_ops, rem_i,
                                                                           rem_j)


def _random_dirs(rng, P, M, N, p_diag, p_cont):
    """Direction bytes [P, M+N-1, M] for the traceback alone: source 0 (the
    diagonal) with probability p_diag, else 1-7; each continuation bit set
    with probability p_cont, so gap runs last about 1 / (1 - p_cont) cells."""
    shape = (P, M + N - 1, M)
    src = np.where(rng.random(shape) < p_diag, 0, rng.integers(1, 8, shape))
    bits = (rng.random(shape + (4,)) < p_cont) @ np.array([0x08, 0x10, 0x20, 0x40])
    return (src | bits).astype(np.uint8)


def _longest_gap_run(ops, n_ops):
    """The longest run of I or D ops over the problems' op streams."""
    best = 0
    for row, n in zip(ops, n_ops):
        run, last = 0, -1
        for op in row[:n]:
            run = run + 1 if op == last else 1
            last = op
            if op != TD.OP_M:
                best = max(best, run)
    return best


@pytest.mark.parametrize("P,M,N,p_diag,p_cont", [
    (12, 37, 120, 0.8, 0.995), (12, 70, 33, 0.5, 0.995), (8, 1, 40, 0.5, 0.99),
])
def test_traceback_long_runs_match_traceback_device(P, M, N, p_diag, p_cont):
    """The cases the warp-per-problem traceback kernel singles out, through
    the port's traceback (its plain version on the CPU) and ma_tpu's
    traceback_device: random direction bytes with diagonal runs of tens of
    cells and gap runs longer than a warp (32) and than 64 cells, paths
    that leave the matrix through a run at row 0 or column 0, M not a
    multiple of 4 or 32, starts at the corners and edges, si < 0."""
    rng = np.random.default_rng(P + M + N)
    dirs = _random_dirs(rng, P, M, N, p_diag, p_cont)
    si = rng.integers(0, M, P).astype(np.int32)
    sj = rng.integers(0, N, P).astype(np.int32)
    si[:4] = M - 1, -1, 0, M - 1
    sj[:4] = N - 1, 5, N - 1, 0
    want = JD.traceback_device(jnp.asarray(dirs), jnp.asarray(si), jnp.asarray(sj))
    got = traceback_dirs(*_torch(dirs, si, sj))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    if M > 1:
        assert _longest_gap_run(got[0].numpy(), got[1].numpy()) > 32


@pytest.mark.parametrize("is_global,zdrop", [(True, -1), (False, 200)])
def test_traceback_of_long_gaps_matches_traceback_device(is_global, zdrop):
    """ma_tpu's banded_align + traceback_device against the port's
    wavefront DP + traceback on problems with a 40-base deletion and a
    70-base insertion: real gap runs longer than 32 and 64 cells."""
    rng = np.random.default_rng(21 + int(is_global))
    P, M, N = 6, 160, 200
    q = rng.integers(0, 4, (P, M)).astype(np.uint8)
    t = rng.integers(0, 4, (P, N)).astype(np.uint8)
    for p in range(P):
        ts = np.where(rng.random(M) < 0.03, rng.integers(0, 4, M), q[p])
        a = int(rng.integers(20, 40))
        ts = np.concatenate([ts[:a], ts[a + 40 : a + 70], rng.integers(0, 4, 70), ts[a + 70 :]])
        t[p, : min(N, len(ts))] = ts[:N]
    qlen = np.full(P, M, np.int32)
    tlen = np.full(P, N if is_global else N - 10, np.int32)
    band = np.full(P, 128, np.int32)
    ref = JD.banded_align(q, t, qlen, tlen, band, JD.DPParams(), zdrop=zdrop, is_global=is_global)
    got = banded_align_wavefront(*_torch(q, t, qlen, tlen, band), TD.DPParams(), zdrop, is_global)
    si, sj = (qlen - 1, tlen - 1) if is_global else (np.asarray(ref.max_i), np.asarray(ref.max_j))
    want = JD.traceback_device(ref.dirs, jnp.asarray(si), jnp.asarray(sj))
    tb = traceback_dirs(got.dirs, *_torch(np.asarray(si, np.int32), np.asarray(sj, np.int32)))
    for w, g in zip(want, tb):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert _longest_gap_run(tb[0].numpy(), tb[1].numpy()) > 64


@pytest.fixture
def anti_diagonal_ma_tpu(monkeypatch):
    """ma_tpu's banded_align_traceback under the reference setting
    (MA_TPU_DP=fused: the XLA anti-diagonal DP); its jit caches are cleared
    around the test so no other test sees this trace."""
    monkeypatch.setenv("MA_TPU_DP", "fused")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("is_global,zdrop", [(True, -1), (False, 200)])
def test_desc_runs_and_decoders_match(anti_diagonal_ma_tpu, is_global, zdrop):
    """_dp_tb_desc_runs + runs_to_cigars, with MAX_RUNS overflow rows decoded
    from their ops row, and banded_align_traceback_packed, against ma_tpu."""
    rng = np.random.default_rng(5)
    B, L, T = 4, 300, 3000
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = rng.integers(0, 4, T).astype(np.uint8)
    P, M, N = 12, 128, 192
    q_len = rng.integers(1, M + 1, P)
    t_len = rng.integers(1, N + 1, P)
    q_off = rng.integers(0, L - M, P)
    t_start = rng.integers(0, T - N, P)
    q_rev = rng.integers(0, 2, P)
    t_rev = rng.integers(0, 2, P)
    # half the targets hold their query with an indel every ~5 bases: many runs
    for k in range(0, P, 2):
        q_len[k] = M
        qs = seqs[0, q_off[k] : q_off[k] + M]
        qs = qs[::-1] if q_rev[k] else qs
        r = rng.random(M)
        ts = np.insert(qs[r >= 0.1], np.flatnonzero(r[r >= 0.1] > 0.9),
                       rng.integers(0, 4, int((r[r >= 0.1] > 0.9).sum())))
        t_len[k] = len(ts)
        text[t_start[k] : t_start[k] + len(ts)] = ts[::-1] if t_rev[k] else ts
    desc = np.stack([np.zeros(P), q_off, q_len, q_rev, t_start, t_len, t_rev,
                     np.full(P, 40)]).astype(np.int32)
    kw = dict(M=M, N=N, params=JD.DPParams(), zdrop=zdrop, is_global=is_global)
    j_ops, j_meta, j_op, j_start, j_nr = (np.asarray(a) for a in JD._dp_tb_desc_runs(
        jnp.asarray(text), jnp.asarray(seqs), jnp.asarray(desc), **kw))
    got = TD._dp_tb_desc_runs(torch.as_tensor(text), torch.as_tensor(seqs),
                              torch.as_tensor(desc), M, N, TD.DPParams(), zdrop, is_global)
    t_ops, t_meta, t_op, t_start_, t_nr = (g.numpy() for g in got)
    assert np.array_equal(j_ops, t_ops) and np.array_equal(j_meta, t_meta)
    assert np.array_equal(j_nr, t_nr) and np.array_equal(j_op, t_op)
    assert np.array_equal(j_start, t_start_)
    assert (t_nr > TD.MAX_RUNS).any()
    args = (t_meta[0], t_nr, t_meta[1], t_meta[2])
    cigs = TD.runs_to_cigars(t_op, t_start_, *args)
    assert cigs == JD.runs_to_cigars(j_op, j_start, *args)
    full = TD.rle_ops_batch(t_ops, t_meta[0], t_meta[1], t_meta[2])
    for p, c in enumerate(cigs):
        assert c == full[p] if c is not None else t_nr[p] > TD.MAX_RUNS
        assert TD.rle_ops(t_ops[p], int(t_meta[0, p]), int(t_meta[1, p]),
                          int(t_meta[2, p])) == full[p]

    # the host-array entry (the run-overflow redo's) on the same operands
    qa, ta, *_ = (a.numpy() for a in TD._desc_operands(
        torch.as_tensor(text), torch.as_tensor(seqs), torch.as_tensor(desc), M, N))
    lens = (desc[2], desc[5], desc[7])
    j_pops, j_pmeta = JD.banded_align_traceback_packed(qa.astype(np.uint8), ta.astype(np.uint8),
                                                       *lens, **{k: v for k, v in kw.items()
                                                                 if k not in "MN"})
    t_pops, t_pmeta = TD.banded_align_traceback_packed(qa, ta, *lens, device="cpu",
                                                       params=TD.DPParams(), zdrop=zdrop,
                                                       is_global=is_global)
    assert np.array_equal(np.asarray(j_pmeta), t_pmeta)
    assert np.array_equal(np.asarray(j_pops), t_pops)
