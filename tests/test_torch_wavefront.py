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
