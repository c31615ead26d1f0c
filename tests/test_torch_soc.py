"""ma_tpu_torch SoC collection and its sweep (kernel A's plain version)
against ma_tpu: the XLA while_loop sweep inside ma_tpu's soc_collect and the
Pallas kernel soc_sweep_pallas in interpret mode. Exact equality."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ma_tpu.ops import extract as JE  # noqa: E402
from ma_tpu.ops import soc as JS  # noqa: E402
from ma_tpu.ops.soc_pallas import soc_sweep_pallas  # noqa: E402
from ma_tpu_torch.ops import extract as TE  # noqa: E402
from ma_tpu_torch.ops import soc as TS  # noqa: E402
from ma_tpu_torch.ops.soc_cuda import soc_sweep_plain  # noqa: E402

# the suite runs several test processes side by side on the CPU; one
# intra-op thread each keeps torch's many small ops from contending
torch.set_num_threads(1)

S, K, QLEN = 256, 32, 150
CONTIGS = np.asarray([0, 30_000], np.int32)
L_FWD = 50_000


def _seeds(seed: int, B: int = 6):
    """Per read: a few clusters of seeds on nearby diagonals (overlapping
    strips), scattered noise seeds, both strands and contigs; read 0 holds
    40 far-apart clusters, more strips than the K = 32 stack slots."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, S), np.int32)
    ln = np.zeros((B, S), np.int32)
    r = np.zeros((B, S), np.int32)
    fw = np.zeros((B, S), bool)
    amb = np.zeros((B, S), np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        n_cl = 40 if b == 0 else int(rng.integers(1, 6))
        rows = []
        for c in range(n_cl):
            diag = (c * 1100 + 50) if b == 0 else int(rng.integers(0, L_FWD - 400))
            forward = bool(rng.random() < 0.5)
            for _ in range(3 if b == 0 else int(rng.integers(1, 8))):
                qs = int(rng.integers(0, QLEN - 20))
                off = int(rng.integers(-6, 7))
                rows.append((qs, int(rng.integers(15, 30)), diag + qs + off, forward,
                             int(rng.integers(1, 4))))
        for _ in range(int(rng.integers(0, 10))):
            rows.append((int(rng.integers(0, QLEN - 20)), int(rng.integers(15, 25)),
                         int(rng.integers(0, L_FWD - 50)), bool(rng.random() < 0.5),
                         int(rng.integers(1, 9))))
        rows = [rows[k] for k in rng.permutation(len(rows))][:S]
        n[b] = len(rows)
        for i, row in enumerate(rows):
            q[b, i], ln[b, i], r[b, i], fw[b, i], amb[b, i] = row
    valid = np.arange(S)[None, :] < n[:, None]
    return q * valid, ln * valid, r * valid, fw & valid, amb * valid, valid, n


def _batches(seed):
    q, ln, r, fw, amb, valid, n = _seeds(seed)
    B = len(n)
    qlen = np.full(B, QLEN, np.int32)
    jd = JE.compute_delta(jnp.asarray(q), jnp.asarray(ln), jnp.asarray(r), jnp.asarray(fw),
                          jnp.asarray(qlen)[:, None], jnp.asarray(CONTIGS), L_FWD, True)
    td = TE.compute_delta(torch.as_tensor(q), torch.as_tensor(ln), torch.as_tensor(r),
                          torch.as_tensor(fw), torch.as_tensor(qlen)[:, None],
                          torch.as_tensor(CONTIGS), L_FWD, True)
    assert np.array_equal(np.asarray(jd), td.numpy())
    delta = np.where(valid, np.asarray(jd), 2**31 - 1).astype(np.int32)
    z = np.zeros((B, S), np.int32)
    over = np.zeros(B, bool)
    js = JE.SeedBatch(*(jnp.asarray(a) for a in (q, ln, r, fw, amb, delta, z, valid, n, over)))
    ts = TE.SeedBatch(*(torch.as_tensor(a) for a in (q, ln, r, fw, amb, delta, z, valid, n, over)))
    return js, ts, qlen


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("min_score", [0, 40])
def test_soc_collect_matches_xla_sweep(seed, min_score):
    js, ts, qlen = _batches(seed)
    B = len(qlen)
    ms = np.full(B, min_score, np.int32)
    ms[1] = 0
    kw = dict(match=2, extend=2, gap=4, fixed_width=0, rectangular=True, max_socs=K)
    collect = jax.jit(functools.partial(JS.soc_collect, **kw))
    jo = collect(js, jnp.asarray(qlen), jnp.asarray(CONTIGS), min_score=jnp.asarray(ms))
    to = TS.soc_collect(ts, torch.as_tensor(qlen), torch.as_tensor(CONTIGS),
                        min_score=torch.as_tensor(ms), **kw)
    for name in ("start", "end", "score", "amb", "n_socs", "overflow"):
        assert np.array_equal(np.asarray(getattr(jo, name)), getattr(to, name).numpy()), name
    for name in jo.seeds._fields:
        assert np.array_equal(np.asarray(getattr(jo.seeds, name)),
                              getattr(to.seeds, name).numpy()), name
    assert bool(np.asarray(jo.overflow)[0])  # read 0 overflows the stack


@pytest.mark.parametrize("seed", [0, 2])
def test_sweep_plain_matches_pallas_interpret(seed):
    """Kernel A's plain version against the Pallas kernel (interpret mode)
    on the same candidate table, S = 256, K = 32."""
    _, ts, qlen = _batches(seed)
    B = len(qlen)
    ms = torch.as_tensor(np.asarray([0, 0, 30, 45, 0, 60][:B], np.int32))
    sd, cand, ms = TS.soc_candidates(ts, torch.as_tensor(qlen), torch.as_tensor(CONTIGS),
                                     min_score=ms)
    assert tuple(cand.shape) == (S, B, 7)
    st, sp, over = soc_sweep_plain(cand, sd.n_seeds, ms, K)
    jst, jsp, jover = soc_sweep_pallas(jnp.asarray(cand.numpy()), jnp.asarray(sd.n_seeds.numpy()),
                                       jnp.asarray(ms.numpy()), K=K, interpret=True)
    assert np.array_equal(np.asarray(jst), st.numpy())
    assert np.array_equal(np.asarray(jsp), sp.numpy())
    assert np.array_equal(np.asarray(jover), over.numpy())
    assert bool(over[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_plain_matches_pallas_on_random_tables(seed):
    """Kernel A's plain version against the Pallas kernel (interpret mode)
    on synthetic candidate tables: strips of length 0, min scores of 0,
    windows ending just ahead of their start, K = 8 stack slots."""
    rng = np.random.default_rng(seed)
    S, B, K = 64, 128, 8
    lens = rng.integers(0, 30, (B, S))
    amb = rng.integers(0, 3, (B, S))
    plen, pamb = np.cumsum(lens, 1), np.cumsum(amb, 1)
    we = np.minimum(np.arange(S)[None, :] + rng.integers(1, 6, (B, S)), S)
    take = lambda a, i: np.take_along_axis(a, np.clip(i, 0, S - 1), 1) * (i >= 0)
    pex, aex = plen - lens, pamb - amb
    pend, aend = take(plen, we - 1), take(pamb, we - 1)
    cand = np.stack([pend - pex, aend - aex, we, pex, aex, pend, aend], -1)
    cand = np.ascontiguousarray(cand.transpose(1, 0, 2)).astype(np.int32)
    n = rng.integers(0, S + 1, B).astype(np.int32)
    ms = (rng.integers(0, 20, B) * (rng.random(B) < 0.7)).astype(np.int32)
    st, sp, over = soc_sweep_plain(torch.as_tensor(cand), torch.as_tensor(n),
                                   torch.as_tensor(ms), K)
    jst, jsp, jover = soc_sweep_pallas(jnp.asarray(cand), jnp.asarray(n), jnp.asarray(ms),
                                       K=K, interpret=True)
    assert np.array_equal(np.asarray(jst), st.numpy())
    assert np.array_equal(np.asarray(jsp), sp.numpy())
    assert np.array_equal(np.asarray(jover), over.numpy())
    assert bool(over.any())
