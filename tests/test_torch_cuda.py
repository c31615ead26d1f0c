"""The CUDA kernels of ma_tpu_torch against their plain PyTorch versions on
the same CUDA tensors (exact equality). These need an NVIDIA GPU and nvcc
and skip without one; on a machine with a card run

    python -m pytest tests/test_torch_cuda.py -o addopts= --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which that machine lacks.)
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _soc_candidates(rng, S, B):
    """[S, B, 7] candidate tables as soc_candidates makes them: prefix sums
    along each read's candidates, windows ending a few candidates ahead."""
    lens = rng.integers(0, 30, (B, S))
    amb = rng.integers(0, 3, (B, S))
    plen, pamb = np.cumsum(lens, 1), np.cumsum(amb, 1)
    we = np.minimum(np.arange(S)[None, :] + rng.integers(1, 6, (B, S)), S)
    take = lambda a, i: np.take_along_axis(a, np.clip(i, 0, S - 1), 1) * (i >= 0)
    pex, aex = plen - lens, pamb - amb
    pend, aend = take(plen, we - 1), take(pamb, we - 1)
    return np.stack([pend - pex, aend - aex, we, pex, aex, pend, aend], -1).transpose(1, 0, 2)


@pytest.mark.parametrize("S,B,K", [(64, 300, 8), (64, 301, 8), (256, 4096, 32), (8192, 256, 32)])
def test_soc_sweep_kernel(cuda, S, B, K):
    """Kernel A against its plain version: the short path's and the long
    path's table shapes, K = 8 (stacks overflow), B = 301 (not a multiple
    of the block's 4 reads); read 0 has no candidate, read 1 all S, read 2
    every candidate below its min_score, read 3 a min_score of 0."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.soc_cuda import soc_sweep, soc_sweep_plain

    rng = np.random.default_rng(S + B + K)
    cand = torch.as_tensor(_soc_candidates(rng, S, B).copy(), dtype=torch.int32, device=cuda)
    n = rng.integers(0, S + 1, B)
    n[:3] = 0, S, S
    ms = rng.integers(0, 20, B)
    ms[2], ms[3] = 1 << 30, 0
    n = torch.as_tensor(n, dtype=torch.int32, device=cuda)
    ms = torch.as_tensor(ms, dtype=torch.int32, device=cuda)
    before = kernels.SOC_SWEEP.launches
    got = soc_sweep(cand, n, ms, K)
    torch.cuda.synchronize()
    assert kernels.SOC_SWEEP.launches == before + 1
    want = soc_sweep_plain(cand, n, ms, K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[1][0]) == 0 and int(want[1][2]) == 0 and int(want[1][1]) > 0
    assert K != 8 or bool(want[2].any())  # K = 8 slots overflow


def test_soc_sweep_refuses_k_past_shared_memory(cuda):
    from ma_tpu_torch.ops.soc_cuda import soc_sweep

    cand = torch.zeros((4, 8, 7), dtype=torch.int32, device=cuda)
    n = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="K=4096"):
        soc_sweep(cand, n, n, 4096)


@pytest.mark.parametrize("M", [64, 2048, 40, 100, 4096, 8192])
def test_linesweep_kernel(cuda, M):
    """Kernel B (sort and sweep) on unsorted rows against its plain version
    (the stable sort, then the sweep): ties in start, end and distance,
    invalid elements, R = 257 rows (not a multiple of the 32-row tile); the
    warp-tile path (M <= 64) and the block-per-row path, up to the overflow
    rescue's widest rows (8192, 168 KB of shared memory)."""
    from ma_tpu_torch.ops.harmonize_cuda import linesweep, linesweep_plain

    rng = np.random.default_rng(M)
    R = 257
    starts = rng.integers(0, 300, (R, M))
    ends = starts + rng.integers(10, 50, (R, M))
    starts[:, 5:12] = starts[:, 5:6]  # start ties
    ends[:, 20:26] = ends[:, 20:21]  # end ties
    starts[:, 30:33] = starts[:, 30:31]  # whole-interval ties
    ends[:, 30:33] = ends[:, 30:31]
    dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=cuda)
    ops = (dev(starts, torch.int32), dev(ends, torch.int32),
           dev(rng.integers(0, 8, (R, M)) * 0.5, torch.float32),
           dev(rng.random((R, M)) < 0.8, torch.bool))
    got = linesweep(*ops)
    torch.cuda.synchronize()
    want = linesweep_plain(*ops)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(ops[3].sum())


@pytest.mark.parametrize("is_global", [True, False])
def test_dp_fused_kernel(cuda, is_global):
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import banded_align_runs, banded_align_runs_plain

    rng = np.random.default_rng(int(is_global))
    P, M, N = 96, 64, 128
    q = rng.integers(0, 4, (P, M))
    t = np.concatenate([q, rng.integers(0, 4, (P, N - M))], 1)
    t[rng.random(t.shape) < 0.05] = rng.integers(0, 4)
    t[:, 20:23] = 4
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=cuda)
    qlen = rng.integers(1, M + 1, P)
    tlen = rng.integers(1, N + 1, P)
    band = np.full(P, 40)
    tb = (np.arange(P) % 3 == 0) & (not is_global)
    kw = dict(M=M, N=N, params=DPParams(), zdrop=-1 if is_global else 30,
              is_global=is_global, tb_last=dev(tb), R=8)
    args = (dev(q), dev(t), dev(qlen), dev(tlen), dev(band))
    got = banded_align_runs(*args, **kw)
    torch.cuda.synchronize()
    want = banded_align_runs_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _dp_problems(rng, P, M, N, is_global, dev):
    """Targets are mutated copies of the queries with random flanks; every
    fifth extension target turns random after a few bases (z-drop), every
    third extension problem traces back from its last row."""
    q = rng.integers(0, 4, (P, M))
    t = np.concatenate([q, rng.integers(0, 4, (P, max(N - M, 0)))], 1)[:, :N]
    t[rng.random(t.shape) < 0.05] = rng.integers(0, 4)
    t[:, 20:23] = 4
    if not is_global:
        t[::5, 8:] = rng.integers(0, 4, t[::5, 8:].shape)
    qlen = rng.integers(1, M + 1, P)
    tlen = rng.integers(1, N + 1, P)
    band = rng.integers(10, max(11, N // 2), P)
    tb = (np.arange(P) % 3 == 0) & (not is_global)
    d = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)
    return (d(q), d(t), d(qlen), d(tlen), d(band)), d(tb)


@pytest.mark.parametrize("M,N", [(32, 128), (64, 768), (32, 1024), (40, 200), (64, 4096)])
@pytest.mark.parametrize("is_global", [True, False])
def test_dp_fused_v2_kernel(cuda, M, N, is_global):
    """C' against the plain version and, where C takes the width, against C:
    one-warp teams (N = 128), multi-warp teams with named barriers, a width
    that is not a multiple of 16 (N = 200), and rows walked in chunks
    (N = 4,096)."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import (
        banded_align_runs, banded_align_runs_plain, banded_align_runs_v2,
    )

    rng = np.random.default_rng(M * N + int(is_global))
    args, tb = _dp_problems(rng, 70, M, N, is_global, cuda)
    kw = dict(M=M, N=N, params=DPParams(), zdrop=-1 if is_global else 30,
              is_global=is_global, tb_last=tb, R=8)
    before = kernels.DP_FUSED_V2.launches
    got = banded_align_runs_v2(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.DP_FUSED_V2.launches == before + 1
    want = banded_align_runs_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if N <= 1024:
        c = banded_align_runs(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, c))


@pytest.mark.parametrize("N", [128, 768, 2048, 4096, 4224])
def test_dp_fused_v2_direction_bytes(cuda, N):
    """The direction bytes C' streams out (rows < qlen, extension mode with
    z-drop off, so no row is skipped) against the plain row DP's: 4, 8 and
    rows in registers (N <= 1,024) and walked in chunks (N = 2,048 up).
    C' writes a row's bytes only for its groups of 4 columns (a thread's
    columns) that hold an in-band cell; those must equal the plain version's,
    and every other cell must carry the bits the traceback is given there:
    E's continuation (0x28) left of the band but at column 0, F's (0x50)
    right of it but in row 0."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_rows import banded_align_rows

    rng = np.random.default_rng(N)
    P, M = 12, 48
    (q, t, qlen, tlen, band), tb = _dp_problems(rng, P, M, N, False, cuda)
    qlen[:2], tlen[:2], band[:2] = M, N, 10  # cells left and right of a narrow band
    pr = DPParams()
    meta_in = torch.stack([qlen, tlen, band, tb], 1).contiguous()
    runs = torch.empty((P, 8), dtype=torch.int32, device=cuda)
    meta = torch.empty((8, P), dtype=torch.int32, device=cuda)
    ldn = -(-N // 16) * 16
    dirs = torch.empty((P, M, ldn), dtype=torch.uint8, device=cuda)
    carry = torch.empty((P, kernels.query("ma_dp_fused_v2_carry_ints", N, ldn)),
                        dtype=torch.int32, device=cuda)
    kernels.DP_FUSED_V2.launch(q, t, meta_in, runs, meta, dirs, carry if carry.numel() else 0,
                               P, M, N, ldn, 8, *pr, -1, 0)
    want = banded_align_rows(q, t, qlen, tlen, band, pr, -1, False).dirs
    torch.cuda.synchronize()
    cpt = 4
    i = torch.arange(M, device=cuda)[None, :, None]
    g = torch.arange(N, device=cuda)[None, None, :] // cpt * cpt  # each column's group
    w = band[:, None, None]
    lo, hi = (i - w).clamp(min=0), torch.minimum(tlen[:, None, None] - 1, i + w)
    rows = i < qlen[:, None, None]
    stored = rows & (g + cpt - 1 >= lo) & (g <= hi)
    got = dirs[:, :, :N]
    assert torch.equal(torch.where(stored, got, 0), torch.where(stored, want, 0))
    j = torch.arange(N, device=cuda)[None, None, :]
    left = rows & (g + cpt - 1 < lo) & (j > 0)
    right = rows & (g > hi) & (i > 0)
    assert bool(((want & 0x28) == 0x28)[left].all()) and bool(((want & 0x50) == 0x50)[right].all())
    assert bool(left.any()) and bool(right.any())


@pytest.mark.parametrize("M,N,is_global,band,zdrop,P", [
    (64, 8320, False, 5000, 30, 24),  # a band wider than a chunk of 1,024 columns
    (128, 2048, False, 1500, 100, 24),
    (4500, 8320, False, 300, 200, 4),  # rows whose band starts past the first chunks
    (256, 4096, False, 512, 200, 48),  # chip_smoke.py's wide case
    (64, 768, True, 20, -1, 40),  # global, |m - n| > band: every cell computed
    (48, 4224, True, 30, -1, 12),  # the same, rows in chunks
    (64, 200, False, 64, 0, 40),  # z-drops in the first rows
    (64, 8320, False, 64, 0, 12),
    (32, 128, True, 8, 5, 40),  # global with z-drop, a narrow band
])
def test_dp_fused_v2_band_cases(cuda, M, N, is_global, band, zdrop, P):
    """C' where its band skipping decides (groups of columns left or right
    of the band computed nothing, chunks of a row outside it never
    visited), exact against the plain version and, where C takes the width,
    C: bands wider than a chunk, bands that leave the first chunks behind,
    global problems whose end cell lies outside the band (nothing is
    skipped for them; every third one's band is widened to hold it), z-drops
    in the first rows (the problem stops the row after), last-row
    tracebacks (every third extension problem)."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import (
        banded_align_runs, banded_align_runs_plain, banded_align_runs_v2,
    )

    rng = np.random.default_rng(M + N + band)
    (q, t, qlen, tlen, _), tb = _dp_problems(rng, P, M, N, is_global, cuda)
    if M > 1000:
        qlen[1:] = M
    bands = torch.full_like(qlen, band)
    if is_global:  # every third problem's end cell inside the band
        near = (tlen - qlen).abs() <= band
        bands = torch.where(torch.arange(P, device=cuda) % 3 == 0,
                            (tlen - qlen).abs() + band, bands)
        assert bool((~near).any())
    kw = dict(M=M, N=N, params=DPParams(), zdrop=zdrop, is_global=is_global, tb_last=tb,
              R=max(32, M // 4))
    before = kernels.DP_FUSED_V2.launches
    got = banded_align_runs_v2(q, t, qlen, tlen, bands, **kw)
    torch.cuda.synchronize()
    assert kernels.DP_FUSED_V2.launches == before + 1
    want = banded_align_runs_plain(q, t, qlen, tlen, bands, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if N <= 1024:
        c = banded_align_runs(q, t, qlen, tlen, bands, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, c))
    meta = want[1].cpu().numpy()
    assert zdrop != 0 or meta[4].mean() > 0.5  # most problems z-drop early


@pytest.mark.parametrize("M,N", [(32, 128), (64, 128), (256, 128), (64, 768), (256, 768),
                                 (256, 896), (40, 200)])
@pytest.mark.parametrize("is_global", [True, False])
@pytest.mark.parametrize("R", [8, 2])
def test_dp_fused_kernel_buckets(cuda, M, N, is_global, R):
    """Kernel C at every fused bucket (one-warp teams, multi-warp teams with
    the plane in shared memory, streamed planes at 256 x 768 and 896) in
    both modes: bands narrower than the row, global problems whose last
    cell lies outside the band, extensions that z-drop within a few rows,
    and run overflow (R = 2). Exact against the plain version and C'."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import (
        banded_align_runs, banded_align_runs_plain, banded_align_runs_v2,
    )

    rng = np.random.default_rng(7 * M + N + int(is_global))
    args, tb = _dp_problems(rng, 70, M, N, is_global, cuda)
    kw = dict(M=M, N=N, params=DPParams(), zdrop=-1 if is_global else 30,
              is_global=is_global, tb_last=tb, R=R)
    before = kernels.DP_FUSED.launches
    got = banded_align_runs(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.DP_FUSED.launches == before + 1
    want = banded_align_runs_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, banded_align_runs_v2(*args, **kw)))
    meta = want[1].cpu().numpy()
    assert R == 8 or meta[5].any()  # run overflow
    assert is_global or M < 64 or meta[4].any()  # z-drops


def test_dp_fused_tally(cuda):
    """Kernel C's tally counts launches and problems per (M, N, mode)."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp_fused import banded_align_runs

    args, tb = _dp_problems(np.random.default_rng(5), 16, 32, 128, False, cuda)
    kernels.DP_FUSED.reset()
    for _ in range(2):
        banded_align_runs(*args, M=32, N=128, zdrop=30, is_global=False, tb_last=tb)
    banded_align_runs(*args, M=32, N=128, is_global=True)
    assert kernels.DP_FUSED.tally == {(32, 128, "extension"): (2, 32), (32, 128, "global"): (1, 16)}
    assert kernels.DP_FUSED.launches == 3


def test_dp_v2_selection_launches_c_prime(cuda, monkeypatch):
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp_fused import banded_align_runs

    args, tb = _dp_problems(np.random.default_rng(3), 16, 32, 128, False, cuda)
    counts = lambda: (kernels.DP_FUSED.launches, kernels.DP_FUSED_V2.launches)  # noqa: E731
    c0, v0 = counts()
    banded_align_runs(*args, M=32, N=128, zdrop=30, is_global=False, tb_last=tb)
    monkeypatch.setenv("MA_TPU_DP_V2", "1")
    banded_align_runs(*args, M=32, N=128, zdrop=30, is_global=False, tb_last=tb)
    torch.cuda.synchronize()
    assert counts() == (c0 + 1, v0 + 1)


def test_fmd_ops_on_cuda(cuda):
    """occ4 and extend_backward on CUDA tensors against the CPU."""
    from ma_tpu_torch.containers.pack import Pack
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.ops import occ

    rng = np.random.default_rng(8)
    pack = Pack.empty()
    pack.append("g", rng.integers(0, 4, 5000).astype(np.uint8))
    fmd = FMDIndex.build(pack)
    cpu, dev = occ.FMDDev.from_host(fmd, "cpu"), occ.FMDDev.from_host(fmd, cuda)
    k = torch.arange(-1, fmd.n + 1, dtype=torch.int32)
    assert torch.equal(occ.occ4(dev, k.to(cuda)).cpu(), occ.occ4(cpu, k))
    n = 5000
    start = torch.as_tensor(rng.integers(0, fmd.n - 50, n), dtype=torch.int32)
    ik = occ.SAI(start, torch.as_tensor(rng.integers(0, fmd.n, n), dtype=torch.int32),
                 torch.as_tensor(rng.integers(0, 50, n), dtype=torch.int32))
    c = torch.as_tensor(rng.integers(0, 5, n), dtype=torch.int32)
    want = occ.extend_backward(cpu, ik, c)
    got = occ.extend_backward(dev, occ.SAI(*(a.to(cuda) for a in ik)), c.to(cuda))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert torch.equal(occ.sa_lookup(dev, k[1:].to(cuda)).cpu(), occ.sa_lookup(cpu, k[1:]))


@pytest.mark.parametrize("is_global,zdrop,M,N,P,band", [
    (True, -1, 64, 128, 40, None), (False, 30, 64, 128, 40, None),
    (False, 200, 2048, 1024, 12, None), (True, -1, 96, 200, 40, None),
    (False, 30, 33, 300, 40, None), (True, -1, 127, 400, 40, None),
    (False, 20, 1000, 1500, 16, None), (True, -1, 1536, 700, 8, None),
    (False, 200, 4200, 600, 4, None), (True, -1, 200, 300, 40, 6),
    (False, 30, 40, 100, 600, None), (False, 30, 200, 300, 1200, None),
    (True, -1, 127, 300, 600, None), (False, 20, 1000, 700, 300, None),
])
def test_dp_wavefront_and_traceback_kernels(cuda, is_global, zdrop, M, N, P, band):
    """Kernel D against its plain version on the whole direction tensor and
    on score, max cell and z-drop, then the traceback kernel on its output:
    M not a multiple of a warp's lanes or of 4 (33, 127, 1000), lanes in
    rounds of a team's 16 warps (1,536, 2,048, 4,200), N < M, a band of 6,
    z-drops that fire while the warps run skewed (every third target turns
    random a third of the way in), several problems per block (P = 600 at
    M = 40, P = 1,200 at M = 200). Each case runs at the kernel's default
    lane count and at 4 and 2 lanes a thread."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops import dp_wavefront as W
    from ma_tpu_torch.ops.dp import DPParams

    rng = np.random.default_rng(M + N + int(is_global))
    q = rng.integers(0, 4, (P, M))
    t = np.concatenate([q, rng.integers(0, 4, (P, N))], 1)[:, :N]
    t[rng.random(t.shape) < 0.05] = rng.integers(0, 4)
    t[:, 20:23] = 4
    if not is_global:
        t[::3, M // 3 :] = rng.integers(0, 4, t[::3, M // 3 :].shape)
    bands = np.full(P, band) if band else rng.integers(5, max(60, min(M, N) // 2), P)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=cuda)
    args = (dev(q), dev(t), dev(rng.integers(1, M + 1, P)), dev(rng.integers(1, N + 1, P)),
            dev(bands), DPParams(), zdrop, is_global)
    before = kernels.DP_WAVEFRONT.launches
    got = W.banded_align_wavefront(*args)
    torch.cuda.synchronize()
    assert kernels.DP_WAVEFRONT.launches == before + 1
    want = W.banded_align_wavefront_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for lanes in (4, 2):
        other = W.banded_align_wavefront(*args, lanes=lanes)
        assert all(torch.equal(a, b) for a, b in zip(other, want)), lanes
    if zdrop == 20:
        assert bool(want.zdropped.any()) and not bool(want.zdropped.all())
    si = torch.where(torch.arange(P, device=cuda) % 7 == 0, -1, got.max_i)
    tb = W.traceback_dirs(got.dirs, si, got.max_j)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tb, W.traceback_dirs_plain(got.dirs, si,
                                                                            got.max_j)))


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
            if op != 0:
                best = max(best, run)
    return best


@pytest.mark.parametrize("P,M,N,p_diag,p_cont", [
    (64, 37, 50, 0.9, 0.97), (64, 100, 33, 0.5, 0.995), (40, 200, 300, 0.97, 0.995),
    (33, 1, 70, 0.5, 0.99), (33, 70, 1, 0.5, 0.99), (300, 64, 96, 0.95, 0.99),
])
def test_traceback_kernel_on_random_bytes(cuda, P, M, N, p_diag, p_cont):
    """The traceback kernel against its plain version on every output, on
    random direction bytes: diagonal runs of tens of cells, gap runs longer
    than 32 and 64 cells, M not a multiple of 4 or 32 (37, 1, 70), a single
    row or column, paths that leave the matrix through row 0 and column 0
    in every mode, starts at the matrix's corners and edges, si < 0 and
    sj < 0 (nothing walked) and starts outside the matrix (the plain
    version's clamped walk); P = 300 takes blocks of 2 warps."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops import dp_wavefront as W

    rng = np.random.default_rng(P * M + N)
    dirs = _random_dirs(rng, P, M, N, p_diag, p_cont)
    si, sj = rng.integers(0, M, P), rng.integers(0, N, P)
    si[:8] = M - 1, -1, 0, M - 1, 3, M + 2, M - 1, M // 2
    sj[:8] = N - 1, 5, N - 1, 0, -1, N + 4, N + 9, 0
    d = lambda a, dt=torch.int32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                  device=cuda)
    args = (d(dirs, torch.uint8), d(si), d(sj))
    before = kernels.DP_TRACEBACK.launches
    got = W.traceback_dirs(*args)
    torch.cuda.synchronize()
    assert kernels.DP_TRACEBACK.launches == before + 1
    want = W.traceback_dirs_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if p_cont >= 0.99 and min(M, N) > 1:
        assert _longest_gap_run(want[0].cpu().numpy(), want[1].cpu().numpy()) > 64


def _indel_problems(rng, P, M, N, is_global, dev):
    """Targets that are copies of the queries (3% substitutions) with a
    deletion of 40 and an insertion of 70 bases in every other problem, so
    real gap runs exceed 32 and 64 cells; random flanks after."""
    q = rng.integers(0, 4, (P, M))
    t = rng.integers(0, 4, (P, N))
    for p in range(P):
        ts = np.where(rng.random(M) < 0.03, rng.integers(0, 4, M), q[p])
        if p % 2 == 0:
            a = int(rng.integers(M // 8, M // 2 - 40))
            b = a + 40 + int(rng.integers(10, M // 3))
            ts = np.concatenate([ts[:a], ts[a + 40 :b], rng.integers(0, 4, 70), ts[b:]])
        t[p, : min(N, len(ts))] = ts[:N]
    qlen = np.full(P, M) if is_global else rng.integers(M // 2, M + 1, P)
    tlen = np.full(P, N) if is_global else rng.integers(N // 2, N + 1, P)
    d = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.uint8
                                  if a.ndim == 2 else torch.int32, device=dev)
    return d(q), d(t), d(qlen), d(tlen)


@pytest.mark.parametrize("P,M,N,is_global", [
    (256, 1024, 4096, False), (128, 512, 512, True), (32, 401, 400, True), (32, 376, 372, True),
    (48, 300, 340, False),
])
def test_traceback_kernel_on_wavefront_output(cuda, P, M, N, is_global):
    """The traceback kernel on kernel D's bytes against its plain version,
    every output: chip_smoke.py's two shapes (P = 256, 1024 x 4096
    extension; P = 128, 512 x 512 global), the long pass's own inversion
    windows (P = 32 at about 400 x 400), with deletions of 40 and
    insertions of 70 bases (gap runs longer than 32 and 64 cells), band
    512; every ninth problem skipped (si < 0)."""
    from ma_tpu_torch.ops import dp_wavefront as W
    from ma_tpu_torch.ops.dp import DPParams

    rng = np.random.default_rng(P + M + N)
    q, t, qlen, tlen = _indel_problems(rng, P, M, N, is_global, cuda)
    res = W.banded_align_wavefront(q, t, qlen, tlen, torch.full_like(qlen, 512), DPParams(),
                                   -1 if is_global else 200, is_global)
    si, sj = (qlen - 1, tlen - 1) if is_global else (res.max_i, res.max_j)
    si = torch.where(torch.arange(P, device=cuda) % 9 == 4, -1, si)
    got = W.traceback_dirs(res.dirs, si, sj)
    torch.cuda.synchronize()
    want = W.traceback_dirs_plain(res.dirs, si, sj)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _longest_gap_run(want[0].cpu().numpy(), want[1].cpu().numpy()) > 64


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_dp_wavefront_negative_codes(cuda, dtype):
    """Kernel D scores codes as its plain version does: every code >= 4 an N,
    any other compared as it is, negative codes down to -128 included; a
    code below -128 (which one byte cannot hold) is refused."""
    from ma_tpu_torch.ops import dp_wavefront as W
    from ma_tpu_torch.ops.dp import DPParams

    rng = np.random.default_rng(5)
    P, M, N = 24, 70, 90
    codes = np.array([-128, -7, -1, 0, 1, 2, 3, 4, 5, 127])
    q = rng.choice(codes, (P, M))
    t = np.concatenate([q, rng.choice(codes, (P, N))], 1)[:, :N]
    t[rng.random(t.shape) < 0.2] = rng.choice(codes)
    dev = lambda a, dt=torch.int32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                    device=cuda)
    lens = (dev(rng.integers(1, M + 1, P)), dev(rng.integers(1, N + 1, P)),
            dev(rng.integers(5, 40, P)))
    for is_global, zdrop in ((True, -1), (False, 30)):
        args = (dev(q, dtype), dev(t, dtype), *lens, DPParams(), zdrop, is_global)
        got = W.banded_align_wavefront(*args)
        want = W.banded_align_wavefront_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    t[0, 0] = -129
    with pytest.raises(ValueError, match="below -128"):
        W.banded_align_wavefront(dev(q), dev(t), *lens, DPParams(), -1, True)


def test_long_read_rescue_on_card(cuda):
    """chip_smoke.py's rescue phase: 5 and 10 kb reads across a tandem repeat
    overflow their SoC windows and re-align through the rescue pass, whose
    stage sweeps rows of 4,096 and 8,192 seeds through kernel B (exact
    against its plain version on the rescue's own rows); each read's primary
    record overlaps the interval it was taken from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.rescue_phase(cuda)


def test_kernels_count_launches(cuda):
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.harmonize_cuda import linesweep

    before = kernels.LINESWEEP.launches
    z = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    linesweep(z, z, z.float(), z.bool())
    assert kernels.LINESWEEP.launches == before + 1


@pytest.mark.parametrize("N", [1152, 4096, 4224, 8320])
@pytest.mark.parametrize("is_global", [True, False])
def test_wide_fused_problems_take_c_prime(cuda, monkeypatch, N, is_global):
    """Past kernel C's 1,024 columns banded_align_runs launches C' with
    MA_TPU_DP_V2 unset, tallied per (M, N, mode), exact against the plain
    version: rows walked in chunks of 1,024 columns from the band's left
    edge."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import banded_align_runs, banded_align_runs_plain

    monkeypatch.delenv("MA_TPU_DP_V2", raising=False)
    args, tb = _dp_problems(np.random.default_rng(N + int(is_global)), 48, 256, N, is_global,
                            cuda)
    kw = dict(M=256, N=N, params=DPParams(), zdrop=-1 if is_global else 200,
              is_global=is_global, tb_last=tb, R=96)
    kernels.DP_FUSED.reset()
    kernels.DP_FUSED_V2.reset()
    got = banded_align_runs(*args, **kw)
    torch.cuda.synchronize()
    mode = "global" if is_global else "extension"
    assert kernels.DP_FUSED_V2.tally == {(256, N, mode): (1, 48)}
    assert kernels.DP_FUSED.launches == 0
    want = banded_align_runs_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("is_global", [True, False])
def test_fused_problems_past_c_prime(cuda, monkeypatch, is_global):
    """Past 65,535 columns (beyond a 16-bit column in the row-max key): C'
    launches, in both modes, and nothing else does; nothing raises; exact
    against the fused plain version, with targets that reach the last
    columns."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_fused import banded_align_runs, banded_align_runs_plain

    monkeypatch.delenv("MA_TPU_DP_V2", raising=False)
    N, M, P = 65_600, 16, 12
    rng = np.random.default_rng(4 + int(is_global))
    (q, t, qlen, tlen, band), tb = _dp_problems(rng, P, M, N, is_global, cuda)
    tlen[::2] = N - torch.arange(0, P, 2, device=cuda, dtype=torch.int32)
    if is_global:  # the end cell inside the band
        band = (tlen - qlen).abs() + 10
    else:
        band = torch.full_like(band, N)
    kw = dict(M=M, N=N, params=DPParams(), zdrop=-1 if is_global else 30,
              is_global=is_global, tb_last=tb, R=32)
    counts = lambda: [k.launches for k in kernels.KERNELS]  # noqa: E731
    before = counts()
    got = banded_align_runs(q, t, qlen, tlen, band, **kw)
    torch.cuda.synchronize()
    grew = {k.name for k, a, b in zip(kernels.KERNELS, before, counts()) if b > a}
    assert grew == {"dp_fused_v2"}
    want = banded_align_runs_plain(q, t, qlen, tlen, band, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert is_global or int(want[1][2].max()) >= 0


def _front_end_sam(case: str, device) -> tuple:
    """One batch of the paired (Illumina Paired, 64 pairs) or the SDUST
    (minimizers, threshold 20, 64 reads) front end on `device`: the SAM and
    the launches of kernels A, B, C in that run."""
    import io

    from ma_tpu_torch import kernels
    from ma_tpu_torch.pipeline.aligner import Aligner
    from ma_tpu_torch.pipeline.paired import PairedAligner
    from test_torch_paired import paired_data, paired_objects, params
    from test_torch_sdust import THRES, _fixture

    ks = (kernels.SOC_SWEEP, kernels.LINESWEEP, kernels.DP_FUSED)
    before = [k.launches for k in ks]
    out = io.StringIO()
    if case == "paired":
        pack, pairs = paired_objects("ma_tpu_torch", paired_data())
        al = Aligner(pack, params("illumina_paired"), device=device)
        assert PairedAligner(al).align_to_sam(iter(pairs), out, batch_size=64) == 128
    else:
        pack, reads = _fixture()
        al = Aligner(pack, device=device)
        al.pset.set("Seeding Technique", "minimizers")
        al.pset.set("Minimizers - SDUST Threshold", THRES)
        assert al.align_to_sam(iter(reads), out, batch_size=64) == 64
    return out.getvalue(), [k.launches - b for k, b in zip(ks, before)]


@pytest.mark.parametrize("case", ["paired", "sdust"])
def test_front_end_batch_on_card(cuda, case):
    """A paired batch and an SDUST batch on the card: the SAM equals the CPU
    port's and kernels A, B and C launched."""
    sam, launches = _front_end_sam(case, cuda)
    assert min(launches) > 0, launches
    cpu_sam, cpu_launches = _front_end_sam(case, torch.device("cpu"))
    assert cpu_launches == [0, 0, 0]
    assert sam == cpu_sam


@pytest.fixture(scope="module")
def msv_cpu():
    """tests/test_torch_msv.py's SV problem in the port, with its CPU
    JumpBatch: (pack, mmi, reads, jumps)."""
    from ma_tpu_torch.msv.pipeline import compute_sv_jumps_batch
    from test_torch_msv import objects, sv_data

    pack, mmi, reads = objects("ma_tpu_torch", sv_data())
    return pack, mmi, reads, compute_sv_jumps_batch(reads, pack, mmi, device="cpu")


def test_msv_chunk_on_card(cuda, msv_cpu):
    """One MSV chunk (104 reads, S = 2,048 seed slots, K = 64, non-
    rectangular SoCs) on the card: kernel A launches once, the SocHost
    download equals the CPU port's field for field, and the JumpBatch
    column for column."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.msv.pipeline import SocHost, compute_sv_jumps_batch, sv_seed_stage
    from test_torch_msv import JUMP_COLUMNS, chunk_arrays

    pack, mmi, reads, want = msv_cpu
    before = kernels.SOC_SWEEP.launches
    got = compute_sv_jumps_batch(reads, pack, mmi, device=cuda)
    assert kernels.SOC_SWEEP.launches == before + 1
    assert len(want) > 100
    for col in JUMP_COLUMNS:
        assert np.array_equal(getattr(got, col), getattr(want, col)), col
    seqs, lens = chunk_arrays(reads)
    hosts = []
    for dev in (cuda, torch.device("cpu")):
        cst = torch.as_tensor(np.asarray(pack.starts, np.int32), device=dev)
        soc = sv_seed_stage(mmi.to_device(dev), cst, pack.unpacked_size_forward_strand,
                            seqs, lens, device=dev)
        hosts.append(SocHost(soc, min_nt=25))
    for f in SocHost.__slots__:
        a, b = getattr(hosts[0], f), getattr(hosts[1], f)
        assert a.shape == b.shape and np.array_equal(a, b), f


def test_msv_connector_on_card(cuda, msv_cpu):
    """connector_pattern_filter on the card: kernel D launches, its scores
    equal the plain version's, and the kept calls equal the CPU port's."""
    import ma_tpu_torch.msv.connector as conn
    from ma_tpu_torch import kernels
    from ma_tpu_torch.msv.pipeline import sweep_sv_jumps

    pack, _, reads, jumps = msv_cpu
    L = pack.unpacked_size_forward_strand
    calls = [c for c in sweep_sv_jumps(jumps, min_reads=1)
             if not any(p < L < p + 100 for p in (c.from_pos + max(c.from_size, 1),
                                                   c.to_pos + max(c.to_size, 1)))][::8]
    jl = jumps.to_jumps()
    scores = {}
    orig = conn.banded_align

    def spy(*a, **kw):
        res = orig(*a, **kw)
        scores[a[0].device.type] = res.score.cpu()
        return res

    conn.banded_align = spy
    try:
        before = kernels.DP_WAVEFRONT.launches
        got = conn.connector_pattern_filter(calls, jl, reads, pack, device=cuda)
        assert kernels.DP_WAVEFRONT.launches > before
        want = conn.connector_pattern_filter(calls, jl, reads, pack, device="cpu")
    finally:
        conn.banded_align = orig
    assert torch.equal(scores["cuda"], scores["cpu"])
    assert 0 < len(got) < len(calls)
    assert [(c.from_pos, c.to_pos, c.supp_reads) for c in got] == \
        [(c.from_pos, c.to_pos, c.supp_reads) for c in want]


def test_gui_align_on_card(cuda, tmp_path):
    """An align action posted to the port's web console on cuda: rc 0, the
    SAM equals cli.main's with the same arguments on cuda, and kernels A,
    B and C launched in the action."""
    import threading
    import time
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    from ma_tpu_torch import gui, kernels
    from ma_tpu_torch.cli import main
    from ma_tpu_torch.containers.nucseq import decode_seq

    rng = np.random.default_rng(12)
    seq = decode_seq(rng.integers(0, 4, size=30_000).astype(np.uint8))
    (tmp_path / "genome.fa").write_text(">g\n" + seq + "\n")
    with open(tmp_path / "reads.fq", "w") as f:
        for i in range(64):
            p = int(rng.integers(0, 30_000 - 150))
            f.write(f"@r{i}\n{seq[p:p+150]}\n+\n{'I'*150}\n")
    assert main(["--Create_Index", f"{tmp_path / 'genome.fa'},{tmp_path},idx"]) == 0
    args = ["-x", str(tmp_path / "idx"), "-i", str(tmp_path / "reads.fq")]
    flags = ["--Seeding Technique", "minimizers"]
    gui._state.update(mgr=None, log=[], busy=False)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), gui._Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    ks = (kernels.SOC_SWEEP, kernels.LINESWEEP, kernels.DP_FUSED)
    before = [k.launches for k in ks]
    try:
        form = {"action": "align", "device": "cuda", "index": args[1], "reads": args[3],
                "out": str(tmp_path / "gui.sam"), "param:Seeding Technique": "minimizers"}
        urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/run",
                               data=urllib.parse.urlencode(form).encode())
        t0 = time.time()
        while gui._state["busy"] and time.time() - t0 < 300:
            time.sleep(0.1)
    finally:
        srv.shutdown()
        srv.server_close()
    log = "\n".join(gui._state["log"])
    assert log.endswith("[done rc=0]"), log
    launches = [k.launches - b for k, b in zip(ks, before)]
    assert min(launches) > 0, launches
    assert main(args + ["-o", str(tmp_path / "cli.sam")] + flags + ["--Device", "cuda"]) == 0
    assert (tmp_path / "gui.sam").read_bytes() == (tmp_path / "cli.sam").read_bytes()


def test_parallel_nccl_one_rank_on_card(cuda, tmp_path):
    """A one-rank NCCL group on cuda:0 (a worker process): init, all_reduce,
    all_gather."""
    from ma_tpu_torch.parallel.worker import run_ranks

    res = run_ranks(1, str(tmp_path), "psum", devices=["cuda:0"], backend="nccl",
                    timeout=60.0, wall_timeout=300.0)
    p = res[0]["results"]["psum"]
    assert (res[0]["backend"], p["sum"]) == ("nccl", 1)
    assert set(p["probe"].values()) == {"ok"}, p["probe"]


def test_parallel_gloo_ranks_share_the_card_on_sharded_fmd(cuda, tmp_path):
    """Two gloo ranks sharing cuda:0 with CUDA tensors: the sum over the
    ranks, and the row-sharded FMD lookups and seeding equal the
    single-device ones on the card."""
    from ma_tpu_torch.index.fmd_index import FMDIndex
    from ma_tpu_torch.ops.extract import extract_seeds
    from ma_tpu_torch.ops.occ import FMDDev, occ4, sa_lookup
    from ma_tpu_torch.ops.seeding import max_spanning_seeding, smem_seeding
    from ma_tpu_torch.parallel.worker import run_ranks
    from test_torch_parallel import TECHNIQUES, _fmd_batch, _fmd_genome, _pack

    g = _fmd_genome()
    pack = _pack("ma_tpu_torch", [("c0", g[:12_000]), ("c1", g[12_000:])])
    fmd = FMDIndex.build(pack)
    fmd.store(str(tmp_path / "f"))
    seqs, lens = _fmd_batch()
    ks = np.concatenate([[-1, 0, 1], np.random.default_rng(4).integers(0, fmd.n, 61)])
    cst = np.asarray(pack.starts, np.int32)
    np.savez(tmp_path / "seed-fmd-card.npz", index="f", seqs=seqs, lens=lens,
             contig_starts=cst, techniques=np.array(TECHNIQUES), occ_k=ks.astype(np.int32),
             sa_rows=np.abs(ks).astype(np.int32))
    res = run_ranks(2, str(tmp_path), "psum,seed-fmd", devices=["cuda:0", "cuda:0"],
                    backend="gloo", timeout=60.0, wall_timeout=300.0)
    assert [r["results"]["psum"]["sum"] for r in res] == [3, 3]
    assert [r["device"] for r in res] == ["cuda:0", "cuda:0"]
    got = np.load(tmp_path / "seed-fmd-card.out.npz")
    dev = FMDDev.from_host(fmd, cuda)
    k = torch.as_tensor(ks, dtype=torch.int32, device=cuda)
    assert np.array_equal(got["occ4"], occ4(dev, k).cpu().numpy())
    assert np.array_equal(got["sa"], sa_lookup(dev, k.abs()).cpu().numpy())
    s, n = torch.as_tensor(seqs, device=cuda), torch.as_tensor(lens, device=cuda)
    for tech, seed_fn in zip(TECHNIQUES, (smem_seeding, max_spanning_seeding)):
        sb = extract_seeds(dev, seed_fn(dev, s, n), n, torch.as_tensor(cst, device=cuda))
        for f, v in sb._asdict().items():
            assert np.array_equal(got[f"{tech}.{f}"], v.cpu().numpy()), (tech, f)
        counts = {r["results"]["seed-fmd"][0][tech]["collectives"] for r in res}
        assert len(counts) == 1
