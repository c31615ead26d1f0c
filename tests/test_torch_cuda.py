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


def test_soc_sweep_kernel(cuda):
    from ma_tpu_torch.ops.soc_cuda import soc_sweep, soc_sweep_plain

    rng = np.random.default_rng(0)
    S, B, K = 64, 300, 8
    # prefix sums along each read's candidates, windows ending ahead of them
    lens = rng.integers(0, 30, (B, S))
    amb = rng.integers(0, 3, (B, S))
    plen, pamb = np.cumsum(lens, 1), np.cumsum(amb, 1)
    we = np.minimum(np.arange(S)[None, :] + rng.integers(1, 6, (B, S)), S)
    take = lambda a, i: np.take_along_axis(a, np.clip(i, 0, S - 1), 1) * (i >= 0)
    pex, aex = plen - lens, pamb - amb
    pend, aend = take(plen, we - 1), take(pamb, we - 1)
    cand = np.stack([pend - pex, aend - aex, we, pex, aex, pend, aend], -1)
    cand = torch.as_tensor(cand.transpose(1, 0, 2).copy(), dtype=torch.int32, device=cuda)
    n = torch.as_tensor(rng.integers(0, S + 1, B), dtype=torch.int32, device=cuda)
    ms = torch.as_tensor(rng.integers(0, 20, B), dtype=torch.int32, device=cuda)
    got = soc_sweep(cand, n, ms, K)
    want = soc_sweep_plain(cand, n, ms, K)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[2].any())  # K = 8 slots overflow


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
    that is not a multiple of 16 (N = 200), and 16 columns per thread."""
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


@pytest.mark.parametrize("N", [128, 768, 2048, 4096])
def test_dp_fused_v2_direction_bytes(cuda, N):
    """Every direction byte C' streams out (rows < qlen, all N columns)
    against the plain row DP's: 4, 8 and 16 columns per thread."""
    from ma_tpu_torch import kernels
    from ma_tpu_torch.ops.dp import DPParams
    from ma_tpu_torch.ops.dp_rows import banded_align_rows

    rng = np.random.default_rng(N)
    P, M = 12, 48
    (q, t, qlen, tlen, band), tb = _dp_problems(rng, P, M, N, False, cuda)
    pr = DPParams()
    meta_in = torch.stack([qlen, tlen, band, tb], 1).contiguous()
    runs = torch.empty((P, 8), dtype=torch.int32, device=cuda)
    meta = torch.empty((8, P), dtype=torch.int32, device=cuda)
    dirs = torch.empty((P, M, N), dtype=torch.uint8, device=cuda)
    kernels.DP_FUSED_V2.launch(q, t, meta_in, runs, meta, dirs, P, M, N, N, 8, *pr, 30, 0)
    want = banded_align_rows(q, t, qlen, tlen, band, pr, 30, False).dirs
    torch.cuda.synchronize()
    rows = torch.arange(M, device=cuda)[None, :, None] < qlen[:, None, None]
    assert torch.equal(torch.where(rows, dirs, 0), torch.where(rows, want, 0))


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


@pytest.mark.parametrize("is_global,zdrop,M,N,state", [
    (True, -1, 64, 128, "smem"), (False, 30, 64, 128, "smem"),
    (False, 200, 2048, 1024, "smem"), (True, -1, 96, 200, "scratch"),
])
def test_dp_wavefront_and_traceback_kernels(cuda, monkeypatch, is_global, zdrop, M, N, state):
    from ma_tpu_torch.ops import dp_wavefront as W
    from ma_tpu_torch.ops.dp import DPParams

    if state == "scratch":  # the state in global scratch instead of shared memory
        monkeypatch.setattr(W, "SMEM_STATE_BYTES", 0)
    rng = np.random.default_rng(M + int(is_global))
    P = 40
    q = rng.integers(0, 4, (P, M))
    t = np.concatenate([q, rng.integers(0, 4, (P, N))], 1)[:, :N]
    t[rng.random(t.shape) < 0.05] = rng.integers(0, 4)
    t[:, 20:23] = 4
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=cuda)
    args = (dev(q), dev(t), dev(rng.integers(1, M + 1, P)), dev(rng.integers(1, N + 1, P)),
            dev(rng.integers(5, 60, P)), DPParams(), zdrop, is_global)
    got = W.banded_align_wavefront(*args)
    torch.cuda.synchronize()
    want = W.banded_align_wavefront_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    si = torch.where(torch.arange(P, device=cuda) % 7 == 0, -1, got.max_i)
    tb = W.traceback_dirs(got.dirs, si, got.max_j)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tb, W.traceback_dirs_plain(got.dirs, si,
                                                                            got.max_j)))


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
