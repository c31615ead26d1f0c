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


@pytest.mark.parametrize("N", [128, 768, 2048, 4096, 4224])
def test_dp_fused_v2_direction_bytes(cuda, N):
    """Every direction byte C' streams out (rows < qlen, all N columns)
    against the plain row DP's: 4, 8 and 16 columns per thread, and rows
    walked in chunks of 4,096 (N = 4,224)."""
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
    carry = torch.empty((P, kernels.query("ma_dp_fused_v2_carry_ints", N, N)),
                        dtype=torch.int32, device=cuda)
    kernels.DP_FUSED_V2.launch(q, t, meta_in, runs, meta, dirs, carry if carry.numel() else 0,
                               P, M, N, N, 8, *pr, 30, 0)
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
    version: rows in registers up to 4,096 columns, in chunks of 4,096
    past that."""
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
