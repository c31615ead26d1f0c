"""Build, bind and launch the hand-written CUDA kernels under csrc/.

Each source is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build goes into
`ma_tpu_torch/_build/` on first use (the library name carries a digest of
the sources and flags, so an edited source is rebuilt). Nothing is built
at import time: the CPU tests import every module of the package.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.launch` raises on a non-zero code and counts
the launch. There is no fallback: a missing nvcc, a failed build or a
refused launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("errors.cu", "soc_sweep.cu", "linesweep.cu", "dp_fused.cu", "dp_fused_v2.cu",
           "dp_wavefront.cu", "dp_traceback.cu", "fmd_seed.cu")
HEADERS = ("common.cuh", "dp_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit PyTorch found;
    raises if there is none."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source digest):
    one nvcc process per source, in parallel, then one link. Returns its
    path; the compilers' output is kept in `<lib>.log`."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"libma_tpu_kernels-{_digest()}.so"
    if so.is_file():
        return so
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / src)]
            for src, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f"{tag}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    res = None if failed else subprocess.run(link, capture_output=True, text=True)
    log = so.with_suffix(".log")
    log.write_text("".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
                   + ("" if res is None else " ".join(link) + "\n" + res.stdout + res.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed[0][0][-1]}:\n{failed[0][1][-4000:]}")
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ma_cuda_error_string.argtypes = [ctypes.c_int]
            lib.ma_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def query(symbol: str, *args: int) -> int:
    """Call a host-side C entry of the library that takes ints and returns
    a 64-bit int (a size the caller allocates, for instance)."""
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate a kernel operand: CUDA device, dtype, shape, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


class Kernel:
    """One CUDA kernel of csrc/: its C entry point and a count of launches.

    `signature` lists the C arguments before the trailing stream: "p" for a
    device pointer (a tensor), "i" for an int."""

    def __init__(self, name: str, symbol: str, signature: str, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.signature = signature
        self.source = source
        self.replaces = replaces
        self.launches = 0
        # launches and work items per launch shape, for wrappers that name one
        self.tally: dict = {}
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.tally = {}

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in self.signature] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, shape=None, items: int = 0) -> None:
        """Launch with `args` (tensors and ints, in the C signature's order);
        `shape` (any hashable) and `items` add to the tally."""
        if len(args) != len(self.signature):
            raise TypeError(f"{self.name}: expected {len(self.signature)} arguments")
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
        fn = self._bind()
        with torch.cuda.device(dev):
            rc = fn(*conv, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = library().ma_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({rc})")
        self.launches += 1
        if shape is not None:
            n, k = self.tally.get(shape, (0, 0))
            self.tally[shape] = (n + 1, k + items)


SOC_SWEEP = Kernel("soc_sweep", "ma_soc_sweep", "ppppppiii",
                   "ma_tpu_torch/csrc/soc_sweep.cu",
                   "ma_tpu/ops/soc_pallas.py:26")
LINESWEEP = Kernel("linesweep", "ma_linesweep", "pppppii",
                   "ma_tpu_torch/csrc/linesweep.cu",
                   "ma_tpu/ops/harmonize_pallas.py:26")
DP_FUSED = Kernel("dp_fused", "ma_dp_fused", "pppppp" + "i" * 12,
                  "ma_tpu_torch/csrc/dp_fused.cu",
                  "ma_tpu/ops/dp_fused.py:100")
DP_FUSED_V2 = Kernel("dp_fused_v2", "ma_dp_fused_v2", "ppppppp" + "i" * 13,
                     "ma_tpu_torch/csrc/dp_fused_v2.cu",
                     "ma_tpu/ops/dp_fused.py:843")
DP_WAVEFRONT = Kernel("dp_wavefront", "ma_dp_wavefront", "ppppppp" + "i" * 12,
                      "ma_tpu_torch/csrc/dp_wavefront.cu",
                      "ma_tpu/ops/dp_pallas.py:53")
DP_TRACEBACK = Kernel("dp_traceback", "ma_dp_traceback", "ppppiii",
                      "ma_tpu_torch/csrc/dp_traceback.cu",
                      "ma_tpu/ops/dp.py:209")
FMD_SEED = Kernel("fmd_seed", "ma_fmd_seed", "pppppppppppp" + "i" * 9,
                  "ma_tpu_torch/csrc/fmd_seed.cu",
                  "ma_tpu/ops/seeding.py:102 max_spanning_seeding")
KERNELS = (SOC_SWEEP, LINESWEEP, DP_FUSED, DP_FUSED_V2, DP_WAVEFRONT, DP_TRACEBACK, FMD_SEED)
