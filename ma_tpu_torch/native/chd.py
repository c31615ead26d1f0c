"""ctypes binding + lazy build of the CHD perfect-hash builder (chd.cpp).

Used by the minimizer index (index/minimizer.py) to turn the hash lookup
into exactly two device gathers. Built with g++ on first use into
ma_tpu_torch/_build/ (native/build.py).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ma_tpu_torch.native.build import shared_library

_lock = threading.Lock()
_lib = None

# must match chd.cpp
C1 = np.uint32(0x27D4EB2F)
C2 = np.uint32(0x9E3779B1)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = shared_library("chd.cpp")
        lib.chd_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.chd_build.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def build(hu: np.ndarray, uoff: np.ndarray):
    """(D int32 [m], table int32 [T, 3], tlog, mlog) or None on failure.

    table rows are (hash as int32, row_lo, row_hi); empty slots are zeros
    (harmless: a probe only believes a row whose hash matches the query,
    and absent queries can never match a stored — present — hash)."""
    lib = _load()
    U = len(hu)
    if U == 0:
        return None
    hu = np.ascontiguousarray(hu, np.uint32)
    uoff = np.ascontiguousarray(uoff, np.int32)
    tlog = max(8, int(np.ceil(np.log2(U / 0.7))))
    mlog = max(4, int(np.ceil(np.log2(max(U / 4.0, 2)))))
    for _ in range(3):
        T = 1 << tlog
        m = 1 << mlog
        D = np.zeros(m, np.int32)
        table = np.zeros((T, 3), np.int32)
        rc = lib.chd_build(
            hu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            uoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(U), ctypes.c_int64(tlog), ctypes.c_int64(mlog),
            D.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return D, table, tlog, mlog
        tlog += 1
    return None


def slots_np(h: np.ndarray, d: np.ndarray, tlog: int) -> np.ndarray:
    """Host mirror of the device slot function (for tests)."""
    with np.errstate(over="ignore"):
        return ((h.astype(np.uint32) ^ (d.astype(np.uint32) * C1)) * C2) >> np.uint32(
            32 - tlog
        )
