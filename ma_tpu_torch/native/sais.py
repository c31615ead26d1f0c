"""ctypes binding of the native SA-IS extension (sais.cpp, sais40.cpp).

A plain C ABI shared object compiled with g++ on first use into
ma_tpu_torch/_build/ (native/build.py).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ma_tpu_torch.native.build import shared_library

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = shared_library("sais.cpp")
        lib.sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sais_u8.restype = ctypes.c_int
        _lib = lib
        return lib


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of T$ — same contract as suffix_array_doubling
    (int64 [n+1], entry 0 = the sentinel suffix)."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.sais_u8(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed with {rc}")
    return sa


# ---------------------------------------------------------- packed-40 build
_lib40 = None


def _load40():
    global _lib40
    with _lock:
        if _lib40 is not None:
            return _lib40
        lib = shared_library("sais40.cpp")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sais40_u8.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.sais40_u8.restype = ctypes.c_int
        lib.fmd_from_sa40.argtypes = [
            u8p, ctypes.c_int64, u8p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.fmd_from_sa40.restype = ctypes.c_int64
        _lib40 = lib
        return lib


def fmd_arrays_large(text: np.ndarray, occ_interval: int = 128,
                     sa_interval: int = 32):
    """Memory-bounded FMD artifacts via the packed-40-bit SA-IS
    (native/sais40.cpp — the bwt_large.cpp role): returns
    (primary, bwt_words uint32 [nb, 8], occ_cp int64 [nb, 4],
    ssa int64 [n//sa_interval + 1]) without ever materializing an int64
    suffix array or a uint8 BWT."""
    lib = _load40()
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sa40 = np.empty(5 * (n + 1) + 8, dtype=np.uint8)
    rc = lib.sais40_u8(
        text.ctypes.data_as(u8p), ctypes.c_int64(n), sa40.ctypes.data_as(u8p)
    )
    if rc != 0:
        raise RuntimeError(f"sais40_u8 failed with {rc}")
    nb = -(-n // occ_interval)
    bwt_words = np.zeros((nb, occ_interval // 16), dtype=np.uint32)
    occ_cp = np.zeros((nb, 4), dtype=np.int64)
    ssa = np.zeros(n // sa_interval + 1, dtype=np.int64)
    primary = lib.fmd_from_sa40(
        text.ctypes.data_as(u8p), ctypes.c_int64(n), sa40.ctypes.data_as(u8p),
        bwt_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        occ_cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ssa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(sa_interval),
    )
    if primary < 0:
        raise RuntimeError("fmd_from_sa40 failed")
    return int(primary), bwt_words, occ_cp, ssa
