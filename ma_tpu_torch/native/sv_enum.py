"""ctypes binding + lazy build of the MSV enumeration front end
(sv_enum.cpp): feasible-SoC extraction -> rectangle reseeding -> maximal
extension -> per-read seed union, C++ at unchanged output vs the Python
oracles (msv/pipeline.feasible_socs + ops/hash_seeding.reseed_gaps +
ops/extend_host.extend_seeds). A copy of ma_tpu/native/sv_enum.py, built
with g++ on first use into ma_tpu_torch/_build/ (native/build.py); a
failed build raises (ma_tpu's copy falls back to the Python path then).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ma_tpu_torch.native.build import shared_library

_lock = threading.Lock()
_lib = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = shared_library("sv_enum.cpp")
        lib.sv_enum.argtypes = [
            _i32p, _i32p, _i32p, _u8p, _u8p,  # seeds q,l,r,fw,va
            _i32p, _i32p, _i32p, _i32p,       # soc start,end,score,n
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B,S,C
            _u8p, _i32p, ctypes.c_int64,      # seqs, lens, Lpad
            _u8p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,  # pack
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # min_nt, height, reseed
            ctypes.c_double, ctypes.c_int64, ctypes.c_int64,  # t, max_size, padding
            ctypes.c_int64,                   # cap
            _i64p, _i64p, _i64p, _u8p, _i64p, _i64p,  # outputs
        ]
        lib.sv_enum.restype = ctypes.c_int64
        _lib = lib
        return lib


def enumerate_batch(
    soc_host,
    seqs: np.ndarray,
    lens: np.ndarray,
    pack,
    min_nt: int,
    soc_height: int,
    do_reseed: bool,
    t: float = 0.001,
    max_size: int = 50,
    padding: int = 100,
):
    """One call per read batch. Returns (q, l, r, fw, nt, per_read_count)
    numpy arrays — the concatenated per-read seed unions in read order."""
    lib = _load()
    q = np.ascontiguousarray(soc_host.q, np.int32)
    l = np.ascontiguousarray(soc_host.l, np.int32)
    r = np.ascontiguousarray(soc_host.r, np.int32)
    fw = np.ascontiguousarray(soc_host.fw, np.uint8)
    va = np.ascontiguousarray(soc_host.va, np.uint8)
    ss = np.ascontiguousarray(soc_host.starts, np.int32)
    se = np.ascontiguousarray(soc_host.ends, np.int32)
    sc = np.ascontiguousarray(soc_host.scores, np.int32)
    ns = np.ascontiguousarray(soc_host.n_socs, np.int32)
    B, S = q.shape
    C = ss.shape[1]
    seqs = np.ascontiguousarray(seqs, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    ref = np.ascontiguousarray(pack.codes, np.uint8)
    cstarts = np.ascontiguousarray(pack.starts, np.int64)
    clens = np.ascontiguousarray(pack.lengths, np.int64)
    cap = max(4096, 8 * S)
    while True:
        oq = np.empty(cap, np.int64)
        ol = np.empty(cap, np.int64)
        orr = np.empty(cap, np.int64)
        ofw = np.empty(cap, np.uint8)
        ont = np.empty(cap, np.int64)
        cnt = np.zeros(B, np.int64)
        n = lib.sv_enum(
            q.ctypes.data_as(_i32p), l.ctypes.data_as(_i32p),
            r.ctypes.data_as(_i32p), fw.ctypes.data_as(_u8p),
            va.ctypes.data_as(_u8p), ss.ctypes.data_as(_i32p),
            se.ctypes.data_as(_i32p), sc.ctypes.data_as(_i32p),
            ns.ctypes.data_as(_i32p), B, S, C,
            seqs.ctypes.data_as(_u8p), lens.ctypes.data_as(_i32p),
            seqs.shape[1],
            ref.ctypes.data_as(_u8p), pack.unpacked_size_forward_strand,
            cstarts.ctypes.data_as(_i64p), clens.ctypes.data_as(_i64p),
            len(cstarts),
            min_nt, soc_height, 1 if do_reseed else 0, t, max_size, padding,
            cap,
            oq.ctypes.data_as(_i64p), ol.ctypes.data_as(_i64p),
            orr.ctypes.data_as(_i64p), ofw.ctypes.data_as(_u8p),
            ont.ctypes.data_as(_i64p), cnt.ctypes.data_as(_i64p),
        )
        if n < 0:
            cap = max(cap * 2, -n)
            continue
        return oq[:n], ol[:n], orr[:n], ofw[:n].astype(bool), ont[:n], cnt
