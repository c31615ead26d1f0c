"""Native finish stage: C++ planning/assembly + vectorized DP dispatch.

Pairs with ma_tpu_torch/native/finish.cpp (the reference's C++ per-read tail:
needlemanWunsch.cpp execute_one:625-905 / dynPrg:499-623 /
ksw_dual_ext:239-498 and Alignment::append, alignment.cpp:25-65). The
Python implementations in ma_tpu_torch/pipeline/nw.py remain the reference
semantics; this path must produce identical alignments. The port's SAM
tests (tests/test_torch_slice*.py) hold it against ma_tpu's, and
tests/test_torch_host.py holds each native finish call against ma_tpu's.

Scope: descriptor-mode batches whose DP problems all fit the fused kernel
buckets (short/medium reads). Anything else falls back to the Python
path in aligner.plan_batch.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List

import numpy as np

from ma_tpu_torch.containers.alignment import Alignment
from ma_tpu_torch.native.build import shared_library

_lock = threading.Lock()
_lib = None
_sam_lib = None

_OP_CHARS = np.array(["s", "=", "X", "I", "D"])


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = shared_library("finish.cpp")
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.finish_plan.argtypes = [
            i32p, i32p, i32p, i64p, ctypes.c_int64, i32p, i32p,
            i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int64, i32p, ctypes.c_int64, i64p, i64p, i64p,
        ]
        lib.finish_plan.restype = ctypes.c_int
        lib.finish_assemble.argtypes = [
            i32p, ctypes.c_int64, i64p, i32p, ctypes.c_int64,
            i32p, i64p, i64p, u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, i32p, i64p, i64p, ctypes.c_int64,
        ]
        lib.finish_assemble.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _load_sam():
    global _sam_lib
    with _lock:
        if _sam_lib is not None:
            return _sam_lib
        lib = shared_library("samout.cpp")
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sam_emit.argtypes = [
            u8p, i32p, i64p, i64p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int64, u8p, ctypes.c_int64, i32p, u8p, i64p, u8p, i64p,
            i64p, ctypes.c_int64, ctypes.c_int64, u8p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, ctypes.c_int64, i64p, i64p,
        ]
        lib.sam_emit.restype = ctypes.c_int
        _sam_lib = lib
        return lib


def sam_available() -> bool:
    try:
        _load_sam()
        return True
    except Exception:
        return False


def _concat_bytes(strs):
    offs = np.zeros(len(strs) + 1, np.int64)
    parts = []
    for i, s in enumerate(strs):
        b = s.encode("ascii", "replace") if s else b""
        parts.append(b)
        offs[i + 1] = offs[i] + len(b)
    buf = np.frombuffer(b"".join(parts) + b"\0", np.uint8).copy()
    return buf, offs


def emit_sam(out_op, out_len, out_off, out_meta, set_read, set_soc, reads,
             seqs_np, pack, match, max_supplementary, max_overlap, report_n,
             min_score, soft_clip, use_m, omit_sec, omit_sup):
    """Native mapping-quality + SAM text emission. Returns (bytes, n_recs)
    or None when the workload needs the Python writer (rc=2)."""
    lib = _load_sam()
    n_sets = len(out_meta)
    n_reads = len(reads)
    qlen = np.asarray([len(r) for r in reads], np.int32)
    names, name_off = _concat_bytes([r.name or "" for r in reads])
    quals, qual_off = _concat_bytes([r.qual or "" for r in reads])
    ctg_names, ctg_name_off = _concat_bytes(list(pack.names))
    ctg_starts = np.ascontiguousarray(pack.starts, np.int64)
    out_op = np.ascontiguousarray(out_op, np.uint8)
    out_len = np.ascontiguousarray(out_len, np.int32)
    out_off = np.ascontiguousarray(out_off, np.int64)
    out_meta = np.ascontiguousarray(out_meta, np.int64)
    set_read = np.ascontiguousarray(set_read, np.int32)
    set_soc = np.ascontiguousarray(set_soc, np.int32)
    seqs_np = np.ascontiguousarray(seqs_np, np.uint8)
    cap = int(n_sets) * (2 * int(seqs_np.shape[1]) + 96) + 65536
    for _ in range(3):
        buf = np.empty(cap, np.uint8)
        n_bytes = np.zeros(1, np.int64)
        n_recs = np.zeros(1, np.int64)
        rc = lib.sam_emit(
            _p(out_op, ctypes.c_uint8), _p(out_len, ctypes.c_int32),
            _p(out_off, ctypes.c_int64), _p(out_meta, ctypes.c_int64),
            _p(set_read, ctypes.c_int32), _p(set_soc, ctypes.c_int32),
            ctypes.c_int64(n_sets), ctypes.c_int64(n_reads),
            _p(seqs_np, ctypes.c_uint8), ctypes.c_int64(seqs_np.shape[1]),
            _p(qlen, ctypes.c_int32), _p(names, ctypes.c_uint8),
            _p(name_off, ctypes.c_int64), _p(quals, ctypes.c_uint8),
            _p(qual_off, ctypes.c_int64), _p(ctg_starts, ctypes.c_int64),
            ctypes.c_int64(pack.num_contigs),
            ctypes.c_int64(pack.unpacked_size_forward_strand),
            _p(ctg_names, ctypes.c_uint8), _p(ctg_name_off, ctypes.c_int64),
            ctypes.c_int64(match), ctypes.c_int64(max_supplementary),
            ctypes.c_double(max_overlap), ctypes.c_int64(report_n),
            ctypes.c_int64(min_score), ctypes.c_int64(int(soft_clip)),
            ctypes.c_int64(int(use_m)), ctypes.c_int64(int(omit_sec)),
            ctypes.c_int64(int(omit_sup)),
            _p(buf, ctypes.c_uint8), ctypes.c_int64(cap),
            _p(n_bytes, ctypes.c_int64), _p(n_recs, ctypes.c_int64),
        )
        if rc == 0:
            return buf[: int(n_bytes[0])].tobytes(), int(n_recs[0])
        if rc == 2:
            return None
        cap = int(n_bytes[0]) + 65536
    raise RuntimeError("sam_emit: output overflow")


def _p(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def plan(pack, cfg, reads, seqs_np, hq, hl, hr, set_off, set_read, set_soc):
    """Run the C++ planner. Returns (desc [n_prob, 9] int32, toks,
    set_begin_ref) or None if outputs overflow (caller falls back)."""
    lib = _load()
    n_sets = len(set_off) - 1
    qlen_per_read = np.asarray([len(r) for r in reads], np.int32)
    max_prob = max(64, 4 * n_sets + 16)
    max_tok = max(128, 12 * n_sets + 16)
    for _ in range(3):
        desc = np.zeros((max_prob, 9), np.int32)
        toks = np.zeros((max_tok, 8), np.int32)
        sbr = np.zeros(n_sets, np.int64)
        n_prob = np.zeros(1, np.int64)
        n_tok = np.zeros(1, np.int64)
        rc = lib.finish_plan(
            _p(hq, ctypes.c_int32), _p(hl, ctypes.c_int32),
            _p(hr, ctypes.c_int32), _p(set_off, ctypes.c_int64),
            ctypes.c_int64(n_sets), _p(set_read, ctypes.c_int32),
            _p(qlen_per_read, ctypes.c_int32),
            _p(pack.starts, ctypes.c_int64), _p(pack.lengths, ctypes.c_int64),
            ctypes.c_int64(pack.num_contigs),
            ctypes.c_int64(pack.unpacked_size_forward_strand),
            ctypes.c_int64(cfg.padding), ctypes.c_int64(cfg.band_ext),
            ctypes.c_int64(cfg.min_band_gap), ctypes.c_int64(cfg.max_gap_area),
            _p(desc, ctypes.c_int32), ctypes.c_int64(max_prob),
            _p(toks, ctypes.c_int32), ctypes.c_int64(max_tok),
            _p(sbr, ctypes.c_int64), _p(n_prob, ctypes.c_int64),
            _p(n_tok, ctypes.c_int64),
        )
        if rc == 0:
            return (desc[: int(n_prob[0])], toks[: int(n_tok[0])], sbr)
        max_prob *= 4
        max_tok *= 4
    return None


def assemble(planned_toks, set_begin_ref, set_read, prob_runs, prob_off,
             prob_meta, text_host, seqs_np, params, sv_penalty):
    """Run the C++ assembler. Returns (out_op, out_len, out_off, out_meta)."""
    lib = _load()
    n_sets = len(set_begin_ref)
    max_out = max(256, int(prob_off[-1]) * 3 + 64 * n_sets)
    toks = np.ascontiguousarray(planned_toks, np.int32)
    prob_runs = np.ascontiguousarray(prob_runs, np.int32)
    prob_off = np.ascontiguousarray(prob_off, np.int64)
    prob_meta = np.ascontiguousarray(prob_meta, np.int64)
    set_read = np.ascontiguousarray(set_read, np.int32)
    sbr = np.ascontiguousarray(set_begin_ref, np.int64)
    for _ in range(3):
        out_op = np.zeros(max_out, np.uint8)
        out_len = np.zeros(max_out, np.int32)
        out_off = np.zeros(n_sets + 1, np.int64)
        out_meta = np.zeros((n_sets, 6), np.int64)
        rc = lib.finish_assemble(
            _p(toks, ctypes.c_int32), ctypes.c_int64(len(toks)),
            _p(sbr, ctypes.c_int64), _p(set_read, ctypes.c_int32),
            ctypes.c_int64(n_sets),
            _p(prob_runs, ctypes.c_int32), _p(prob_off, ctypes.c_int64),
            _p(prob_meta, ctypes.c_int64),
            _p(text_host, ctypes.c_uint8), ctypes.c_int64(len(text_host)),
            _p(seqs_np, ctypes.c_uint8), ctypes.c_int64(seqs_np.shape[1]),
            ctypes.c_int64(params.match), ctypes.c_int64(params.mismatch),
            ctypes.c_int64(params.gap_open), ctypes.c_int64(params.gap_extend),
            ctypes.c_int64(sv_penalty),
            _p(out_op, ctypes.c_uint8), _p(out_len, ctypes.c_int32),
            _p(out_off, ctypes.c_int64), _p(out_meta, ctypes.c_int64),
            ctypes.c_int64(max_out),
        )
        if rc == 0:
            return out_op, out_len, out_off, out_meta
        max_out *= 4
    raise RuntimeError("finish_assemble: output overflow")


def build_alignments(out_op, out_len, out_off, out_meta, set_read, set_soc,
                     reads, params, sv_penalty):
    """Materialize Alignment objects from assembled runs (fast path around
    Alignment.append — fields are set directly from the C++ results)."""
    per_read: List[List[Alignment]] = [[] for _ in reads]
    for s in range(len(out_meta)):
        if not out_meta[s][5]:
            continue
        b = int(set_read[s])
        a = Alignment(
            begin_on_ref=int(out_meta[s][0]), begin_on_query=int(out_meta[s][2]),
            match=params.match, mismatch=params.mismatch,
            gap=params.gap_open, extend=params.gap_extend,
            sv_penalty=sv_penalty,
        )
        lo, hi = int(out_off[s]), int(out_off[s + 1])
        a.data = [
            (_OP_CHARS[out_op[k]], int(out_len[k])) for k in range(lo, hi)
        ]
        a.end_on_ref = int(out_meta[s][1])
        a.end_on_query = int(out_meta[s][3])
        a.iscore = int(out_meta[s][4])
        a.stats.index_of_strip = int(set_soc[s])
        a.stats.name = reads[b].name
        per_read[b].append(a)
    return per_read
