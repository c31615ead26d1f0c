"""MSV SQL schema + query objects over ma_tpu_torch.db — the sv_db role.

A copy of ma_tpu/msv/sv_db.py, changed only in its imports.

Mirrors the reference's table set (reference:
libs/msv/inc/msv/container/sv_db/tables/ — sequencer.h:26, read.h:24,
pairedRead.h:22, svJump.h:42, svCallerRun.h:23, svCall.h:46-685,
svCallSupport.h:21, kMerFilter.h:23) and its query objects
(query_objects/fetchSvJump.h SortedSvJumpFromSql, fetchCalls.h SvCallsFromDb,
nucSeqSql.h NucSeqFetcher, jump/call inserters) on the sqlite3-backed typed
tables in db/sql_api.py. Rectangle queries (the sweep's fetch and
call overlap checks) run on R*Tree indexes.

The npz SvStore (msv/store.py) remains the fast serverless path; SvDb
carries the same run-id model with SQL restartability and the same
insert/load surface. Both load jumps as the SvJump list that
sweep_sv_jumps takes, in insertion order; SvDb's jump ids are its row ids
(1, 2, ... in a fresh file), SvStore's the positions (0, 1, ...).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ma_tpu_torch.containers.nucseq import NucSeq, compress_codes, decompress_codes
from ma_tpu_torch.db.sql_api import SQLDB, SQLTable, SQLTableWithAutoPriKey
from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import JumpParams, SvJump


def _pack_seq(codes: np.ndarray) -> bytes:
    """CompressedNucSeq blob (nucSeq.h:854 CompressedNucSeq role)."""
    packed, n, runs = compress_codes(np.asarray(codes, np.uint8))
    head = np.asarray([n, runs.shape[0]], np.int64).tobytes()
    return head + np.asarray(runs, np.int64).tobytes() + packed.tobytes()


def _unpack_seq(blob: bytes) -> np.ndarray:
    head = np.frombuffer(blob[:16], np.int64)
    n, n_runs = int(head[0]), int(head[1])
    runs = np.frombuffer(blob[16 : 16 + 16 * n_runs], np.int64).reshape(n_runs, 2)
    packed = np.frombuffer(blob[16 + 16 * n_runs :], np.uint8)
    return decompress_codes(packed.copy(), n, runs)


class SvDb:
    """All MSV tables against one database file (or :memory:)."""

    def __init__(self, path: str = ":memory:", drop_on_closure: bool = False):
        self.db = SQLDB(path, drop_on_closure=drop_on_closure)
        d = self.db
        self.sequencer = SQLTableWithAutoPriKey(
            d, "sequencer_table", [("name", str)]
        )
        self.reads = SQLTableWithAutoPriKey(
            d,
            "read_table",
            [("sequencer_id", int), ("name", str), ("sequence", bytes)],
            indices=("sequencer_id",),
        )
        self.paired_reads = SQLTable(
            d,
            "paired_read_table",
            [("first_read", int), ("second_read", int)],
        )
        self.runs = SQLTableWithAutoPriKey(
            d,
            "sv_caller_run_table",
            [("name", str), ("desc", str), ("time_stamp", str)],
        )
        self.jumps = SQLTableWithAutoPriKey(
            d,
            "sv_jump_table",
            [
                ("sv_jump_run_id", int),
                ("read_id", int),
                ("sort_pos_start", int),
                ("sort_pos_end", int),
                ("from_pos", int),
                ("to_pos", int),
                ("query_from", int),
                ("query_to", int),
                ("from_forward", bool),
                ("to_forward", bool),
                ("num_supporting_nt", int),
                ("was_mirrored", bool),
            ],
            indices=("sv_jump_run_id, sort_pos_start",),
        )
        self.calls = SQLTableWithAutoPriKey(
            d,
            "sv_call_table",
            [
                ("sv_caller_run_id", int),
                ("from_pos", int),
                ("to_pos", int),
                ("from_size", int),
                ("to_size", int),
                ("from_forward", bool),
                ("to_forward", bool),
                ("inserted_sequence", bytes),
                ("supporting_reads", int),
                ("supporting_nt", int),
                ("reference_ambiguity", int),
                ("order_id", int),
                ("ctg_order_id", int),
                ("mirrored", bool),
            ],
            indices=("sv_caller_run_id",),
        )
        self.call_support = SQLTable(
            d,
            "sv_call_support_table",
            [("call_id", int), ("jump_id", int)],
            indices=("call_id",),
        )
        self.kmer_filter = SQLTable(
            d,
            "k_mer_filter_table",
            [("pack_id", int), ("k_mer", bytes), ("num_occ", int)],
        )

    def close(self) -> None:
        self.db.close()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False

    # ----------------------------------------------------------------- reads
    def new_sequencer(self, name: str) -> int:
        return self.sequencer.insert(name)

    def insert_reads(self, sequencer_id: int, reads: Sequence[NucSeq]) -> List[int]:
        """ReadInserter (insertReads.py:6 / read.h:24): returns read ids."""
        ids = []
        with self.db.transaction():
            for r in reads:
                ids.append(
                    self.reads.insert(sequencer_id, r.name, _pack_seq(r.codes))
                )
        return ids

    def insert_paired_reads(
        self, sequencer_id: int, pairs: Sequence[Tuple[NucSeq, NucSeq]]
    ) -> List[Tuple[int, int]]:
        out = []
        with self.db.transaction():
            for a, b in pairs:
                ia = self.reads.insert(sequencer_id, a.name, _pack_seq(a.codes))
                ib = self.reads.insert(sequencer_id, b.name, _pack_seq(b.codes))
                self.paired_reads.insert(ia, ib)
                out.append((ia, ib))
        return out

    def fetch_reads(self, sequencer_id: Optional[int] = None) -> Iterator[NucSeq]:
        """NucSeqFetcher (nucSeqSql.h:97): volatile read stream from the DB."""
        if sequencer_id is None:
            rows = self.reads.select("id, name, sequence", order="id")
        else:
            rows = self.reads.select(
                "id, name, sequence", "sequencer_id=?", (sequencer_id,), order="id"
            )
        for rid, name, blob in rows:
            seq = NucSeq(_unpack_seq(blob), name=name)
            seq.id = rid
            yield seq

    # ------------------------------------------------------------------ runs
    def new_run(self, name: str, desc: str = "", kind: str = "jumps") -> int:
        import time as _time

        return self.runs.insert(name, desc, _time.strftime("%Y-%m-%d %H:%M:%S"))

    # ----------------------------------------------------------------- jumps
    def insert_jumps(self, run_id: int, jumps: Sequence[SvJump]) -> None:
        """JumpInserter: bulk insert with the two sweep sort keys
        precomputed (svJump.h's sort orders)."""
        with self.jumps.bulk_inserter() as bi:
            for j in jumps:
                start = min(j.from_pos, j.to_pos)
                end = max(j.from_pos, j.to_pos)
                bi.insert(
                    run_id, j.read_id, start, end, j.from_pos, j.to_pos,
                    j.query_from, j.query_to, j.from_forward, j.to_forward,
                    j.num_supporting_nt, j.was_mirrored,
                )

    def create_jump_indices(self, run_id: int) -> None:
        """SvJumpTable.create_indices post-pass (computeSvJumps.py:109)."""
        self.jumps.gen_rectangle_index(
            "from_pos", "0", "to_pos", "0"
        )

    def load_jumps(
        self, run_id: int, params: JumpParams = JumpParams()
    ) -> List[SvJump]:
        rows = self.jumps.select(
            "id, from_pos, to_pos, query_from, query_to, from_forward, "
            "to_forward, num_supporting_nt, read_id, was_mirrored",
            "sv_jump_run_id=?",
            (run_id,),
            order="id",
        )
        return [
            SvJump(
                from_pos=r[1], to_pos=r[2], query_from=r[3], query_to=r[4],
                from_forward=bool(r[5]), to_forward=bool(r[6]),
                num_supporting_nt=r[7], read_id=r[8], was_mirrored=bool(r[9]),
                id=r[0], params=params,
            )
            for r in rows
        ]

    def jumps_in_section(
        self, run_id: int, start: int, end: int,
        params: JumpParams = JumpParams(),
    ) -> List[SvJump]:
        """SortedSvJumpFromSql (fetchSvJump.h): jumps whose sort interval
        overlaps the genome section [start, end) — the sweep's fetch."""
        rows = self.jumps.select(
            "id, from_pos, to_pos, query_from, query_to, from_forward, "
            "to_forward, num_supporting_nt, read_id, was_mirrored",
            "sv_jump_run_id=? AND sort_pos_start < ? AND sort_pos_end >= ?",
            (run_id, end, start),
            order="sort_pos_start, id",
        )
        return [
            SvJump(
                from_pos=r[1], to_pos=r[2], query_from=r[3], query_to=r[4],
                from_forward=bool(r[5]), to_forward=bool(r[6]),
                num_supporting_nt=r[7], read_id=r[8], was_mirrored=bool(r[9]),
                id=r[0], params=params,
            )
            for r in rows
        ]

    # ----------------------------------------------------------------- calls
    def insert_calls(self, run_id: int, calls: Sequence[SvCall]) -> List[int]:
        """CallInserter/CallVectorInserter + sv_call_support_table rows."""
        ids = []
        with self.db.transaction():
            for c in calls:
                blob = (
                    _pack_seq(c.inserted_sequence)
                    if c.inserted_sequence is not None
                    else b""
                )
                cid = self.calls.insert(
                    run_id, c.from_pos, c.to_pos, c.from_size, c.to_size,
                    c.from_forward, c.to_forward, blob, c.supp_reads,
                    c.supp_nt, c.reference_ambiguity, c.order_id,
                    c.ctg_order_id, c.mirrored,
                )
                ids.append(cid)
                for jid in c.supporting_jump_ids:
                    self.call_support.insert(cid, jid)
        return ids

    def create_call_indices(self, run_id: int) -> None:
        """SvCallTable.gen_indices (sweepSvJumps.py:124)."""
        self.calls.gen_rectangle_index("from_pos", "from_size", "to_pos", "to_size")

    def _row_to_call(self, r) -> SvCall:
        seq = _unpack_seq(r[8]) if r[8] else None
        call = SvCall(
            from_pos=r[1], to_pos=r[2], from_size=r[3], to_size=r[4],
            from_forward=bool(r[5]), to_forward=bool(r[6]),
            inserted_sequence=seq, supp_reads=r[9], supp_nt=r[10],
            reference_ambiguity=r[11], id=r[0], order_id=r[12],
            ctg_order_id=r[13], mirrored=bool(r[14]),
        )
        call.supporting_jump_ids = [
            row[0]
            for row in self.call_support.select(
                "jump_id", "call_id=?", (r[0],), order="jump_id"
            )
        ]
        return call

    _CALL_COLS = (
        "id, from_pos, to_pos, from_size, to_size, from_forward, to_forward, "
        "sv_caller_run_id, inserted_sequence, supporting_reads, supporting_nt, "
        "reference_ambiguity, order_id, ctg_order_id, mirrored"
    )

    def load_calls(
        self,
        run_id: int,
        from_range: Optional[tuple] = None,
        to_range: Optional[tuple] = None,
    ) -> List[SvCall]:
        """SvCallsFromDb (fetchCalls.h), with the store.py range semantics
        (filter on the rectangle START positions)."""
        where = "sv_caller_run_id=?"
        args: list = [run_id]
        if from_range is not None:
            where += " AND from_pos >= ? AND from_pos < ?"
            args += [from_range[0], from_range[1]]
        if to_range is not None:
            where += " AND to_pos >= ? AND to_pos < ?"
            args += [to_range[0], to_range[1]]
        rows = self.calls.select(self._CALL_COLS, where, tuple(args), order="id")
        return [self._row_to_call(r) for r in rows]

    def calls_overlapping(
        self, run_id: int, min_x: int, max_x: int, min_y: int, max_y: int
    ) -> List[SvCall]:
        """Rectangle overlap via the R*Tree (the spatial-query role used by
        call merging and the visualizer)."""
        rows = [
            r
            for r in self.calls.select_rectangle(
                min_x, max_x, min_y, max_y, what=self._CALL_COLS, order="id"
            )
            if r[7] == run_id
        ]
        return [self._row_to_call(r) for r in rows]
