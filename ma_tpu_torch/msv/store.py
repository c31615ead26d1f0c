"""Run-id keyed persistence for jumps and calls — the sv_db role.

A copy of ma_tpu/msv/store.py, changed only in its imports.

The reference persists MSV state in PostgreSQL/MySQL tables keyed by run
ids (reference: libs/msv/inc/msv/container/sv_db/tables/*.h — jump_table,
sv_caller_run_table, sv_call_table w/ spatial indexes;
libs/db_connect/ provides the pool + bulk inserters). Here the same run-id
model persists as npz archives + a JSON run registry: stages stay
individually restartable (compute jumps once, sweep many times), queries
over rectangles are numpy range filters over sorted arrays — no database
server, no connection pool.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ma_tpu_torch.msv.calls import SvCall
from ma_tpu_torch.msv.jumps import DUMMY_LOCATION, JumpParams, SvJump


class SvStore:
    """Directory-backed store: <dir>/runs.json + <dir>/jumps_<id>.npz +
    <dir>/calls_<id>.npz."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._runs_file = os.path.join(path, "runs.json")
        if os.path.exists(self._runs_file):
            with open(self._runs_file) as f:
                self.runs: Dict[str, dict] = json.load(f)
        else:
            self.runs = {}

    def _save_runs(self) -> None:
        with open(self._runs_file, "w") as f:
            json.dump(self.runs, f, indent=1)

    def new_run(self, name: str, desc: str = "", kind: str = "jumps") -> int:
        """sv_caller_run_table / JumpRunTable row."""
        run_id = 1 + max((int(k) for k in self.runs), default=0)
        self.runs[str(run_id)] = {
            "name": name,
            "desc": desc,
            "kind": kind,
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        self._save_runs()
        return run_id

    # ------------------------------------------------------------------ jumps
    def insert_jumps(self, run_id: int, jumps: Sequence[SvJump]) -> None:
        n = len(jumps)
        arr = np.zeros((n, 9), np.int64)
        for i, j in enumerate(jumps):
            arr[i] = (
                j.from_pos, j.to_pos, j.query_from, j.query_to,
                int(j.from_forward), int(j.to_forward), j.num_supporting_nt,
                j.read_id, int(j.was_mirrored),
            )
        np.savez_compressed(
            os.path.join(self.path, f"jumps_{run_id}.npz"), jumps=arr
        )

    def load_jumps(
        self, run_id: int, params: JumpParams = JumpParams()
    ) -> List[SvJump]:
        z = np.load(os.path.join(self.path, f"jumps_{run_id}.npz"))
        out = []
        for i, row in enumerate(z["jumps"]):
            out.append(
                SvJump(
                    from_pos=int(row[0]), to_pos=int(row[1]),
                    query_from=int(row[2]), query_to=int(row[3]),
                    from_forward=bool(row[4]), to_forward=bool(row[5]),
                    num_supporting_nt=int(row[6]), read_id=int(row[7]),
                    was_mirrored=bool(row[8]), id=i, params=params,
                )
            )
        return out

    # ------------------------------------------------------------------ calls
    def insert_calls(self, run_id: int, calls: Sequence[SvCall]) -> None:
        n = len(calls)
        arr = np.zeros((n, 11), np.int64)
        ins: List[np.ndarray] = []
        for i, c in enumerate(calls):
            arr[i] = (
                c.from_pos, c.to_pos, c.from_size, c.to_size,
                int(c.from_forward), int(c.to_forward), c.supp_reads,
                c.supp_nt, c.reference_ambiguity, c.order_id, c.ctg_order_id,
            )
            ins.append(
                np.asarray(c.inserted_sequence, np.uint8)
                if c.inserted_sequence is not None
                else np.zeros(0, np.uint8)
            )
        lens = np.array([len(x) for x in ins], np.int64)
        blob = np.concatenate(ins) if ins else np.zeros(0, np.uint8)
        np.savez_compressed(
            os.path.join(self.path, f"calls_{run_id}.npz"),
            calls=arr, ins_lens=lens, ins_blob=blob,
        )

    def load_calls(
        self,
        run_id: int,
        from_range: Optional[tuple] = None,
        to_range: Optional[tuple] = None,
    ) -> List[SvCall]:
        """Optionally filter by rectangle — the spatial-index query role."""
        z = np.load(os.path.join(self.path, f"calls_{run_id}.npz"))
        arr = z["calls"]
        lens = z["ins_lens"]
        blob = z["ins_blob"]
        offs = np.concatenate(([0], np.cumsum(lens)))
        keep = np.ones(len(arr), bool)
        if from_range is not None:
            keep &= (arr[:, 0] >= from_range[0]) & (arr[:, 0] < from_range[1])
        if to_range is not None:
            keep &= (arr[:, 1] >= to_range[0]) & (arr[:, 1] < to_range[1])
        out = []
        for i in np.nonzero(keep)[0]:
            row = arr[i]
            seq = blob[offs[i] : offs[i + 1]] if lens[i] else None
            out.append(
                SvCall(
                    from_pos=int(row[0]), to_pos=int(row[1]),
                    from_size=int(row[2]), to_size=int(row[3]),
                    from_forward=bool(row[4]), to_forward=bool(row[5]),
                    supp_reads=int(row[6]), supp_nt=int(row[7]),
                    reference_ambiguity=int(row[8]),
                    inserted_sequence=seq, id=int(i),
                    order_id=int(row[9]), ctg_order_id=int(row[10]),
                )
            )
        return out
