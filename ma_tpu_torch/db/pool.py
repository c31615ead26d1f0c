"""Connection pool — the SQLDBConPool role.

A copy of ma_tpu/db/pool.py, changed only in its imports.

The reference runs N worker threads, each owning a dedicated DB connection,
with per-connection task queues and futures (reference:
libs/db_connect/connectors/db_con_pool.h:26-120, PooledSQLDBCon::doPoolSafe
global lock :68-95). Here each pool worker owns its own sqlite3 connection
to the same database file; tasks are submitted as callables receiving the
worker's SQLDB and return futures.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional

from ma_tpu_torch.db.sql_api import SQLDB


class PooledSQLDBCon:
    """One worker's connection handle (PooledSQLDBCon, db_con_pool.h:68)."""

    def __init__(self, pool: "SQLDBConPool", db: SQLDB, task_id: int):
        self.pool = pool
        self.db = db
        self.task_id = task_id

    def do_pool_safe(self, fn: Callable[[SQLDB], object]):
        """Run fn under the pool-global lock (doPoolSafe)."""
        with self.pool.global_lock:
            return fn(self.db)


class SQLDBConPool:
    """N worker threads, one connection each (db_con_pool.h:26)."""

    def __init__(self, n_workers: int, path: str):
        self.path = path
        self.global_lock = threading.Lock()
        self._queues = [queue.Queue() for _ in range(n_workers)]
        self._rr = 0
        self._workers = []
        self._closed = False
        for i in range(n_workers):
            th = threading.Thread(target=self._run, args=(i,), daemon=True)
            th.start()
            self._workers.append(th)

    def _run(self, i: int) -> None:
        db = SQLDB(self.path)
        con = PooledSQLDBCon(self, db, i)
        while True:
            item = self._queues[i].get()
            if item is None:
                break
            fn, fut = item
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(con))
                except BaseException as e:  # noqa: BLE001 — future carries it
                    fut.set_exception(e)
        db.close()

    def enqueue(self, fn: Callable[[PooledSQLDBCon], object],
                worker: Optional[int] = None) -> Future:
        """Submit fn(con) to a worker (round-robin unless pinned)."""
        if self._closed:
            raise RuntimeError("pool closed")
        fut: Future = Future()
        if worker is None:
            worker = self._rr % len(self._queues)
            self._rr += 1
        self._queues[worker].put((fn, fut))
        return fut

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for th in self._workers:
            th.join()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False
