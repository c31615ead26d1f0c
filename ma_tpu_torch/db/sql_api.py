"""Typed-table SQL abstraction over sqlite3 — the db_connect role.

A copy of ma_tpu/db/sql_api.py, changed only in its imports.

The reference's "distributed backend" is a SQL database reached through a
typed-table API (reference: libs/db_connect/sql_api.h — SQLDB<DBImpl>
facade :2082, SQLTable/SQLTableWithAutoPriKey + BulkInserter :668,811-1032,
WKB rectangle spatial indexes in connectors/wkb_spatial.h) with MySQL and
PostgreSQL backends. The TPU build keeps the same API shape over sqlite3
(always available, serverless): typed tables declared from a column spec,
auto-primary-key variant, 500-row buffered bulk inserts, and rectangle
range queries served by an R*Tree index — so MSV stages stay individually
restartable against a single .db file instead of a DB server.
"""
from __future__ import annotations

import sqlite3
import threading
from typing import Any, Iterable, List, Optional, Sequence, Tuple

# column type -> sqlite type affinity (sql_api.h's typed columns)
_TYPES = {
    int: "INTEGER",
    float: "REAL",
    str: "TEXT",
    bytes: "BLOB",
    bool: "INTEGER",
}


class SQLDB:
    """Connection facade (SQLDB<DBImpl>, sql_api.h:2082): schema management,
    transactions, optional drop-on-closure (test fixtures)."""

    def __init__(self, path: str = ":memory:", drop_on_closure: bool = False):
        self.path = path
        self.drop_on_closure = drop_on_closure
        self.con = sqlite3.connect(path, check_same_thread=False)
        self.con.execute("PRAGMA journal_mode=WAL")
        self.con.execute("PRAGMA synchronous=NORMAL")
        self._lock = threading.RLock()
        self._tables: List["SQLTable"] = []

    # ------------------------------------------------------------- execution
    def execute(self, sql: str, args: Sequence[Any] = ()):
        with self._lock:
            return self.con.execute(sql, args)

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]):
        with self._lock:
            return self.con.executemany(sql, rows)

    def query(self, sql: str, args: Sequence[Any] = ()) -> List[tuple]:
        return list(self.execute(sql, args).fetchall())

    def scalar(self, sql: str, args: Sequence[Any] = ()):
        row = self.execute(sql, args).fetchone()
        return None if row is None else row[0]

    def commit(self) -> None:
        with self._lock:
            self.con.commit()

    # ---------------------------------------------------------- transactions
    class _Txn:
        def __init__(self, db: "SQLDB"):
            self.db = db

        def __enter__(self):
            return self.db

        def __exit__(self, et, ev, tb):
            if et is None:
                self.db.commit()
            else:
                self.db.con.rollback()
            return False

    def transaction(self) -> "SQLDB._Txn":
        return SQLDB._Txn(self)

    # ---------------------------------------------------------------- schema
    def has_table(self, name: str) -> bool:
        return (
            self.scalar(
                "SELECT COUNT(*) FROM sqlite_master WHERE type='table' AND name=?",
                (name,),
            )
            > 0
        )

    def register(self, table: "SQLTable") -> None:
        self._tables.append(table)

    def close(self) -> None:
        if self.drop_on_closure:
            for t in self._tables:
                t.drop()
            self.commit()
        self.con.close()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False


class SQLTable:
    """Typed table (sql_api.h:668): columns = [(name, python type)], with
    insert / bulk-insert / select helpers and optional R*Tree rectangle
    index (wkb_spatial.h's role)."""

    AUTO_PK = False

    def __init__(
        self,
        db: SQLDB,
        name: str,
        columns: Sequence[Tuple[str, type]],
        indices: Sequence[str] = (),
    ):
        self.db = db
        self.name = name
        self.columns = list(columns)
        cols = ", ".join(f"{n} {_TYPES[t]}" for n, t in self.columns)
        if self.AUTO_PK:
            cols = "id INTEGER PRIMARY KEY AUTOINCREMENT, " + cols
        db.execute(f"CREATE TABLE IF NOT EXISTS {name} ({cols})")
        for spec in indices:
            idx = f"idx_{name}_{spec.replace(', ', '_').replace(',', '_')}"
            db.execute(f"CREATE INDEX IF NOT EXISTS {idx} ON {name} ({spec})")
        self._rtree: Optional[str] = None
        db.register(self)

    # ----------------------------------------------------------------- write
    def _colnames(self) -> List[str]:
        return [n for n, _ in self.columns]

    def insert(self, *row) -> int:
        ph = ", ".join("?" * len(row))
        cur = self.db.execute(
            f"INSERT INTO {self.name} ({', '.join(self._colnames())}) VALUES ({ph})",
            row,
        )
        return cur.lastrowid

    def bulk_inserter(self, buffer_rows: int = 500) -> "BulkInserter":
        return BulkInserter(self, buffer_rows)

    # ------------------------------------------------------------------ read
    def count(self, where: str = "1", args: Sequence[Any] = ()) -> int:
        return self.db.scalar(
            f"SELECT COUNT(*) FROM {self.name} WHERE {where}", args
        )

    def select(
        self,
        what: str = "*",
        where: str = "1",
        args: Sequence[Any] = (),
        order: str = "",
    ) -> List[tuple]:
        sql = f"SELECT {what} FROM {self.name} WHERE {where}"
        if order:
            sql += f" ORDER BY {order}"
        return self.db.query(sql, args)

    def drop(self) -> None:
        self.db.execute(f"DROP TABLE IF EXISTS {self.name}")
        if self._rtree:
            self.db.execute(f"DROP TABLE IF EXISTS {self._rtree}")

    # --------------------------------------------------------------- spatial
    def gen_rectangle_index(self, x: str, w: str, y: str, h: str) -> None:
        """Create + fill an R*Tree over rectangles (x..x+w, y..y+h) keyed by
        rowid — the WKB spatial index equivalent. Call after bulk loads
        (matches the reference's create_indices post-pass)."""
        rt = f"{self.name}_rtree"
        self.db.execute(
            f"CREATE VIRTUAL TABLE IF NOT EXISTS {rt} USING "
            "rtree(id, min_x, max_x, min_y, max_y)"
        )
        self.db.execute(f"DELETE FROM {rt}")
        self.db.execute(
            f"INSERT INTO {rt} SELECT rowid, {x}, {x}+{w}, {y}, {y}+{h} "
            f"FROM {self.name}"
        )
        self.db.commit()
        self._rtree = rt

    def select_rectangle(
        self,
        min_x: int,
        max_x: int,
        min_y: int,
        max_y: int,
        what: str = "*",
        order: str = "",
    ) -> List[tuple]:
        """All rows whose rectangle overlaps [min_x,max_x) x [min_y,max_y)."""
        if self._rtree is None and self.db.has_table(f"{self.name}_rtree"):
            self._rtree = f"{self.name}_rtree"
        if self._rtree is None:
            raise RuntimeError(f"no spatial index on {self.name}")
        sql = (
            f"SELECT {what} FROM {self.name} WHERE rowid IN "
            f"(SELECT id FROM {self._rtree} "
            "WHERE max_x >= ? AND min_x < ? AND max_y >= ? AND min_y < ?)"
        )
        if order:
            sql += f" ORDER BY {order}"
        # numpy integers bind as blobs against rtree columns and silently
        # match nothing — coerce to Python ints
        return self.db.query(
            sql, (int(min_x), int(max_x), int(min_y), int(max_y))
        )


class SQLTableWithAutoPriKey(SQLTable):
    """Auto-primary-key variant (sql_api.h:811): insert returns the new id."""

    AUTO_PK = True


class BulkInserter:
    """Buffered bulk INSERT (sql_api.h's BulkInserter, 500-row buffer).

    Use as a context manager; rows are flushed with executemany. For
    auto-PK tables, explicit ids may be obtained via insert() instead."""

    def __init__(self, table: SQLTable, buffer_rows: int = 500):
        self.table = table
        self.buffer_rows = buffer_rows
        self._buf: List[tuple] = []
        self.inserted = 0

    def insert(self, *row) -> None:
        self._buf.append(row)
        if len(self._buf) >= self.buffer_rows:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        cols = self.table._colnames()
        ph = ", ".join("?" * len(cols))
        self.table.db.executemany(
            f"INSERT INTO {self.table.name} ({', '.join(cols)}) VALUES ({ph})",
            self._buf,
        )
        self.inserted += len(self._buf)
        self._buf.clear()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.flush()
            self.table.db.commit()
        return False
