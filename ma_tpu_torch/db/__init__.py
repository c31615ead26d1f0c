"""SQL abstraction layer (the libs/db_connect role) over sqlite3 (a copy of
ma_tpu/db/__init__.py, changed only in its imports)."""
from ma_tpu_torch.db.sql_api import (  # noqa: F401
    BulkInserter,
    SQLDB,
    SQLTable,
    SQLTableWithAutoPriKey,
)
from ma_tpu_torch.db.pool import PooledSQLDBCon, SQLDBConPool  # noqa: F401
