"""Transaction manager (reference: transaction/InMemoryTransactionManager
.java — per-connector isolation contexts created at BEGIN, committed or
aborted atomically per connector).  Port of trino_tpu/runtime/transactions.py.

Write-capable connectors are host-side replace-on-write stores, so isolation
is snapshot/restore — taken LAZILY per written table at first write inside
the transaction (the reference's ConnectorTransactionHandle created on first
use).  ROLLBACK restores only tables this transaction wrote, so concurrent
autocommit writes to OTHER tables survive an unrelated rollback.  Write-write
conflicts on the SAME table between a transaction and concurrent autocommit
statements are not detected (last writer wins) — the reference's
READ_UNCOMMITTED-adjacent behavior for in-memory catalogs, documented here.
"""

from __future__ import annotations

from typing import Optional


class TransactionError(RuntimeError):
    pass


_MISSING = object()  # table did not exist at first write


class TransactionManager:
    def __init__(self, catalogs):
        self.catalogs = catalogs
        self._active = False
        #: (catalog, schema, table) -> pre-write snapshot (or _MISSING)
        self._table_snaps: Optional[dict] = None
        #: catalog -> whole-store snapshot (fallback for connectors without
        #: table-granular snapshot support)
        self._catalog_snaps: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._active

    def begin(self) -> None:
        if self._active:
            raise TransactionError("transaction already in progress")
        self._active = True
        self._table_snaps = {}
        self._catalog_snaps = {}

    def notify_write(self, catalog: str, schema: str, table: str) -> None:
        """Called by the engine BEFORE any DDL/DML mutation.  First write to
        a table inside the transaction snapshots just that table."""
        if not self._active:
            return
        conn = self.catalogs.get(catalog)
        if not conn.supports_writes():
            return
        key = (catalog, schema, table)
        if key in self._table_snaps or catalog in self._catalog_snaps:
            return
        snap_table = getattr(conn, "snapshot_table", None)
        if snap_table is not None:
            self._table_snaps[key] = snap_table(schema, table)
        elif getattr(conn, "snapshot", None) is not None:
            self._catalog_snaps[catalog] = conn.snapshot()

    def commit(self) -> None:
        if not self._active:
            raise TransactionError("no transaction in progress")
        self._active = False
        self._table_snaps = None
        self._catalog_snaps = None

    def rollback(self) -> None:
        if not self._active:
            raise TransactionError("no transaction in progress")
        for (catalog, schema, table), snap in self._table_snaps.items():
            conn = self.catalogs.get(catalog)
            conn.restore_table(schema, table, snap)
        for catalog, snap in self._catalog_snaps.items():
            self.catalogs.get(catalog).restore(snap)
        self._active = False
        self._table_snaps = None
        self._catalog_snaps = None


MISSING = _MISSING
