"""PEP 249 (DB-API 2.0) driver over the statement protocol.

Reference role: client/trino-jdbc (TrinoDriver/TrinoResultSet, 20.4k LoC of
JDBC 4 over the HTTP protocol) — the Python-native equivalent of "standard
database connectivity on top of the client protocol" is DB-API, so this
module plays the JDBC driver's part: connect() -> Connection -> Cursor with
execute/fetchone/fetchmany/fetchall/description, driven through the same
/v1/statement + nextUri protocol as the CLI (client.py).

An in-process mode (connect(runner=...)) binds a cursor directly to a
LocalQueryRunner — the counterpart of the JDBC driver's embedded/testing
path (LocalQueryRunner-backed connections in trino-testing).

Port of trino_tpu/dbapi.py: a copy, whose placeholder splitting and
substitution come from trino_tpu_torch/sql/placeholders.py (the runner's
EXECUTE uses the same), with the base and interface errors.
`connect(runner=...)` runs in-process; `connect(url)` goes over HTTP, with
`user` and `password` passed to the client (Basic credentials).
"""

from __future__ import annotations

from typing import Optional, Sequence

from trino_tpu_torch.sql.placeholders import Error, InterfaceError
from trino_tpu_torch.sql.placeholders import substitute as _substitute

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class DatabaseError(Error):
    pass


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: Optional[list] = None
        self._pos = 0
        self.description = None
        self.rowcount = -1

    # -- PEP 249 --------------------------------------------------------------

    def execute(self, operation: str, parameters: Sequence = ()) -> "Cursor":
        if self._conn._closed:
            raise InterfaceError("cursor on a closed connection")
        sql = _substitute(operation, parameters)
        try:
            names, rows, types = self._conn._run(sql)
        except Error:
            raise
        except Exception as e:
            raise DatabaseError(str(e)) from e
        self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        self.description = [
            (n, t, None, None, None, None, None)
            for n, t in zip(names, types)
        ]
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    def fetchone(self):
        if self._rows is None:
            raise InterfaceError("no query executed")
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None):
        n = size or self.arraysize
        out = self._rows[self._pos : self._pos + n] if self._rows else []
        self._pos += len(out)
        return out

    def fetchall(self):
        if self._rows is None:
            raise InterfaceError("no query executed")
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def close(self) -> None:
        self._rows = None

    def setinputsizes(self, sizes) -> None:  # optional per PEP 249
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def __iter__(self):
        while True:
            r = self.fetchone()
            if r is None:
                return
            yield r


class Connection:
    def __init__(self, url: Optional[str] = None, runner=None,
                 user: Optional[str] = None, password: Optional[str] = None):
        if runner is None and url is None:
            raise InterfaceError("connect() needs a url or a runner")
        self._runner = runner
        self._client = None
        if runner is None:
            from trino_tpu_torch.client import Client

            self._client = Client(url, user=user, password=password)
        self._closed = False

    def _run(self, sql: str):
        if self._runner is not None:
            res = self._runner.execute(sql)
            return (
                list(res.column_names),
                list(res.rows),
                [getattr(t, "name", str(t)) for t in res.types],
            )
        names, rows = self._client.execute(sql)
        return list(names), [tuple(r) for r in rows], [None] * len(names)

    def cursor(self) -> Cursor:
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self) -> None:
        if self._runner is not None and getattr(
            self._runner, "in_transaction", False
        ):
            self._runner.execute("commit")

    def rollback(self) -> None:
        if self._runner is not None and getattr(
            self._runner, "in_transaction", False
        ):
            self._runner.execute("rollback")

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(url: Optional[str] = None, runner=None, user: Optional[str] = None,
            password: Optional[str] = None) -> Connection:
    """connect("http://host:port") for the protocol path (with `user` and
    `password` for a coordinator that authenticates), or
    connect(runner=LocalQueryRunner(...)) for the embedded path."""
    return Connection(url, runner, user, password)
