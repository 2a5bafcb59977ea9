"""HTTP protocol client (reference: client/trino-client —
StatementClientV1.java:65; advance() follows nextUri at :334-340).

Port of trino_tpu/client.py: a copy, and `user`/`password` options: with a
password every request carries Basic credentials (the coordinator's
authenticator asks for them on every route), with a user an X-Trino-User
header.  The JAX client sends neither."""

from __future__ import annotations

import json
import time
import urllib.request
import base64
from typing import Optional

from trino_tpu_torch.server import protocol


class QueryFailed(RuntimeError):
    def __init__(self, error: dict):
        super().__init__(error.get("message", "query failed"))
        self.error = error


class QueryShed(QueryFailed):
    """The coordinator shed the statement before reading it (HTTP 429:
    resource-group queue full under overload) — RETRYABLE after
    `retry_after_s` (the server's Retry-After header).  Reference:
    StatementClientV1's handling of 429/503 with Retry-After."""

    retryable = True

    def __init__(self, error: dict, retry_after_s: float):
        super().__init__(error)
        self.retry_after_s = retry_after_s


class Client:
    def __init__(self, base_url: str = "http://127.0.0.1:8080",
                 user: Optional[str] = None, password: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.headers = {}
        if user is not None:
            self.headers["X-Trino-User"] = user
        if password is not None:
            token = base64.b64encode(f"{user or ''}:{password}".encode()).decode()
            self.headers["Authorization"] = "Basic " + token

    def _request(self, method: str, path: str, body: Optional[bytes] = None) -> dict:
        from urllib.error import HTTPError

        req = urllib.request.Request(
            self.base_url + path, data=body, method=method, headers=self.headers
        )
        try:
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read().decode())
        except HTTPError as e:
            if e.code == 429:
                try:
                    err = json.loads(e.read().decode()).get("error") or {}
                except (ValueError, OSError):
                    err = {"message": "shed: resource group queue is full"}
                try:
                    retry_after = float(e.headers.get("Retry-After", 1))
                except (TypeError, ValueError):
                    retry_after = 1.0
                raise QueryShed(err, retry_after) from None
            raise

    def execute(self, sql: str, shed_retries: int = 0):
        """Submit and drain a statement; returns (column_names, rows).
        `shed_retries` > 0 re-submits a shed statement after the server's
        Retry-After, up to that many times — the client half of the
        load-shedding contract.  Covers BOTH shed surfaces: the pre-body
        HTTP 429, and the race window where the queue filled between the
        coordinator's probe and the statement thread's enqueue (the query
        then fails through the poll loop with a retryable
        QUERY_QUEUE_FULL error object)."""
        while True:
            try:
                return self._execute_once(sql)
            except QueryShed as e:
                if shed_retries <= 0:
                    raise
                shed_retries -= 1
                time.sleep(e.retry_after_s)

    def _execute_once(self, sql: str):
        out = self._request("POST", "/v1/statement", sql.encode())
        columns: list = []
        rows: list = []
        while True:
            err = out.get("error")
            if err:
                if err.get("errorName") == "QUERY_QUEUE_FULL" or err.get(
                    "retryable"
                ):
                    raise QueryShed(
                        err, float(err.get("retryAfterSeconds") or 1.0)
                    )
                raise QueryFailed(err)
            if "columns" in out:
                columns = out["columns"]
            if "data" in out:
                rows.extend(protocol.decode_rows(out["data"], columns))
            nxt = out.get("nextUri")
            if nxt is None:
                break
            out = self._request("GET", nxt)
        return [c["name"] for c in columns], rows
