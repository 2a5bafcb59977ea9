"""Query verifier: run a suite against a control and a test engine, compare.

Reference role: service/trino-verifier (VerifyCommand / Validator.java —
pairs of JDBC endpoints, row-set comparison with floating-point tolerance,
per-query verdicts).  Engines here are anything with `.execute(sql)` → a
result with `.rows` (LocalQueryRunner, DistributedQueryRunner, dbapi-wrapped
HTTP endpoints), so control can be the local engine and test a remote one.

Port of trino_tpu/testing/verifier.py: a copy.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class VerifierResult:
    query_id: str
    sql: str
    status: str  # MATCH | MISMATCH | CONTROL_ERROR | TEST_ERROR
    control_wall_s: float = 0.0
    test_wall_s: float = 0.0
    detail: str = ""


@dataclass
class VerifierReport:
    results: list = field(default_factory=list)

    @property
    def matched(self) -> int:
        return sum(1 for r in self.results if r.status == "MATCH")

    @property
    def failed(self) -> list:
        return [r for r in self.results if r.status != "MATCH"]

    def summary(self) -> str:
        lines = [
            f"verified {len(self.results)} queries: {self.matched} match, "
            f"{len(self.failed)} fail"
        ]
        for r in self.failed:
            lines.append(f"  {r.query_id}: {r.status} {r.detail[:200]}")
        return "\n".join(lines)


class Verifier:
    def __init__(
        self,
        control,
        test,
        float_tolerance: float = 1e-9,
        ordered: bool = False,
    ):
        self.control = control
        self.test = test
        self.float_tolerance = float_tolerance
        self.ordered = ordered

    def run(self, queries: dict | Sequence) -> VerifierReport:
        if not isinstance(queries, dict):
            queries = {f"q{i}": q for i, q in enumerate(queries)}
        report = VerifierReport()
        for qid, sql in queries.items():
            report.results.append(self._one(str(qid), sql))
        return report

    def _one(self, qid: str, sql: str) -> VerifierResult:
        t0 = time.perf_counter()
        try:
            control_rows = _rows(self.control.execute(sql))
        except Exception:
            return VerifierResult(
                qid, sql, "CONTROL_ERROR",
                detail=traceback.format_exc(limit=2),
            )
        t1 = time.perf_counter()
        try:
            test_rows = _rows(self.test.execute(sql))
        except Exception:
            return VerifierResult(
                qid, sql, "TEST_ERROR",
                control_wall_s=t1 - t0,
                detail=traceback.format_exc(limit=2),
            )
        t2 = time.perf_counter()
        ok, detail = self._compare(control_rows, test_rows)
        return VerifierResult(
            qid,
            sql,
            "MATCH" if ok else "MISMATCH",
            control_wall_s=t1 - t0,
            test_wall_s=t2 - t1,
            detail=detail,
        )

    # -- comparison (Validator.java's resultsMatch) --------------------------

    def _compare(self, control, test) -> tuple:
        if len(control) != len(test):
            return False, f"row count {len(control)} != {len(test)}"
        c, t = list(control), list(test)
        if not self.ordered:
            c, t = sorted(c, key=_row_key), sorted(t, key=_row_key)
        for i, (rc, rt) in enumerate(zip(c, t)):
            if len(rc) != len(rt):
                return False, f"row {i}: width {len(rc)} != {len(rt)}"
            for j, (vc, vt) in enumerate(zip(rc, rt)):
                if not self._value_eq(vc, vt):
                    return False, f"row {i} col {j}: {vc!r} != {vt!r}"
        return True, ""

    def _value_eq(self, a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, float) or isinstance(b, float):
            try:
                fa, fb = float(a), float(b)
            except (TypeError, ValueError):
                return a == b
            scale = max(abs(fa), abs(fb), 1.0)
            return abs(fa - fb) <= self.float_tolerance * scale
        return a == b


def _rows(result):
    rows = getattr(result, "rows", result)
    return [tuple(r) for r in rows]


def _row_key(row):
    return tuple((v is None, str(type(v)), str(v)) for v in row)
