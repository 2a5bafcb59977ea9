"""Result comparison for parity checks: one query's rows from two runs
(another engine, another device) held equal under the query's own ORDER BY.

An ORDER BY fixes the order of rows only up to ties, and a LIMIT that cuts
through a tie keeps an arbitrary subset of the tied rows.  So the check is:
  * the same number of rows;
  * the ORDER BY key columns that the output shows, in order, row for row;
  * the whole rows as a multiset, except those of the last key group when
    the LIMIT cut the result (their keys are already held by the line
    above).
Integers, decimals, dates and strings must be equal and of the same type;
doubles equal to a relative tolerance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from trino_tpu_torch.expr.ir import SymbolRef
from trino_tpu_torch.planner import plan as P


@dataclass(frozen=True)
class ResultOrder:
    #: output columns that are ORDER BY keys, most significant first
    key_columns: tuple
    #: the LIMIT's row count, or None
    limit: Optional[int]


def result_order(plan: P.OutputNode) -> ResultOrder:
    """The ORDER BY keys (as output columns) and LIMIT of a planned query,
    read down the single-input chain under its OutputNode."""
    names = {s.name: i for i, s in enumerate(plan.symbols)}
    limit = None
    node = plan.source
    while True:
        if isinstance(node, (P.TopNNode, P.SortNode)):
            if isinstance(node, P.TopNNode):
                limit = node.count if limit is None else min(limit, node.count)
            keys = tuple(names[s.name] for s, _, _ in node.orderings if s.name in names)
            return ResultOrder(keys, limit)
        if isinstance(node, P.LimitNode) and node.count is not None:
            limit = node.count if limit is None else min(limit, node.count)
        if isinstance(node, P.ProjectNode):
            inner = {}
            for sym, e in node.assignments:
                if sym.name in names and isinstance(e, SymbolRef):
                    inner[e.name] = names[sym.name]
            names = inner
        elif not isinstance(node, (P.LimitNode, P.FilterNode, P.ExchangeNode)):
            return ResultOrder((), limit)
        node = node.source


def _same_value(va, ve, float_rtol: float) -> bool:
    if isinstance(ve, float):
        if not isinstance(va, float):
            return False
        if math.isnan(ve):
            return math.isnan(va)
        return math.isclose(va, ve, rel_tol=float_rtol, abs_tol=0.0)
    return type(va) is type(ve) and va == ve


def _same_row(ra, re, float_rtol: float) -> bool:
    return len(ra) == len(re) and all(
        _same_value(va, ve, float_rtol) for va, ve in zip(ra, re)
    )


def _sort_key(row):
    # doubles to 9 significant digits, so a last-bit difference does not
    # reorder a multiset; NULLs first
    return tuple(
        (0, "") if v is None
        else (1, f"{v:.9g}") if isinstance(v, float)
        else (1, str(v))
        for v in row
    )


def assert_rows_match(
    actual: list, expected: list, order: ResultOrder, float_rtol: float = 1e-9
) -> None:
    """Raise AssertionError unless `actual` equals `expected` under
    `order` (see the module docstring)."""
    if len(actual) != len(expected):
        raise AssertionError(f"row count {len(actual)} != {len(expected)}")
    if not expected:
        return
    kc = order.key_columns
    for i, (ra, re) in enumerate(zip(actual, expected)):
        ka, ke = [ra[c] for c in kc], [re[c] for c in kc]
        if not _same_row(ka, ke, float_rtol):
            raise AssertionError(f"row {i}: ORDER BY keys {ka!r} != {ke!r}\n{ra}\n{re}")
    cut = order.limit is not None and len(expected) >= order.limit
    if cut and kc:
        last = [expected[-1][c] for c in kc]

        def whole(rows):
            return [r for r in rows if not _same_row([r[c] for c in kc], last, float_rtol)]

        actual, expected = whole(actual), whole(expected)
        if len(actual) != len(expected):
            raise AssertionError("rows outside the LIMIT's last tie group differ")
    elif cut:
        return  # a LIMIT without ORDER BY keeps any rows: the count is all
    for ra, re in zip(sorted(actual, key=_sort_key), sorted(expected, key=_sort_key)):
        if not _same_row(ra, re, float_rtol):
            raise AssertionError(f"rows differ:\n{ra}\n{re}")
