"""Connector tables materialized as numpy columns: the correctness oracle.

Reference role: testing/trino-testing/.../H2QueryRunner.java + QueryAssertions:
expected results come from an independent implementation over identical data.
Each table becomes `{column name: np.ndarray}` under the rules of the JAX
package's pandas oracle, without pandas: dictionary strings decoded to
object arrays; a decimal as float64 `values / scale_factor` plus an exact
int64 `<name>__cents` column; DATE as `datetime64[D]`; NULL as None where
the column's `valid` is false.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.api import Connector, TableHandle


def connector_table_to_columns(
    connector: Connector, schema: str, table: str, columns=None
) -> dict:
    meta = connector.metadata().table_metadata(schema, table)
    names = columns or [c.name for c in meta.columns]
    handle = TableHandle(connector.name, schema, table)
    pages = []
    for split in connector.splits(handle, target_splits=1 << 30):
        src = connector.page_source(split, names)
        for page in src.pages():
            cols = {}
            for cm_name, cd in zip(names, page):
                t = meta.column(cm_name).type
                if cd.dictionary is not None:
                    vals = np.asarray(cd.dictionary.decode(cd.values), dtype=object)
                elif isinstance(t, T.DecimalType):
                    vals = cd.values.astype(np.float64) / t.scale_factor
                    cols[cm_name + "__cents"] = cd.values.astype(np.int64)
                elif t is T.DATE:
                    vals = np.array("1970-01-01", dtype="datetime64[D]") + cd.values
                else:
                    vals = np.asarray(cd.values)
                if cd.valid is not None:
                    vals = np.where(cd.valid, vals, None)
                cols[cm_name] = vals
            pages.append(cols)
    if not pages:
        return {n: np.empty(0, dtype=object) for n in names}
    return {
        name: np.concatenate([p[name] for p in pages]) for name in pages[0]
    }


@lru_cache(maxsize=16)
def tpch_columns(schema: str, table: str, columns: tuple = None) -> dict:
    """Cached columns of a tpch table (tests: tiny/sf1): every column, or
    the tuple `columns` (a query's own, so sf1 lineitem is not decoded
    whole)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    return connector_table_to_columns(
        TpchConnector(), schema, table, list(columns) if columns else None
    )
