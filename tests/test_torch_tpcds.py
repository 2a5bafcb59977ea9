"""The port's TPC-DS connector against the JAX package's at tpcds.tiny, and
the helpers of the TPC-DS query parity tests.

Connector parity: every column of every table, read through both
connectors' splits and page sources, is bit-identical (values, null masks,
dictionary entries); so are the row counts, the table statistics the
optimizer reads, the split layout and the global dictionaries.

The query tests (tests/test_torch_tpcds_{union,rollup,setops,subquery,
star,window}.py in tier-1, tests/test_torch_tpcds_slow.py marked `slow`) hold
each query's rows through the port's LocalQueryRunner and through its
4-worker mesh with `pallas_probe` on (the sorted-probe kernel's plain
version must then run wherever a mesh join takes it) against ONE JAX
LocalQueryRunner result per query.  Rows compare under the query's ORDER
BY (trino_tpu_torch.testing): keys in order, whole rows as a multiset
where the ORDER BY leaves ties, keys only for the tie group a LIMIT cuts
through; integers, decimals, dates and strings exact, doubles relative
1e-9.
"""

import numpy as np
import pytest

from trino_tpu.connectors.tpcds import TpcdsConnector as JaxTpcds
from trino_tpu.connectors.tpcds.queries import QUERIES
from trino_tpu.connectors.api import TableHandle as JaxHandle
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.connectors.api import TableHandle
from trino_tpu_torch.connectors.tpcds import TpcdsConnector
from trino_tpu_torch.connectors.tpcds.queries import QUERIES as PORT_QUERIES
from trino_tpu_torch.connectors.tpcds.schema import TABLES
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

#: the TPC-DS queries with a window function (the eighth slice's)
WINDOW_QIDS = frozenset({12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98})
#: all 99 queries
ALL_QIDS = tuple(sorted(QUERIES))
#: queries that raise in both packages: q51 takes a running max over a
#: decimal(38,2) sum, and the window's min/max over a long decimal is not
#: implemented in the JAX package (tests/KNOWN_FAILURES.md), so the port
#: raises the same NotImplementedError
RAISING_QIDS = frozenset({51})
#: queries whose mesh plan has no join the sorted probe takes: q9 and q28
#: are scalar subqueries under cross joins, q5's and q43's joins all run
#: in coordinator fragments (over a union, over small filtered dimensions)
NO_PROBE_QIDS = frozenset({5, 9, 28, 43})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs at tiny take one torch thread per test process:
    several xdist workers, each with a thread per core, oversubscribe the
    host many times over.  The setting is restored after the module."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class QueryParity:
    """One module's runners: the JAX local reference (each query's rows
    computed once) and the port's local and 4-worker mesh runners."""

    def __init__(self, schema: str = "tiny"):
        self.schema = schema
        self.jax = JaxRunner(catalog="tpcds", schema=schema)
        self.local = LocalQueryRunner(catalog="tpcds", schema=schema, device="cpu")
        self.mesh = DistributedQueryRunner(
            catalog="tpcds", schema=schema, n_workers=4, device="cpu"
        )
        self.mesh.execute("set session pallas_probe = true")
        self._expected = {}

    def expected(self, qid: int):
        if qid not in self._expected:
            self._expected[qid] = self.jax.execute(QUERIES[qid])
        return self._expected[qid]

    def check(self, qid: int, where: str, nonempty: bool = True) -> int:
        """Run `qid` through the port's `where` runner ("local" or "mesh")
        and hold it to the JAX rows; returns the row count."""
        from trino_tpu_torch.ops import locate_sorted as ls

        sql = PORT_QUERIES[qid]
        assert sql == QUERIES[qid]
        expected = self.expected(qid)
        if nonempty:
            assert len(expected.rows) > 0, f"q{qid} is empty at {self.schema}"
        runner = self.local if where == "local" else self.mesh
        before = ls.locate_sorted_reference.launches
        actual = runner.execute(sql)
        launched = ls.locate_sorted_reference.launches - before
        assert actual.column_names == expected.column_names
        assert [t.name for t in actual.types] == [t.name for t in expected.types]
        order = result_order(self.local.create_plan(sql))
        assert_rows_match(actual.rows, expected.rows, order, float_rtol=1e-9)
        if where == "mesh" and qid not in NO_PROBE_QIDS:
            assert launched > 0, f"q{qid}: no sorted-probe launch on the mesh"
        elif where == "local":
            assert launched == 0
        return len(expected.rows)


# -- connector parity -----------------------------------------------------------


@pytest.fixture(scope="module")
def connectors():
    return JaxTpcds(), TpcdsConnector()


def _read(conn, handle_cls, table, columns):
    """Every page of every split of a table: per column, the concatenated
    values and null mask, and the dictionary of each page."""
    handle = handle_cls("tpcds", "tiny", table)
    values = {c: [] for c in columns}
    valid = {c: [] for c in columns}
    dicts = {c: [] for c in columns}
    splits = conn.splits(handle, target_splits=4)
    for split in splits:
        for page in conn.page_source(split, columns, 1 << 14).pages():
            for c, cd in zip(columns, page):
                values[c].append(np.asarray(cd.values))
                valid[c].append(
                    None if cd.valid is None else np.asarray(cd.valid, dtype=bool)
                )
                dicts[c].append(None if cd.dictionary is None else tuple(cd.dictionary.values))
    splits = [(s.row_start, s.row_count) for s in splits]
    return splits, values, valid, dicts


@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_bit_identical(connectors, table):
    jax_conn, port_conn = connectors
    columns = [name for name, _ in TABLES[table]]
    j_splits, j_values, j_valid, j_dicts = _read(jax_conn, JaxHandle, table, columns)
    p_splits, p_values, p_valid, p_dicts = _read(port_conn, TableHandle, table, columns)
    assert p_splits == j_splits
    for c in columns:
        for jv, pv in zip(j_values[c], p_values[c]):
            assert pv.dtype == jv.dtype and pv.shape == jv.shape, c
            assert np.array_equal(pv, jv), c
        for jn, pn in zip(j_valid[c], p_valid[c]):
            assert (jn is None) == (pn is None), c
            if jn is not None:
                assert np.array_equal(pn, jn), c
        assert p_dicts[c] == j_dicts[c], c


@pytest.mark.parametrize("table", sorted(TABLES))
def test_statistics_and_dictionaries_identical(connectors, table):
    jax_conn, port_conn = connectors
    for schema in ("tiny", "sf1"):
        js = jax_conn.metadata().table_statistics(schema, table)
        ps = port_conn.metadata().table_statistics(schema, table)
        assert ps.row_count == js.row_count
        assert ps.columns.keys() == js.columns.keys()
        for name, jc in js.columns.items():
            assert vars(ps.columns[name]) == vars(jc), name
    jmeta = jax_conn.metadata().table_metadata("tiny", table)
    pmeta = port_conn.metadata().table_metadata("tiny", table)
    assert [(c.name, c.type.name) for c in pmeta.columns] == [
        (c.name, c.type.name) for c in jmeta.columns
    ]
    for c in jmeta.columns:
        jd = jax_conn.global_dictionary(JaxHandle("tpcds", "tiny", table), c.name)
        pd = port_conn.global_dictionary(TableHandle("tpcds", "tiny", table), c.name)
        assert (jd is None) == (pd is None), c.name
        if jd is not None:
            assert tuple(pd[0].values) == tuple(jd[0].values) and pd[1] == jd[1]


def test_schemas_tables_and_row_counts(connectors):
    jax_conn, port_conn = connectors
    assert port_conn.metadata().list_schemas() == jax_conn.metadata().list_schemas()
    assert port_conn.metadata().list_tables("tiny") == sorted(TABLES)
    r = LocalQueryRunner(catalog="tpcds", schema="tiny", device="cpu")
    counts = r.execute(
        "select (select count(*) from store_sales), (select count(*) from "
        "customer_demographics), (select count(*) from time_dim), "
        "(select min(t_time_sk) from time_dim), (select min(d_date_sk) from date_dim)"
    ).rows
    from trino_tpu.connectors.tpcds.generator import generator as jax_generator

    gen = jax_generator(0.01)
    assert counts == [(
        gen.row_count("store_sales"), 1_920_800, 86_400, 0, 2_415_022,
    )]


def test_default_catalogs_register_tpcds():
    from trino_tpu_torch.connectors.api import default_catalogs

    cm = default_catalogs()
    # the JAX package's set (each runner adds `system` when it is built)
    assert cm.names() == ["blackhole", "memory", "tpcds", "tpch"]
    assert isinstance(cm.get("tpcds"), TpcdsConnector)

