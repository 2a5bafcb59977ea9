"""The port's bench probes and its numpy oracle against the JAX package's, on
the CPU at tpch.tiny.

  * testing/oracle: the port's columns of the eight TPC-H tables and of a
    TPC-DS table with NULLs (store_returns) against the JAX pandas frame
    over the JAX connector: integers, strings and dates exact, `__cents`
    exact, decimal floats equal, NULLs in the same places.
  * bench_pressure: `check_pressure` of tools/compare_bench.py holds the
    port's section (a local runner and a 4-worker mesh) to its gate, and
    the probe's unconstrained Q18 rows equal the JAX LocalQueryRunner's.
  * bench_serve: `check_serve` and `check_chaos` hold the port's section
    to their gates; each section has the JAX module's keys, as its source
    lists them; the mix's serial rows (local and mesh) equal the JAX
    LocalQueryRunner's.

Both probes read process-wide counters (waves, spill, retries, spool
reads, the compile observatory's watermark, FAILURE_INJECTOR), which
earlier tests in the same xdist worker move.  So each probe runs in a
fresh Python process of its own (both at once), with a private temporary
directory, and sends its section and captured rows back in a pickle.
"""

import ast
import math
import os
import pickle
import subprocess
import sys
from decimal import Decimal
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from trino_tpu.connectors.tpcds import TpcdsConnector as JaxTpcds
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu.testing.oracle import connector_table_to_pandas
from trino_tpu_torch.connectors.tpcds import TpcdsConnector
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.testing import connector_table_to_columns, tpch_columns

from test_torch_e2e import assert_same_rows

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from compare_bench import check_chaos, check_pressure, check_serve  # noqa: E402

TPCH_TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
               "orders", "lineitem")

#: the probe scripts: each runs one probe at tiny on the CPU and pickles
#: {"section": ..., "rows": ...} to argv[1]
SERVE_SCRIPT = """
import os, pickle, sys
import torch
torch.set_num_threads(2)
from trino_tpu_torch import bench_serve as bs

captured = []
original = bs._mix_and_oracle

def recording(runner):
    seen = {}
    execute = runner.execute

    def record(sql, *args, **kwargs):
        res = execute(sql, *args, **kwargs)
        seen[sql] = res.rows
        return res

    runner.execute = record
    try:
        return original(runner)
    finally:
        del runner.execute
        captured.append(seen)

bs._mix_and_oracle = recording
out = bs.run_serve(schema="tiny", clients=3, rounds=2, lanes=2, device="cpu")
with open(sys.argv[1], "wb") as f:
    pickle.dump({"section": out, "rows": captured}, f)
"""

PRESSURE_SCRIPT = """
import pickle, sys
import torch
torch.set_num_threads(2)
from trino_tpu_torch.bench_pressure import run_pressure
from trino_tpu_torch.connectors.tpch.queries import QUERIES
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
first = []
execute = local.execute

def record(sql, *args, **kwargs):
    res = execute(sql, *args, **kwargs)
    if not first:
        first.append(res.rows)
    return res

local.execute = record
out = run_pressure(local, mesh, QUERIES[18])
with open(sys.argv[1], "wb") as f:
    pickle.dump({"section": out, "rows": first[0]}, f)
"""


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """Both probes, each in a fresh process, started together; their
    pickles once both have ended (each spool and spill directory and the
    profile archive under a private temporary directory, left empty of
    spools)."""
    procs = {}
    for name, script in (("serve", SERVE_SCRIPT), ("pressure", PRESSURE_SCRIPT)):
        tmp = tmp_path_factory.mktemp(f"probe_{name}")
        env = {
            **os.environ,
            "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
            "TMPDIR": str(tmp),
            "BENCH_PROFILE_DIR": str(tmp / "profiles"),
            "PYTHONHASHSEED": "0",
        }
        out = tmp / "out.pkl"
        proc = subprocess.Popen(
            [sys.executable, "-c", script, str(out)], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs[name] = (proc, out, tmp)
    results = {}
    for name, (proc, out, tmp) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} probe failed:\n{log[-4000:]}"
        with open(out, "rb") as f:
            results[name] = pickle.load(f)
        leaks = [p.name for p in tmp.rglob("*_spool_*")]
        assert not leaks, f"{name} probe left spools: {leaks}"
    return results


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX LocalQueryRunner's rows of the serve mix and of Q18."""
    runner = JaxRunner(catalog="tpch", schema="tiny")
    return {q: runner.execute(QUERIES[q]).rows for q in (1, 6, 3, 18)}


# -- testing/oracle ---------------------------------------------------------------


def _frame_value(v):
    """A value of the JAX oracle's frame as the port's column holds it:
    pandas turns a page's None into NaN or NaT when pages concatenate, and
    a date into a Timestamp once a page of dates meets one with NULLs."""
    if v is None or v is pd.NaT or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, pd.Timestamp):
        return v.date()
    return v


def assert_same_columns(actual: dict, expected) -> None:
    """The port's columns against the JAX oracle's frame: the same names in
    the same order, each of the same length, values and NULL places."""
    assert list(actual) == list(expected.columns)
    for name in expected.columns:
        a, e = actual[name], expected[name].to_numpy()
        assert len(a) == len(e), name
        if e.dtype.kind == "M":  # pandas widens datetime64[D]
            assert a.dtype == np.dtype("datetime64[D]"), name
            assert np.array_equal(a, e.astype("datetime64[D]")), name
        elif e.dtype == object:
            assert a.dtype == object, name
            e = [_frame_value(v) for v in e]
            assert [v is None for v in a] == [v is None for v in e], name
            assert a.tolist() == e, name
        else:
            assert a.dtype == e.dtype, (name, a.dtype, e.dtype)
            assert np.array_equal(a, e), name


@pytest.mark.parametrize("table", TPCH_TABLES)
def test_oracle_tpch_table_matches_jax(table):
    expected = connector_table_to_pandas(JaxTpch(), "tiny", table)
    actual = connector_table_to_columns(TpchConnector(), "tiny", table)
    assert len(expected) > 0
    assert_same_columns(actual, expected)
    assert tpch_columns("tiny", table).keys() == actual.keys()


def test_oracle_tpcds_nulls_match_jax():
    expected = connector_table_to_pandas(JaxTpcds(), "tiny", "store_returns")
    actual = connector_table_to_columns(TpcdsConnector(), "tiny", "store_returns")
    # a NULL integer key: None among the ints
    assert any(v is None for v in actual["sr_customer_sk"])
    assert actual["sr_return_amt__cents"].dtype == np.int64
    assert_same_columns(actual, expected)


def paged_connector(pkg: str):
    """A connector of package `pkg` ("trino_tpu" or "trino_tpu_torch") with
    one table `t` of two pages: a decimal, a date and a dictionary string
    column, each with NULLs in the second page, and one empty table `e`."""
    import importlib

    api = importlib.import_module(f"{pkg}.connectors.api")
    T = importlib.import_module(f"{pkg}.types")
    dictionary = importlib.import_module(f"{pkg}.columnar.dictionary")
    cols = (api.ColumnMeta("d", T.DecimalType(12, 2)), api.ColumnMeta("day", T.DATE),
            api.ColumnMeta("s", T.VARCHAR), api.ColumnMeta("n", T.BIGINT))
    words = dictionary.StringDictionary(["a", "b", "c"])
    pages = [
        [api.ColumnData(np.array([150, -7, 0])), api.ColumnData(np.array([0, 19000, -3])),
         api.ColumnData(np.array([2, 0, 1]), dictionary=words),
         api.ColumnData(np.array([1, 2, 3]))],
        [api.ColumnData(np.array([99, 12345]), valid=np.array([False, True])),
         api.ColumnData(np.array([5, 6]), valid=np.array([True, False])),
         api.ColumnData(np.array([1, 1]), valid=np.array([False, True]), dictionary=words),
         api.ColumnData(np.array([4, 5]), valid=np.array([True, False]))],
    ]

    class Source(api.PageSource):
        def __init__(self, table, names):
            self.table, self.names = table, names

        def pages(self):
            for page in (pages if self.table == "t" else []):
                yield [page[[c.name for c in cols].index(n)] for n in self.names]

    class Metadata(api.ConnectorMetadata):
        def table_metadata(self, schema, table):
            return api.TableMetadata(schema, table, cols)

    class Paged(api.Connector):
        name = "paged"

        def metadata(self):
            return Metadata()

        def splits(self, handle, target_splits, predicate=None):
            return [api.Split(handle, 0)]

        def page_source(self, split, columns, max_rows_per_page=1 << 20):
            return Source(split.table.table, list(columns))

    return Paged()


def test_oracle_materialization_rules_match_jax():
    jax_conn, port_conn = paged_connector("trino_tpu"), paged_connector("trino_tpu_torch")
    expected = connector_table_to_pandas(jax_conn, "s", "t")
    actual = connector_table_to_columns(port_conn, "s", "t")
    assert_same_columns(actual, expected)
    # a NULL decimal: None among the floats, its cents column unmasked
    assert actual["d"].tolist() == [1.5, -0.07, 0.0, None, 123.45]
    assert actual["d__cents"].tolist() == [150, -7, 0, 99, 12345]
    assert actual["day"][:4].tolist()[3] == np.datetime64("1970-01-06", "D").item()
    assert actual["day"][4] is None and actual["s"][3] is None
    assert actual["s"][:3].tolist() == ["c", "a", "b"]
    # a projection keeps the asked order; an empty table gives empty columns
    part = connector_table_to_columns(port_conn, "s", "t", ["n", "d"])
    assert list(part) == ["n", "d__cents", "d"]
    assert list(connector_table_to_pandas(jax_conn, "s", "t", ["n", "d"]).columns) == list(part)
    empty = connector_table_to_columns(port_conn, "s", "e")
    assert list(empty) == list(connector_table_to_pandas(jax_conn, "s", "e").columns)
    assert all(len(v) == 0 for v in empty.values())


def test_oracle_projection_and_cache():
    cols = tpch_columns("tiny", "lineitem", ("l_quantity", "l_shipdate"))
    assert list(cols) == ["l_quantity__cents", "l_quantity", "l_shipdate"]
    assert tpch_columns("tiny", "lineitem", ("l_quantity", "l_shipdate")) is cols
    full = tpch_columns("tiny", "lineitem")
    assert np.array_equal(full["l_quantity__cents"], cols["l_quantity__cents"])


# -- the section keys the JAX sources list ----------------------------------------


def _jax_source(module: str) -> ast.Module:
    return ast.parse((ROOT / "trino_tpu" / f"{module}.py").read_text())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _constants(node) -> list:
    return [n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str)]


def _assigned_keys(fn: ast.FunctionDef, var: str) -> set:
    """The keys a function stores into `var`: `var["k"] = ...`, the keys of
    a dict literal assigned to `var`, and `for key in ("a", "b"):
    var[key] = ...`."""
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == var
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
                if getattr(t, "id", None) == var and isinstance(node.value, ast.Dict):
                    keys.update(k.value for k in node.value.keys)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            loop_var = node.target.id
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Subscript) and getattr(sub.value, "id", None) == var
                        and getattr(sub.slice, "id", None) == loop_var
                        and isinstance(sub.ctx, ast.Store)):
                    keys.update(_constants(node.iter))
    return keys


def _returned_dict_keys(fn: ast.FunctionDef) -> set:
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def jax_serve_keys() -> dict:
    tree = _jax_source("bench_serve")
    phase = _returned_dict_keys(_function(tree, "_serve_once"))
    run = _function(tree, "run_serve")
    artifacts = next(
        n.value for n in ast.walk(run) if isinstance(n, ast.Assign)
        and isinstance(n.targets[0], ast.Subscript)
        and getattr(n.targets[0].slice, "value", None) == "profile_artifacts"
    )
    return {
        "top": _assigned_keys(run, "out"),
        "local": phase,
        "mesh": phase | _assigned_keys(run, "mesh"),
        "chaos": phase | _assigned_keys(_function(tree, "_run_chaos"), "chaos"),
        "profile_artifacts": {k.value for k in artifacts.keys},
    }


def jax_pressure_keys() -> dict:
    tree = _jax_source("bench_pressure")
    run = _function(tree, "run_pressure")
    return {
        "top": _assigned_keys(run, "out"),
        "side": _returned_dict_keys(_function(run, "constrained")),
        "counters": _returned_dict_keys(_function(tree, "pressure_counters")),
    }


# -- bench_serve --------------------------------------------------------------


def test_serve_gates_pass(probes):
    sec = probes["serve"]["section"]
    assert check_serve(sec) == []
    assert check_chaos(sec.get("chaos")) == []
    assert sec["schema"] == "tiny"
    for phase in ("local", "mesh", "chaos"):
        assert sec[phase]["clients"] == 3 and sec[phase]["rounds"] == 2
        assert sec[phase]["queries_total"] + sec[phase]["shed_total"] == 6
    assert sec["local"]["lanes"] == 2 and sec["mesh"]["lanes"] == 1
    assert sec["chaos"]["query"] == "Q18"
    assert sec["chaos"]["injected_kills"] == 1
    assert sec["profile_artifacts"]["flushed"] is True
    assert sec["profile_artifacts"]["count"] > 0


def test_serve_keys_equal_jax(probes):
    sec = probes["serve"]["section"]
    keys = jax_serve_keys()
    assert keys["local"] >= {"clients", "qps", "p99_s", "rows_match"}
    assert set(sec) == keys["top"]
    for phase in ("local", "mesh", "chaos"):
        assert set(sec[phase]) == keys[phase], phase
    assert set(sec["profile_artifacts"]) == keys["profile_artifacts"]
    assert set(sec["chaos"]["task_retries"]) == {"retry", "replan", "fail"}


@pytest.mark.parametrize("which", [0, 1], ids=["local", "mesh"])
def test_serve_mix_rows_equal_jax(probes, jax_rows, which):
    from trino_tpu_torch.bench_serve import MIX_QUERIES
    from trino_tpu_torch.connectors.tpch.queries import QUERIES as PORT_QUERIES

    seen = probes["serve"]["rows"][which]
    assert MIX_QUERIES == (1, 6, 3)
    assert list(seen) == [PORT_QUERIES[q] for q in MIX_QUERIES]
    for q in MIX_QUERIES:
        assert len(jax_rows[q]) > 0
        assert_same_rows(seen[PORT_QUERIES[q]], jax_rows[q], ordered=True, float_rtol=1e-9)


def test_serve_needs_cuda_without_a_device():
    import torch

    from trino_tpu_torch.bench_serve import run_serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: run_serve(device=None) would serve on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_serve(schema="tiny", clients=2, rounds=1, lanes=1)


def test_percentile_as_jax():
    from trino_tpu import bench_serve as jax_bs
    from trino_tpu_torch import bench_serve as bs

    walls = sorted(np.random.default_rng(3).random(37).tolist())
    for p in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert bs._percentile(walls, p) == jax_bs._percentile(walls, p)
    assert bs._percentile([], 0.5) is None


# -- bench_pressure --------------------------------------------------------------


def test_pressure_gate_passes(probes):
    sec = probes["pressure"]["section"]
    assert check_pressure("tiny", sec) == []
    assert sec["unconstrained_peak_bytes"] > 0
    assert sec["pool_limit_bytes"] == max(sec["unconstrained_peak_bytes"] // 8, 1 << 20)
    for side in ("local", "mesh"):
        assert sec[side]["waves"] >= 2 and sec[side]["spill_bytes"] > 0


def test_pressure_keys_equal_jax(probes):
    sec = probes["pressure"]["section"]
    keys = jax_pressure_keys()
    assert set(sec) == keys["top"] | {"local", "mesh"}
    assert set(sec["unconstrained"]) == keys["counters"]
    for side in ("local", "mesh"):
        assert set(sec[side]) == keys["side"]


def test_pressure_oracle_rows_equal_jax(probes, jax_rows):
    rows = probes["pressure"]["rows"]
    assert len(rows) > 0
    assert any(isinstance(v, Decimal) for v in rows[0])
    assert_same_rows(rows, jax_rows[18], ordered=True, float_rtol=1e-9)


def test_pressure_without_a_peak_raises():
    from trino_tpu_torch.bench_pressure import run_pressure

    class Result:
        rows = [(1,)]

    class NoPeak:
        class last_query:
            peak_memory = 0

        def execute(self, sql):
            return Result()

    with pytest.raises(AssertionError, match="no reserved peak"):
        run_pressure(NoPeak(), None, "select 1")


# -- chip_smoke.py's phase 5u checks ------------------------------------------------

#: one broken condition each: (section, path of keys, value)
VIOLATIONS = {
    "local_rows": ("serve", ("local", "rows_match"), False),
    "mesh_one_client": ("serve", ("mesh", "clients"), 1),
    "mesh_no_qps": ("serve", ("mesh", "qps"), 0),
    "chaos_rows": ("serve", ("chaos", "rows_match"), False),
    "warm_compile": ("serve", ("mesh", "warm_compile_events"), 1),
    "no_kill": ("serve", ("chaos", "injected_kills"), 0),
    "no_retry": ("serve", ("chaos", "task_retries", "retry"), 0),
    "retry_failed": ("serve", ("chaos", "task_retries", "fail"), 1),
    "no_spool": ("serve", ("chaos", "spooled_fragments"), 0),
    "no_spool_hit": ("serve", ("chaos", "spool_hits"), 0),
    "replanned": ("serve", ("chaos", "full_replans"), 1),
    "idle_waves": ("pressure", ("unconstrained", "memory_waves_total"), 2),
    "idle_spill": ("pressure", ("unconstrained", "spill_bytes_total"), 10),
    "one_wave": ("pressure", ("local", "waves"), 1),
    "no_spill": ("pressure", ("mesh", "spill_bytes"), 0),
    "mesh_rows": ("pressure", ("mesh", "rows_match"), False),
}


@pytest.mark.parametrize("case", [None] + list(VIOLATIONS))
def test_chip_smoke_probe_checks_agree_with_compare_bench(probes, case):
    """chip_smoke.probe_violations, which may not import tools/, finds what
    check_serve, check_chaos and check_pressure find."""
    import copy

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    secs = {k: copy.deepcopy(v["section"]) for k, v in probes.items()}
    if case is not None:
        which, path, value = VIOLATIONS[case]
        node = secs[which]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    tools = (check_serve(secs["serve"]) + check_chaos(secs["serve"]["chaos"])
             + check_pressure("tiny", secs["pressure"]))
    mine = chip_smoke.probe_violations(secs["serve"], secs["pressure"])
    assert bool(mine) == bool(tools) == (case is not None), (mine, tools)


def test_chip_smoke_numpy_q1_q6_equal_jax(jax_rows):
    """Phase 5u's numpy Q1 and Q6 (decimals from the cents, averages rounded
    half up) equal the JAX LocalQueryRunner's rows at tiny."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    expected = chip_smoke.q1_q6_numpy("tiny")
    assert expected["rows"] > 0
    for q in (1, 6):
        assert_same_rows(expected[q], jax_rows[q], ordered=True, float_rtol=0.0)
