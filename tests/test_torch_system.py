"""The port's `system` catalog and etc/ configuration against the JAX
package's: every case of tests/test_system_tables.py (the query history,
nodes, session properties, caches, spans and the metrics tables) and of
tests/test_config.py (properties files, etc/ catalogs, runner_from_etc,
the per-catalog and per-worker overrides and the file event listener).

Each case runs the same statements through the JAX LocalQueryRunner and
the port's (`device="cpu"`) at tpch.tiny and holds the rows and column
names equal, except where the port differs by design: `nodes` lists the
runner's device (`cpu` here; every CUDA device on the card) where the JAX
package lists its XLA devices.  The hive/iceberg/parquet catalogs load
under the JAX keys and answer with the JAX rows.
"""

import importlib
import json
import os

import pytest

PKGS = ("trino_tpu", "trino_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def runners():
    from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    return {
        "trino_tpu": JaxRunner(catalog="tpch", schema="tiny"),
        "trino_tpu_torch": LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    }


# -- system.runtime (tests/test_system_tables.py) -------------------------------


def test_query_history(runners):
    for r in runners.values():
        r.execute("select count(*) from nation")
        rows = r.execute(
            "select query_id, state, rows from system.runtime.queries "
            "where state = 'FINISHED'"
        ).rows
        assert rows and any(row[2] == 1 for row in rows)


def test_failed_query_recorded(runners):
    errors = {}
    for p, r in runners.items():
        with pytest.raises(Exception):
            r.execute("select no_such from nation")
        rows = r.execute(
            "select state, error, error_type from system.runtime.queries "
            "where state = 'FAILED'"
        ).rows
        assert rows and rows[-1][1] is not None
        errors[p] = rows[-1][2]
    assert errors["trino_tpu_torch"] == errors["trino_tpu"] == "USER_ERROR"


def test_nodes(runners):
    got = {
        p: r.execute("select node_id, state from system.runtime.nodes").rows
        for p, r in runners.items()
    }
    for rows in got.values():
        assert rows and all(row[1] == "ACTIVE" for row in rows)
    # the port lists its runner's device
    assert got["trino_tpu_torch"] == [("cpu", "ACTIVE")]
    cols = {
        p: r.execute("select * from system.runtime.nodes").column_names
        for p, r in runners.items()
    }
    assert cols["trino_tpu_torch"] == cols["trino_tpu"]


def test_session_properties_reflect_set_session(runners):
    got = {}
    for p, r in runners.items():
        r.execute("set session agg_fold_batches = 3")
        got[p] = r.execute(
            "select value from system.runtime.session_properties "
            "where name = 'agg_fold_batches'"
        ).only_value()
    assert got["trino_tpu_torch"] == got["trino_tpu"] == "3"
    names = {
        p: sorted(row[0] for row in r.execute(
            "select name from system.runtime.session_properties").rows)
        for p, r in runners.items()
    }
    assert names["trino_tpu_torch"] == names["trino_tpu"]


def test_caches_table(runners):
    for r in runners.values():
        rows = r.execute(
            "select tier, bytes from system.runtime.caches order by tier"
        ).rows
        assert [row[0] for row in rows] == ["device", "host"]


def test_queries_table_wall_and_error_type(runners):
    for r in runners.values():
        r.execute("select count(*) from nation")
        wall = r.execute(
            "select wall_s from system.runtime.queries "
            "where state = 'FINISHED' order by query_id desc limit 1"
        ).only_value()
        assert wall is not None and wall >= 0
        with pytest.raises(Exception):
            r.execute("select nope from nation")
        rows = r.execute(
            "select error_type from system.runtime.queries where state = 'FAILED'"
        ).rows
        assert ("USER_ERROR",) in rows


def test_spans_table(runners):
    names = {}
    for p, r in runners.items():
        r.execute("select count(*) from region")
        rows = r.execute(
            "select query_id, name, parent_id, duration_ms from system.runtime.spans"
        ).rows
        assert rows
        names[p] = {row[1] for row in rows}
        by_query: dict = {}
        for qid, name, parent, _ in rows:
            if parent == 0:
                by_query[qid] = by_query.get(qid, 0) + 1
        assert by_query and all(n == 1 for n in by_query.values())
    assert {"query", "analyze", "optimize", "execute"} <= names["trino_tpu_torch"]
    assert names["trino_tpu_torch"] <= names["trino_tpu"]


def test_metrics_tables(runners):
    for r in runners.values():
        r.execute("select count(*) from nation")
        rows = r.execute(
            "select name, kind, value from system.runtime.metrics "
            "where name = 'trino_tpu_queries_total'"
        ).rows
        assert rows and all(row[1] == "counter" for row in rows)
        total = r.execute(
            "select sum(value) from system.metrics.metrics "
            "where name = 'trino_tpu_queries_total'"
        ).only_value()
        assert total >= 1


def test_system_schemas_tables_and_columns_equal_jax(runners):
    out = {}
    for p, r in runners.items():
        schemas = r.execute("show schemas from system").rows
        tables = r.execute("show tables from system.runtime").rows
        cols = {
            t[0]: r.execute(f"describe system.runtime.{t[0]}").rows for t in tables
        }
        out[p] = (schemas, tables, cols)
    assert out["trino_tpu_torch"] == out["trino_tpu"]


def test_unported_system_tables(runners):
    """The observatory tables answer now: compilations lists the compile
    observatory's ring; the profile and decision tables give no rows while
    no profile store is attached, and the store's rows once one is."""
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
    from trino_tpu_torch.telemetry.profile_store import ProfileStore

    port = runners["trino_tpu_torch"]
    assert len(port.execute("select * from system.runtime.compilations").rows) <= len(
        OBSERVATORY.events()
    )
    for t in ("query_profiles", "plan_decisions"):
        sql = f"select count(*) from system.runtime.{t}"
        assert port.execute(sql).rows == runners["trino_tpu"].execute(sql).rows == [(0,)]
    port.profile_store = ProfileStore()
    try:
        port.execute("select count(*) from region")
        rows = port.execute("select query_id, state from system.runtime.query_profiles").rows
        assert rows == [(port.profile_store.refs()[0]["query_id"], "FINISHED")]
    finally:
        port.profile_store = None


# -- etc/ configuration (tests/test_config.py) ----------------------------------


def _write_etc(tmp_path, parquet: bool) -> str:
    etc = tmp_path / "etc"
    cat = etc / "catalog"
    cat.mkdir(parents=True)
    (etc / "config.properties").write_text(
        "# node config\n"
        "default.catalog=tpch\n"
        "default.schema=tiny\n"
        "session.target_splits=3\n"
        "http-server.http.port: 8080\n"
        "long.value=a\\\nb\n"
    )
    (cat / "tpch.properties").write_text("connector.name=tpch\n")
    (cat / "mem.properties").write_text("connector.name=memory\n")
    if parquet:
        pq = tmp_path / "pq"
        pq.mkdir()
        (cat / "files.properties").write_text(f"connector.name=parquet\nparquet.dir={pq}\n")
    return str(etc)


@pytest.fixture()
def etc_dir(tmp_path):
    return _write_etc(tmp_path, parquet=False)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for p in PKGS:
        mod(p, "config").reset_config()


def test_load_properties(etc_dir):
    got = [
        mod(p, "runtime.config").load_properties(os.path.join(etc_dir, "config.properties"))
        for p in PKGS
    ]
    assert got[0] == got[1]
    assert got[1]["default.catalog"] == "tpch"
    assert got[1]["http-server.http.port"] == "8080"
    assert got[1]["long.value"] == "ab"


def test_load_etc_catalogs(etc_dir):
    for p in PKGS:
        cfg = mod(p, "runtime.config").load_etc(etc_dir)
        assert set(cfg.catalogs.names()) >= {"tpch", "mem"}
        assert cfg.session_defaults == {"target_splits": 3}


@pytest.mark.parametrize("connector", ["parquet", "hive", "iceberg"])
def test_unported_connectors_raise_by_name(tmp_path, connector):
    """The parquet, hive and iceberg catalogs (no longer unported: the port
    reads and writes Parquet itself) load from an etc/ directory in both
    packages under the JAX keys, and one query over the lake's nation table
    gives equal rows."""
    from trino_tpu.connectors.tpch import TpchConnector as JaxTpch

    etc = _write_etc(tmp_path, parquet=False)
    lake = tmp_path / "lake"
    lake.mkdir()
    if connector == "parquet":
        from trino_tpu.connectors.parquet import write_table_to_parquet

        write_table_to_parquet(JaxTpch(), "tiny", "nation", str(lake))
        key = "parquet.dir"
    elif connector == "hive":
        from trino_tpu.connectors.hive import write_partitioned

        write_partitioned(JaxTpch(), "tiny", "nation", str(lake), partition_by=["n_regionkey"])
        key = "hive.metastore.catalog.dir"
    else:
        from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
        from trino_tpu.connectors.api import CatalogManager
        from trino_tpu.connectors.iceberg import IcebergConnector

        cm = CatalogManager()
        cm.register("tpch", JaxTpch())
        cm.register("ice", IcebergConnector(str(lake)))
        JaxRunner(cm, catalog="ice", schema="tiny").execute(
            "create table nation as select * from tpch.tiny.nation"
        )
        key = "iceberg.catalog.warehouse"
    with open(os.path.join(etc, "catalog", "lake.properties"), "w") as fh:
        fh.write(f"connector.name={connector}\n{key}={lake}\n")
    sql = ("select n_regionkey, count(*), min(n_name), sum(n_nationkey) "
           "from lake.tiny.nation group by n_regionkey order by n_regionkey")
    rows = []
    for p in PKGS:
        cfg = mod(p, "runtime.config").load_etc(etc)
        assert type(cfg.catalogs.get("lake")).__module__ == f"{p}.connectors.{connector}"
        kw = {"device": "cpu"} if p == "trino_tpu_torch" else {}
        rows.append(mod(p, "runtime.config").runner_from_etc(etc, **kw).execute(sql).rows)
    assert rows[0] == rows[1] and len(rows[0]) == 5


def test_runner_from_etc(etc_dir):
    from trino_tpu.runtime.config import runner_from_etc as jax_runner_from_etc
    from trino_tpu_torch.runtime.config import runner_from_etc

    for r in (jax_runner_from_etc(etc_dir), runner_from_etc(etc_dir, device="cpu")):
        assert r.properties.get("target_splits") == 3
        assert r.execute("select count(*) from nation").rows == [(25,)]
        r.execute("create table mem.default.t (x bigint)")
        r.execute("insert into mem.default.t values (7)")
        assert r.execute("select * from mem.default.t").rows == [(7,)]


def test_runner_from_etc_needs_cuda_by_default(etc_dir):
    import torch

    from trino_tpu_torch.runtime.config import runner_from_etc

    if torch.cuda.is_available():
        assert runner_from_etc(etc_dir).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner_from_etc(etc_dir)


@pytest.mark.parametrize("key", [
    "profile.archive-dir", "audit.log-path", "prewarm.manifest-path",
    "access-control.config-file",
])
def test_unported_knobs_raise_by_name(etc_dir, tmp_path, key):
    """The observatory's knobs attach their pieces (as in the JAX package:
    the profile store archives each statement under the directory, the
    audit log writes one line per statement), and the access-control file
    installs its rules (the runner's user may read nation, not region),
    and the prewarm manifest attaches an executor that records, saves and
    replays to WARM with the JAX package's executor beside it."""
    import json

    from trino_tpu_torch.config import reset_config
    from trino_tpu_torch.runtime.config import runner_from_etc
    from trino_tpu_torch.server.security import AccessDeniedError
    from trino_tpu_torch.telemetry.audit import QueryAuditLog

    target = tmp_path / "x"
    if key == "access-control.config-file":
        target.write_text(json.dumps({"tables": [
            {"user": "user", "catalog": "tpch", "table": "nation", "privileges": ["SELECT"]},
        ]}))
    with open(os.path.join(etc_dir, "config.properties"), "a") as fh:
        fh.write(f"{key}={target}\n")
    try:
        if key == "prewarm.manifest-path":
            from trino_tpu.config import reset_config as jax_reset
            from trino_tpu.runtime.config import runner_from_etc as jax_from_etc

            got = {}
            try:
                for p, build in (("trino_tpu", jax_from_etc), ("trino_tpu_torch", runner_from_etc)):
                    r = build(etc_dir) if p == "trino_tpu" else build(etc_dir, device="cpu")
                    pw = r.prewarm
                    assert type(pw).__module__ == f"{p}.runtime.prewarm"
                    assert pw.location == str(target) and pw.state == "IDLE"
                    rows = r.execute("select count(*) from nation").rows
                    assert pw.record("select count(*) from nation") and pw.save()
                    pw.run(reason="start", wait=True)
                    got[p] = (rows, pw.state, pw.runs, pw.verify_events,
                              json.loads(target.read_text())["sql"])
                    target.unlink()
            finally:
                jax_reset()
            assert got["trino_tpu_torch"] == got["trino_tpu"]
            assert got["trino_tpu"][1] == "WARM"
            return
        r = runner_from_etc(etc_dir, device="cpu")
        r.execute("select count(*) from nation")
        if key == "access-control.config-file":
            with pytest.raises(AccessDeniedError, match="lacks SELECT on tpch.tiny.region"):
                r.execute("select count(*) from region")
        elif key == "profile.archive-dir":
            assert r.profile_store is not None and r.profile_store.flush(10.0)
            assert len(os.listdir(target)) == 1
        else:
            assert any(isinstance(l, QueryAuditLog) for l in r.events.listeners)
            assert len(target.read_text().splitlines()) == 1
    finally:
        reset_config()


def test_unknown_connector_rejected(tmp_path):
    cat = tmp_path / "catalog"
    cat.mkdir()
    (cat / "bad.properties").write_text("connector.name=nope\n")
    for p in PKGS:
        with pytest.raises(ValueError, match="unknown connector.name"):
            mod(p, "runtime.config").load_etc(str(tmp_path))


def test_catalog_override_resolution_order():
    """env > per-catalog > per-worker > base, in both packages."""
    props = {
        "breaker.failure-threshold": "4",
        "breaker.failure-threshold@tpch": "6",
        "breaker.failure-threshold@8123": "9",
    }
    got = []
    for p in PKGS:
        B = mod(p, "config").BreakerConfig
        got.append((
            B.from_properties(props).failure_threshold,
            B.from_properties(props, worker="http://127.0.0.1:8123", catalog="tpch").failure_threshold,
            B.from_properties(props, worker="http://127.0.0.1:8123").failure_threshold,
            B.from_properties(
                props, env={"TRINO_TPU_BREAKER_FAILURE_THRESHOLD": "2"},
                worker="http://127.0.0.1:8123", catalog="tpch",
            ).failure_threshold,
        ))
        cfg = mod(p, "config").load_cluster_config(props, env={})
        assert cfg.breaker.failure_threshold == 4
    assert got[0] == got[1] == (4, 6, 9, 2)


def test_catalog_override_is_exact_match():
    """A per-catalog override matches the catalog's exact name, of every
    section, in both packages; the base key still resolves."""
    props = {"breaker.failure-threshold@tpch": "6"}
    for p in PKGS:
        B = mod(p, "config").BreakerConfig
        assert B.from_properties(props, catalog="tpch_backup").failure_threshold == 3
        assert B.from_properties(props, catalog="tpch").failure_threshold == 6
    got = [mod(p, "config").load_cluster_config(
        {"dispatcher.lanes": "2", "dispatcher.lanes@tpch": "5"}, env={}) for p in PKGS]
    assert got[0].dispatcher.lanes == got[1].dispatcher.lanes == 2
    assert [c.section_for("dispatcher", catalog="tpch").lanes for c in got] == [5, 5]


def test_cluster_config_section_for():
    """Every section resolves alike in both packages, and so do
    section_for (per-worker and per-catalog overrides), breaker_for and the
    lifecycle keys (the HTTP tier's request timeouts)."""
    props = {
        "dispatcher.drain-grace": "1.5",
        "dispatcher.lanes": "3",
        "memory.spill-dir": "/nonexistent/spill",
        "dispatcher.lanes@h:8200": "7",
        "breaker.cooldown@h:8200": "0.5",
        "lifecycle.request-timeout": "50",
    }
    got = []
    for p in PKGS:
        cfg = mod(p, "config").load_cluster_config(props, env={})
        got.append((
            cfg.dispatcher.drain_grace_s, cfg.dispatcher.lanes, cfg.memory.spill_dir,
            cfg.section_for("dispatcher", worker="http://h:8200").lanes,
            cfg.breaker_for("http://h:8200").cooldown_s,
            cfg.breaker_for("http://h:9999").cooldown_s,
            cfg.lifecycle.request_timeout_s,
        ))
    assert got[0] == got[1] == (1.5, 3, "/nonexistent/spill", 7, 0.5, 5.0, 50.0)


def test_file_event_listener(etc_dir, tmp_path):
    from trino_tpu.runtime.config import runner_from_etc as jax_runner_from_etc
    from trino_tpu_torch.runtime.config import runner_from_etc

    out = []
    for name, make in (("jax", jax_runner_from_etc), ("port", runner_from_etc)):
        log = tmp_path / f"events_{name}.jsonl"
        with open(os.path.join(etc_dir, "event-listener.properties"), "w") as fh:
            fh.write(f"event-listener.name=file\nfile.path={log}\n")
        r = make(etc_dir) if name == "jax" else make(etc_dir, device="cpu")
        r.execute("select 1")
        lines = [json.loads(line) for line in log.read_text().splitlines()]
        assert [d["event"] for d in lines] == ["query_created", "query_completed"]
        assert lines[1]["state"] == "FINISHED" and lines[1]["rows"] == 1
        out.append([sorted(d) for d in lines])
    assert out[0] == out[1]
