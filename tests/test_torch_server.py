"""The port's serving tier against the JAX package's, on the CPU at
tpch.tiny: the coordinator and the statement protocol
(trino_tpu_torch/server/{coordinator,protocol}.py), the client, the CLI,
the DB-API driver, the web UI, the proxy and the verifier.

The protocol exchanges run the same statement through one JAX
CoordinatorServer and one port CoordinatorServer(device="cpu") (a pair for
the module, on 127.0.0.1 with ephemeral ports) over raw HTTP: POST
/v1/statement, then nextUri to the end.  Each holds the HTTP status codes,
the `columns` JSON, the number of data pages, the rows each package's own
protocol.decode_rows gives (integers, decimals with their scale, dates,
timestamps and strings exact and of the same type; doubles relative
1e-9), and a failed statement's errorName, errorType and errorCode.  The
round trip covers NULLs, decimals, dates, timestamps, timestamps with time
zone, times, intervals, varbinary, arrays and maps, and pages 25**3 rows.

The cases of tests/test_server.py, tests/test_tools_ui.py (UI, proxy,
verifier), tests/test_dbapi_txn_rg.py (the DB-API driver in-process and
over HTTP), tests/test_dispatcher.py's coordinator cases (concurrency, a
429 shed with Retry-After, the queued-time limit, cancel while queued),
tests/test_restart.py's register, detector and HMAC cases,
tests/test_profile_store.py's profile endpoint and tests/test_decisions.py's
decisions endpoint run once per package (`pkg`) with the same inputs and
assertions.  Real timeouts are kept to tens of milliseconds.
"""

import importlib
import io
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest

from test_torch_e2e import assert_same_rows

PKGS = ("trino_tpu", "trino_tpu_torch")
RTOL = 1e-9


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def local_runner(pkg: str, **kw):
    """A LocalQueryRunner of the package (the port's on the CPU)."""
    R = mod(pkg, "runtime.runner").LocalQueryRunner
    return R(**kw) if pkg == "trino_tpu" else R(device="cpu", **kw)


def make_server(pkg: str, **kw):
    """A started CoordinatorServer of the package on an ephemeral port (the
    port's builds its runner on the CPU when none is given)."""
    C = mod(pkg, "server.coordinator").CoordinatorServer
    if pkg == "trino_tpu_torch" and "runner" not in kw:
        kw["device"] = "cpu"
    srv = C(port=0, **kw)
    srv.start()
    return srv


def base(srv) -> str:
    return f"http://127.0.0.1:{srv.port}"


@pytest.fixture(scope="module")
def servers():
    out = {p: make_server(p) for p in PKGS}
    yield out
    for srv in out.values():
        srv.shutdown()


def http(method: str, url: str, body=None, headers=None):
    """(status, headers, body bytes) of one request; an HTTP error status is
    a result, not an exception."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def exchange(pkg: str, url: str, sql: str, headers=None) -> dict:
    """POST `sql`, follow nextUri to the end; the statuses seen, the last
    columns JSON, the data pages, the decoded rows and the error."""
    protocol = mod(pkg, "server.protocol")
    statuses = set()
    status, _, raw = http("POST", url + "/v1/statement", sql.encode(), headers)
    statuses.add(status)
    doc = json.loads(raw)
    columns, data, pages, error = None, [], 0, None
    while status == 200:
        if "columns" in doc:
            columns = doc["columns"]
        if "data" in doc:
            data.extend(doc["data"])
            pages += 1
        if doc.get("error"):
            error = doc["error"]
            break
        nxt = doc.get("nextUri")
        if nxt is None:
            break
        status, _, raw = http("GET", url + nxt, headers=headers)
        statuses.add(status)
        doc = json.loads(raw)
    if status != 200:
        error = doc.get("error")
    rows = protocol.decode_rows(data, columns) if columns is not None else []
    return {"statuses": statuses, "columns": columns, "pages": pages, "rows": rows,
            "state": doc.get("stats", {}).get("state"), "error": error}


def error_class(err: dict) -> tuple:
    return err["errorName"], err["errorType"], err["errorCode"]


def assert_same_exchange(got: dict, want: dict, ordered: bool = True) -> None:
    assert got["statuses"] == want["statuses"]
    assert got["columns"] == want["columns"]
    assert got["pages"] == want["pages"]
    assert got["state"] == want["state"]
    assert_same_rows(got["rows"], want["rows"], ordered, float_rtol=RTOL)
    if want["error"] is None:
        assert got["error"] is None, got["error"]
    else:
        assert error_class(got["error"]) == error_class(want["error"])


# -- the protocol round trip ---------------------------------------------------

TYPED = (
    "select cast(1.5 as decimal(10,2)) d, cast(12345678901234567890.5 as decimal(30,1)) ld, "
    "date '2020-01-02' dt, timestamp '2020-01-02 03:04:05.678' ts, "
    "timestamp '2020-01-02 03:04:05 +02:00' tz, time '01:02:03' t, interval '3' day iv, "
    "interval '2' month ym, cast(null as varbinary) vb, array[1, 2] a, "
    "map(array['a'], array[1.5]) m, cast(null as varchar) n, 1.5e0 dbl, true b, "
    "cast(null as date) nd, array['x', 'yz'] sa"
)

#: name -> (SQL, ORDER BY fixes the row order)
EXCHANGES = {
    "scalars": ("select 1 as a, 'x' as b, null as c", True),
    "typed": (TYPED, True),
    "nation": ("select n_name, n_regionkey from tpch.tiny.nation order by n_name limit 2", True),
    "decimal_sum": ("select sum(r_regionkey) * 1.5 from tpch.tiny.region", True),
    "grouped": (
        "select o_orderstatus, count(*), sum(o_totalprice), avg(o_totalprice), "
        "min(o_orderdate) from tpch.tiny.orders group by 1 order by 1", True,
    ),
    "paging": (
        "select n1.n_nationkey from tpch.tiny.nation n1, tpch.tiny.nation n2, "
        "tpch.tiny.nation n3", False,
    ),
    "empty": ("select n_name from tpch.tiny.nation where n_nationkey < 0", True),
    "show_tables": ("show tables from tpch.tiny", False),
    "no_such_column": ("select no_such_column from tpch.tiny.region", True),
    "unknown_function": ("select no_such_function(1)", True),
    "parse_error": ("select from where", True),
    "not_implemented": (
        "select o_custkey % cast(o_totalprice as decimal(30,2)) from tpch.tiny.orders", True,
    ),
    "no_such_table": ("select * from tpch.tiny.no_such_table", True),
}


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_exchange_matches_jax(servers, name):
    sql, ordered = EXCHANGES[name]
    want = exchange("trino_tpu", base(servers["trino_tpu"]), sql)
    got = exchange("trino_tpu_torch", base(servers["trino_tpu_torch"]), sql)
    assert_same_exchange(got, want, ordered)
    if name == "paging":
        assert len(got["rows"]) == 25 ** 3 and got["pages"] == 4
    if name in ("no_such_column", "unknown_function", "parse_error", "not_implemented",
                "no_such_table"):
        assert got["state"] == "FAILED" and got["error"]["message"]
    else:
        assert got["state"] == "FINISHED" and got["error"] is None


def test_deadline_error_classified(servers):
    """A lifecycle error (EXCEEDED_TIME_LIMIT) reaches the client with the
    JAX coordinator's name, type and code; the session property is shared
    by every lane and restored after."""
    got = {}
    for p, srv in servers.items():
        exchange(p, base(srv), "set session query_max_run_time = 0.000001")
        try:
            got[p] = exchange(p, base(srv), "select count(*) from tpch.tiny.lineitem")
        finally:
            exchange(p, base(srv), "set session query_max_run_time = 0")
    assert_same_exchange(got["trino_tpu_torch"], got["trino_tpu"])
    assert got["trino_tpu_torch"]["error"]["errorCode"] == "EXCEEDED_TIME_LIMIT"


@pytest.mark.parametrize("value,type_name", [
    (None, "bigint"), (True, "boolean"), (7, "bigint"), (2.5, "double"), ("x", "varchar"),
    ("decimal", "decimal(12,2)"), ("date", "date"), ("timestamp", "timestamp"),
    ("tz", "timestamp with time zone"), ("time", "time"), (b"\xca\xfe", "varbinary"),
    ([1, None], "array(bigint)"), ({"a": 1}, "map(varchar, bigint)"),
])
def test_value_serde_matches_jax(value, type_name):
    """encode_value / decode_value of both packages on the same values."""
    import datetime
    from decimal import Decimal

    value = {
        "decimal": Decimal("-12.50"), "date": datetime.date(1998, 12, 1),
        "timestamp": datetime.datetime(2020, 1, 2, 3, 4, 5, 678000),
        "tz": datetime.datetime(2020, 1, 2, 3, 4, 5, tzinfo=datetime.timezone(
            datetime.timedelta(hours=2))),
        "time": datetime.time(1, 2, 3),
    }.get(value, value) if isinstance(value, str) else value
    out = []
    for p in PKGS:
        protocol = mod(p, "server.protocol")
        wire = json.loads(json.dumps(protocol.encode_value(value)))
        out.append((wire, protocol.decode_value(wire, type_name)))
    assert out[0] == out[1]
    assert type(out[0][1]) is type(out[1][1])
    if type_name in ("decimal(12,2)", "date", "timestamp", "varbinary", "bigint", "double"):
        assert out[1][1] == value


def test_page_size_from_config():
    """coordinator.result-page-rows pages a result alike in both packages."""
    got = {}
    for p in PKGS:
        config = mod(p, "config")
        config.install_config(config.load_cluster_config(
            {"coordinator.result-page-rows": "1000", "coordinator.poll-wait": "0.5"}, env={}))
        srv = make_server(p)
        try:
            assert config.get_config().coordinator.poll_wait_s == 0.5
            got[p] = exchange(p, base(srv), EXCHANGES["paging"][0])
        finally:
            srv.shutdown()
            config.reset_config()
    assert got["trino_tpu_torch"]["pages"] == got["trino_tpu"]["pages"] == 16
    assert_same_exchange(got["trino_tpu_torch"], got["trino_tpu"], ordered=False)


# -- the other routes --------------------------------------------------------------


ROUTES = [
    ("GET", "/nope"), ("POST", "/v1/nope"), ("GET", "/v1/statement/executing/q_999/0"),
    ("GET", "/v1/query/nope/trace"), ("GET", "/v1/query/nope/profile"),
    ("GET", "/v1/query/nope/decisions"), ("GET", "/v1/dictionary/a/b"),
    ("GET", "/v1/dictionary/tpch/tiny/nation/n_name?version=x"),
    ("GET", "/v1/dictionary/tpch/tiny/no_table/no_col?version=7"),
    ("DELETE", "/v1/query/nope"), ("DELETE", "/v1/statement/executing/q_999/0"),
    ("DELETE", "/v1/nope"), ("PUT", "/v1/nope"), ("PUT", "/v1/worker/register"),
    ("PUT", "/v1/worker/drain"), ("GET", "/ui/nope"), ("GET", "/ui/api/query/q_999"),
]


@pytest.mark.parametrize("method,path", ROUTES, ids=[f"{m} {p}" for m, p in ROUTES])
def test_route_statuses_match_jax(servers, method, path):
    body = b"http://127.0.0.1:9" if method == "PUT" else None
    got = [http(method, base(servers[p]) + path, body)[0] for p in PKGS]
    assert got[0] == got[1]
    assert got[1] in (204, 400, 404)


def test_metrics_endpoint(servers, pkg):
    client = mod(pkg, "client").Client(base(servers[pkg]))
    client.execute("select count(*) from tpch.tiny.nation")
    status, headers, raw = http("GET", base(servers[pkg]) + "/v1/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    text = raw.decode()
    assert "# TYPE trino_tpu_queries_total counter" in text
    assert "trino_tpu_trace_cache_hits_total" in text
    assert 'trino_tpu_mesh_events_total{counter="exchange_elided"}' in text
    assert "trino_tpu_query_wall_seconds_count" in text


def test_query_trace_endpoint(servers):
    names = {}
    for p, srv in servers.items():
        q = srv.submit("select count(*) from tpch.tiny.region")
        assert q.done.wait(timeout=60)
        status, _, raw = http("GET", f"{base(srv)}/v1/query/{q.id}/trace")
        assert status == 200
        names[p] = sorted({e["name"] for e in json.loads(raw)["traceEvents"]})
    assert {"query", "execute"} <= set(names["trino_tpu_torch"])
    assert names["trino_tpu_torch"] == names["trino_tpu"]


def test_ui_documents_match_jax(servers):
    docs = {}
    for p, srv in servers.items():
        q = srv.submit("select count(*) from tpch.tiny.nation")
        assert q.done.wait(timeout=60)
        page = http("GET", base(srv) + "/ui/")
        stats = json.loads(http("GET", base(srv) + "/ui/api/stats")[2])
        listing = json.loads(http("GET", base(srv) + "/ui/api/query")[2])
        one = json.loads(http("GET", f"{base(srv)}/ui/api/query/{q.id}")[2])
        assert page[0] == 200 and b"trino_tpu coordinator" in page[2]
        assert stats["totalQueries"] >= 1 and stats["metricsUri"] == "/v1/metrics"
        assert "retraces" in stats["traceCache"]
        assert any(x["queryId"] == q.id for x in listing)
        assert one["state"] == "FINISHED" and one["rowCount"] == 1
        docs[p] = (sorted(stats), sorted(listing[0]), {k: v for k, v in one.items()
                                                        if k != "queryId"})
    assert docs["trino_tpu_torch"] == docs["trino_tpu"]


def test_web_ui(pkg):
    srv = make_server(pkg)
    try:
        qq = srv.submit("select count(*) from nation")
        qq.done.wait(timeout=60)
        page = urllib.request.urlopen(f"{base(srv)}/ui/", timeout=10).read()
        assert b"trino_tpu coordinator" in page
        stats = json.load(urllib.request.urlopen(f"{base(srv)}/ui/api/stats", timeout=10))
        assert stats["totalQueries"] >= 1
        queries = json.load(urllib.request.urlopen(f"{base(srv)}/ui/api/query", timeout=10))
        assert any(x["queryId"] == qq.id for x in queries)
        one = json.load(urllib.request.urlopen(f"{base(srv)}/ui/api/query/{qq.id}", timeout=10))
        assert one["state"] == "FINISHED" and one["rowCount"] == 1
    finally:
        srv.shutdown()


# -- client, CLI, proxy, verifier ----------------------------------------------------


def test_client_roundtrip_and_error(servers, pkg):
    client = mod(pkg, "client")
    c = client.Client(base(servers[pkg]))
    names, rows = c.execute("select 1 as a, 'x' as b, null as c")
    assert names == ["a", "b", "c"] and rows == [(1, "x", None)]
    with pytest.raises(client.QueryFailed) as ei:
        c.execute("select no_such_column from tpch.tiny.region")
    assert "no_such_column" in str(ei.value)
    assert ei.value.error["errorName"] == "AnalysisError"


def test_cli_format_matches_jax():
    rows = [(1, "x"), (None, "longer"), (2.5, None)]
    texts = [mod(p, "cli").format_table(["a", "bb"], rows) for p in PKGS]
    assert texts[0] == texts[1]
    lines = texts[1].splitlines()
    assert lines[0].startswith("a ") and "bb" in lines[0]
    assert "NULL" in texts[1] and "(3 rows)" in texts[1]
    many = [(i,) for i in range(250)]
    assert mod(PKGS[0], "cli").format_table(["n"], many) == mod(
        PKGS[1], "cli").format_table(["n"], many)


def _cli_table(pkg: str, argv: list) -> str:
    out = io.StringIO()
    with redirect_stdout(out):
        assert mod(pkg, "cli").main(argv) == 0
    return "\n".join(out.getvalue().splitlines()[:-1])  # the timing line is the host's


def test_cli_local_and_server_match_jax(servers):
    sql = "select n_name, n_regionkey from nation order by n_nationkey limit 3"
    want = _cli_table("trino_tpu", ["-e", sql])
    assert _cli_table("trino_tpu_torch", ["--device", "cpu", "-e", sql]) == want
    assert "ALGERIA" in want and "(3 rows)" in want
    url = base(servers["trino_tpu_torch"])
    assert _cli_table("trino_tpu_torch", ["--server", url, "-e", sql]) == want
    out = io.StringIO()
    from contextlib import redirect_stderr

    with redirect_stderr(out):
        assert mod("trino_tpu_torch", "cli").main(
            ["--device", "cpu", "-e", "select no_such_column from nation"]) == 1
    assert "no_such_column" in out.getvalue()


def test_proxy_roundtrip(pkg):
    srv = make_server(pkg)
    proxy = mod(pkg, "server.proxy").ProxyServer(base(srv), port=0).start()
    try:
        cols, rows = mod(pkg, "client").Client(proxy.url).execute("select 41 + 1")
        assert rows == [(42,)]
        got = exchange(pkg, proxy.url, EXCHANGES["nation"][0])
        assert [r[0] for r in got["rows"]] == ["ALGERIA", "ARGENTINA"]
    finally:
        proxy.shutdown()
        srv.shutdown()


def test_proxy_rewrites_backend_uris():
    """nextUri/infoUri pointing at the backend are rewritten, others kept."""
    docs = []
    for p in PKGS:
        proxy = mod(p, "server.proxy").ProxyServer("http://backend:1", port=0).start()
        try:
            doc = {"nextUri": "http://backend:1/v1/statement/executing/q_1/1",
                   "nested": [{"infoUri": "http://backend:1/ui/q_1"}],
                   "other": "http://elsewhere/x"}
            out = json.loads(proxy._rewrite(json.dumps(doc).encode()))
            docs.append(json.dumps(out).replace(proxy.url, "PROXY"))
        finally:
            proxy.shutdown()
    assert docs[0] == docs[1]
    assert "http://backend:1" not in docs[1] and "http://elsewhere/x" in docs[1]


class _Broken:
    def __init__(self, inner):
        self.inner = inner

    def execute(self, sql):
        res = self.inner.execute(sql)
        if "n_regionkey" in sql:
            res = type(res)(res.column_names, [tuple(r) for r in res.rows[:-1]], res.types)
        return res


def test_verifier_match_and_mismatch(pkg):
    Verifier = mod(pkg, "testing.verifier").Verifier
    control = local_runner(pkg, catalog="tpch", schema="tiny")
    test = local_runner(pkg, catalog="tpch", schema="tiny", target_splits=2)
    rep = Verifier(control, test).run({"a": "select count(*) from nation", "b": "select 1.5"})
    assert rep.matched == 2 and not rep.failed
    rep2 = Verifier(control, _Broken(test)).run({
        "ok": "select n_name from nation where n_nationkey = 0",
        "bad": "select n_regionkey from nation",
        "err": "select no_such_column from nation",
    })
    st = {r.query_id: r.status for r in rep2.results}
    assert st == {"ok": "MATCH", "bad": "MISMATCH", "err": "CONTROL_ERROR"}
    assert "1 match, 2 fail" in rep2.summary()


def test_verifier_tolerance_and_order():
    """The comparison rules (float tolerance, ordered mode, NULLs, widths)
    give the JAX verifier's verdicts and details."""
    cases = [
        ([(1.0,)], [(1.0 + 1e-12,)], False),
        ([(1.0,)], [(1.001,)], False),
        ([(1,), (2,)], [(2,), (1,)], False),
        ([(1,), (2,)], [(2,), (1,)], True),
        ([(None,)], [(0,)], False),
        ([(1, 2)], [(1,)], False),
        ([(1,)], [(1,), (2,)], False),
    ]
    got = {}
    for p in PKGS:
        V = mod(p, "testing.verifier").Verifier
        got[p] = [V(None, None, ordered=o)._compare(c, t) for c, t, o in cases]
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    assert [ok for ok, _ in got["trino_tpu_torch"]] == [True, False, True, False, False, False,
                                                        False]


# -- DB-API ----------------------------------------------------------------------------


def test_dbapi_embedded_roundtrip(pkg):
    dbapi = mod(pkg, "dbapi")
    conn = dbapi.connect(runner=local_runner(pkg))
    cur = conn.cursor()
    cur.execute("select n_name, n_nationkey from nation order by n_nationkey limit 3")
    assert cur.rowcount == 3
    assert [d[0] for d in cur.description] == ["n_name", "n_nationkey"]
    assert [d[1] for d in cur.description] == ["varchar(25)", "bigint"]
    assert cur.fetchone() == ("ALGERIA", 0)
    assert len(cur.fetchall()) == 2
    assert cur.fetchone() is None


def test_dbapi_parameters_and_literals(pkg):
    dbapi = mod(pkg, "dbapi")
    cur = dbapi.connect(runner=local_runner(pkg)).cursor()
    cur.execute("select count(*) from nation where n_regionkey = ? and n_name like ?", (2, "J%"))
    assert cur.fetchone() == (1,)  # JAPAN
    cur.execute("select ?", ("it''s",))
    assert "it" in cur.fetchone()[0]
    cur.execute("select ?, 'a?b'", (7,))
    assert cur.fetchone() == (7, "a?b")
    cur.execute("select ? -- valid?\n", (1,))
    assert cur.fetchone() == (1,)
    cur.execute("select ? /* really? */", (2,))
    assert cur.fetchone() == (2,)
    with pytest.raises(dbapi.InterfaceError, match="placeholders"):
        cur.execute("select ?, ?", (1,))
    with pytest.raises(dbapi.InterfaceError, match="unsupported parameter type"):
        cur.execute("select ?", (object(),))


def test_dbapi_over_http(servers, pkg):
    dbapi = mod(pkg, "dbapi")
    conn = dbapi.connect(base(servers[pkg]))
    cur = conn.cursor()
    cur.execute("select 1 + 1")
    assert cur.fetchall() == [(2,)]
    cur.execute("select n_name from nation where n_nationkey = ?", (0,))
    assert cur.fetchall() == [("ALGERIA",)] and cur.description[0][0] == "n_name"
    with pytest.raises(dbapi.DatabaseError, match="no_such_column"):
        cur.execute("select no_such_column from nation")


def test_dbapi_error_maps_to_database_error(pkg):
    dbapi = mod(pkg, "dbapi")
    conn = dbapi.connect(runner=local_runner(pkg))
    with pytest.raises(dbapi.DatabaseError):
        conn.cursor().execute("select no_such_column from nation")
    with pytest.raises(dbapi.InterfaceError):
        dbapi.connect()
    conn.close()
    with pytest.raises(dbapi.InterfaceError):
        conn.cursor()


def test_dbapi_transaction_commit_rollback(pkg):
    dbapi = mod(pkg, "dbapi")
    r = local_runner(pkg, catalog="memory", schema="default")
    conn = dbapi.connect(runner=r)
    cur = conn.cursor()
    cur.execute("create table t (x bigint)")
    cur.execute("start transaction")
    cur.execute("insert into t select 1")
    conn.rollback()
    assert cur.execute("select count(*) from t").fetchone() == (0,)
    cur.execute("start transaction")
    cur.execute("insert into t select 2")
    conn.commit()
    assert cur.execute("select * from t").fetchall() == [(2,)]


def test_execute_placeholder_errors_match_jax():
    """EXECUTE with the wrong parameter count raises the JAX runner's
    InterfaceError, with the same message."""
    got = []
    for p in PKGS:
        r = local_runner(p)
        r.execute("prepare s from select n_name from nation where n_nationkey = ?")
        with pytest.raises(Exception) as ei:
            r.execute("execute s using 1, 2")
        got.append((type(ei.value).__name__, str(ei.value)))
    assert got[0] == got[1] and got[1][0] == "InterfaceError"


# -- dispatcher, shedding, queue deadlines (tests/test_dispatcher.py) -------------------


def _groups(pkg: str, **kw):
    G = mod(pkg, "runtime.resource_groups")
    return G.ResourceGroupManager(G.ResourceGroupConfig("global", **kw))


def test_coordinator_serves_concurrent_statements(pkg):
    srv = make_server(pkg)
    try:
        assert srv.dispatcher.lanes >= 2  # LocalQueryRunner is cloneable
        qs = [srv.submit(f"select {i} + {i}") for i in range(4)]
        for i, q in enumerate(qs):
            assert q.done.wait(timeout=60)
            assert q.state == "FINISHED", q.error
            assert q.result.rows == [(2 * i,)]
        qids = [e["query_id"] for e in srv.runner.query_history.entries]
        assert len(qids) == len(set(qids))
    finally:
        srv.shutdown()


def test_coordinator_http_shed_429_with_retry_after(pkg):
    client = mod(pkg, "client")
    rg = _groups(pkg, hard_concurrency=1, max_queued=0)
    srv = make_server(pkg, resource_groups=rg)
    try:
        rg.default.acquire()  # hold the only slot
        status, headers, raw = http("POST", base(srv) + "/v1/statement", b"select 1")
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert json.loads(raw)["error"]["errorCode"] == "QUERY_QUEUE_FULL"
        with pytest.raises(client.QueryShed) as ci:
            client.Client(base(srv)).execute("select 1")
        assert ci.value.retryable and ci.value.retry_after_s >= 1
        rg.default.release()
        assert client.Client(base(srv)).execute("select 1 as x")[1] == [(1,)]
    finally:
        srv.shutdown()


def test_server_rejects_when_queue_full(pkg):
    rg = _groups(pkg, hard_concurrency=1, max_queued=0)
    srv = make_server(pkg, resource_groups=rg)
    try:
        rg.default.acquire()
        q = srv.submit("select 1")
        q.done.wait(timeout=5)
        assert q.state == "FAILED" and q.error["errorName"] == "QUERY_QUEUE_FULL"
        assert q.error["errorType"] == "RESOURCE_ERROR" and q.error["retryable"]
        rg.default.release()
        q2 = srv.submit("select 1")
        q2.done.wait(timeout=60)
        assert q2.state == "FINISHED"
    finally:
        srv.shutdown()


def test_client_retries_race_window_shed(pkg):
    client, protocol = mod(pkg, "client"), mod(pkg, "server.protocol")
    polled_error = protocol.query_results("q_1", state="FAILED", error={
        "message": "shed in the race window", "errorName": "QUERY_QUEUE_FULL",
        "retryable": True, "retryAfterSeconds": 0.0,
    })
    ok = protocol.query_results(
        "q_2", columns=[{"name": "x", "type": "bigint"}],
        data=protocol.encode_rows([(1,)]), state="FINISHED",
    )
    responses = [polled_error, ok]
    c = client.Client("http://unused")
    c._request = lambda method, path, body=None: responses.pop(0)
    assert c.execute("select 1", shed_retries=1)[1] == [(1,)]
    responses = [dict(polled_error)]
    with pytest.raises(client.QueryShed):
        c.execute("select 1")


def test_coordinator_queued_time_limit_classified(pkg):
    rg = _groups(pkg, hard_concurrency=1, max_queued=5)
    srv = make_server(pkg, resource_groups=rg)
    srv.runner.properties.set("query_max_queued_time", 0.05)
    try:
        rg.default.acquire()
        q = srv.submit("select 1")
        assert q.done.wait(timeout=10)
        assert q.state == "FAILED"
        assert q.error["errorCode"] == "EXCEEDED_QUEUED_TIME_LIMIT"
        assert q.error["errorType"] == "RESOURCE_ERROR"
        rg.default.release()
    finally:
        srv.shutdown()


def test_coordinator_cancel_while_queued_never_admits(pkg):
    rg = _groups(pkg, hard_concurrency=1, max_queued=5)
    srv = make_server(pkg, resource_groups=rg)
    try:
        rg.default.acquire()
        before = {s["name"]: s["total_admitted"] for s in srv.dispatcher.stats()}
        q = srv.submit("select 1")
        time.sleep(0.05)  # let the statement thread enqueue
        status = http("DELETE", f"{base(srv)}/v1/query/{q.id}")[0]
        assert status == 204
        assert q.done.wait(timeout=10)
        assert q.state == "CANCELED" and q.error["errorCode"] == "USER_CANCELED"
        after = {s["name"]: s["total_admitted"] for s in srv.dispatcher.stats()}
        assert after == before  # never acquired an admission slot
        rg.default.release()
    finally:
        srv.shutdown()


def test_system_resource_groups_table(servers, pkg):
    q = servers[pkg].submit(
        "select name, max_concurrency, weight from system.runtime.resource_groups order by name"
    )
    assert q.done.wait(timeout=60) and q.state == "FINISHED", q.error
    names = [r[0] for r in q.result.rows]
    assert "global" in names and "system.prewarm" in names


def test_shutdown_fails_queued_statements(pkg):
    rg = _groups(pkg, hard_concurrency=1, max_queued=5)
    srv = make_server(pkg, resource_groups=rg)
    rg.default.acquire()
    q = srv.submit("select 1")
    time.sleep(0.05)
    srv.shutdown()
    assert q.done.wait(timeout=10)
    assert q.state == "FAILED" and q.error["errorName"] == "SERVER_SHUTTING_DOWN"
    rg.default.release()


# -- workers: register, detector, HMAC (tests/test_restart.py) -----------------------


def test_register_endpoint_still_400s_for_inprocess_runner(pkg):
    D = mod(pkg, "parallel").DistributedQueryRunner
    kw = {} if pkg == "trino_tpu" else {"device": "cpu"}
    r = D(n_workers=2, schema="tiny", **kw)
    assert not hasattr(r, "add_worker")
    srv = make_server(pkg, runner=r)
    try:
        assert http("PUT", base(srv) + "/v1/worker/register", b"http://127.0.0.1:9")[0] == 400
        assert srv.dispatcher.lanes == 1  # a mesh runner is not cloned
    finally:
        srv.shutdown()


def test_coordinator_start_without_detector_is_fine(pkg):
    srv = make_server(pkg)
    try:
        assert not srv._detector_started
    finally:
        srv.shutdown()
    assert not srv._detector_started


def test_coordinator_register_requires_hmac_when_secret_set(pkg, monkeypatch):
    """With the cluster secret set, register and drain need the body's
    HMAC; a signed register reaches the runner's add_worker."""
    sign_body = mod(pkg, "server.worker").sign_body
    monkeypatch.setenv("TRINO_TPU_CLUSTER_SECRET", "s3cret")
    runner = local_runner(pkg)
    added = []
    runner.add_worker = added.append
    srv = make_server(pkg, runner=runner)
    try:
        body = b"http://127.0.0.1:2"
        assert http("PUT", base(srv) + "/v1/worker/register", body)[0] == 401
        signed = {"X-Cluster-Auth": sign_body(b"s3cret", body)}
        status, _, raw = http("PUT", base(srv) + "/v1/worker/register", body, signed)
        assert status == 200 and json.loads(raw) == {"registered": "http://127.0.0.1:2"}
        assert added == ["http://127.0.0.1:2"]
        assert http("PUT", base(srv) + "/v1/worker/drain", body)[0] == 401
        assert http("PUT", base(srv) + "/v1/worker/drain", body, signed)[0] == 400
    finally:
        srv.shutdown()


# -- the profile archive and the decision ledger over HTTP ---------------------------


@pytest.fixture(scope="module")
def profiled_servers():
    out = {}
    for p in PKGS:
        store_mod = mod(p, "telemetry.profile_store")
        r = local_runner(p)
        store_mod.attach_profile_store(r, store_mod.ProfileStore())
        out[p] = make_server(p, runner=r)
    yield out
    for srv in out.values():
        srv.shutdown()


def test_coordinator_profile_endpoint(profiled_servers, pkg):
    srv = profiled_servers[pkg]
    q = srv.submit("select count(*) from region")
    assert q.done.wait(timeout=60) and q.result.rows == [(5,)]
    status, _, raw = http("GET", f"{base(srv)}/v1/query/{q.id}/profile")
    assert status == 200
    art = json.loads(raw)
    assert art["state"] == "FINISHED"
    assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-9


def test_decisions_endpoint(profiled_servers, pkg):
    srv = profiled_servers[pkg]
    c = mod(pkg, "client").Client(base(srv))
    _, rows = c.execute("select count(*) from region")
    assert [list(x) for x in rows] == [[5]]
    qid = max(srv._queries, key=lambda k: int(k.split("_")[1]))
    status, _, raw = http("GET", f"{base(srv)}/v1/query/{qid}/decisions")
    assert status == 200
    led = json.loads(raw)
    assert led["finalized"] is True and isinstance(led["decisions"], list)
    assert led["unattributed_bytes_by"] == {}
    assert http("GET", f"{base(srv)}/v1/query/nope/decisions")[0] == 404


# -- kernels built once across statement threads -------------------------------------


def test_concurrent_first_statements_build_once(monkeypatch):
    """Two statements whose first launch comes at once, on two statement
    threads, build and load a kernel once: `kernels/build.load` holds its
    lock across the build."""
    from trino_tpu_torch.kernels import build

    calls = []
    gate = threading.Event()

    def slow_build(names):
        calls.append(tuple(names))
        gate.wait(1.0)

    monkeypatch.setattr(build, "build_all", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_LOADED", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.load("grouped_sums")))
               for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert calls == [("grouped_sums",)]
    assert len(got) == 2 and got[0] is got[1]


def test_burst_of_clients_all_served(servers):
    """Twenty-four clients connecting at once are all served: the port's
    listener keeps a backlog for bursts (socketserver's default of 5, which
    the JAX coordinator keeps, resets some of them)."""
    from trino_tpu_torch.client import Client

    srv = servers["trino_tpu_torch"]
    assert srv._httpd.request_queue_size >= 24
    n = 24
    got = [None] * n
    barrier = threading.Barrier(n)

    def one(i):
        barrier.wait()
        got[i] = Client(base(srv)).execute(f"select {i}")[1]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == [[(i,)] for i in range(n)]
