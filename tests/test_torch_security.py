"""Authentication, access control, GRANT/REVOKE and roles in the port
(trino_tpu_torch/server/security.py and the runner's checks in
runtime/runner.py) against the JAX package, on the CPU at tpch.tiny.

  * the security module's units run once per package (`pkg`) with the same
    inputs: the password store and file, Basic credentials, rule-based and
    SQL-standard control, catalog filtering; their denials carry the same
    messages;
  * one sequence of GRANT, REVOKE, CREATE/DROP ROLE, SHOW ROLES and SHOW
    GRANTS gives equal rows (and equal errors) on the JAX LocalQueryRunner,
    the port's LocalQueryRunner and the port's 4-worker mesh;
  * the same RuleBasedAccessControl and SqlStandardAccessControl denials
    raise on both local runners with the same class and message, and what
    they allow gives the same rows;
  * on the mesh, SELECT is unchecked in both packages: the JAX mesh never
    calls `_check_table_access`, and the port keeps that gap; the write
    checks are statement-level and hold on both meshes;
  * `runner_from_etc` with `access-control.config-file` behaves alike;
  * over HTTP, against one secured coordinator per package (a password
    authenticator and rule-based control): a wrong password gets 401, a
    denied CTAS fails with the JAX coordinator's errorName, errorType and
    errorCode and creates no table, and the admin's role and grant
    statements give the JAX rows.
"""

import base64
import json
import urllib.error

import pytest

from test_torch_server import PKGS, base, exchange, http, local_runner, make_server, mod


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def sec(pkg: str):
    return mod(pkg, "server.security")


def outcome(fn):
    """('ok', value) or ('raise', class name, message) of one call."""
    try:
        return ("ok", fn())
    except Exception as e:
        return ("raise", type(e).__name__, str(e))


# -- the security module ---------------------------------------------------------


def test_password_authenticator(pkg):
    auth = sec(pkg).PasswordAuthenticator({"alice": "secret"})
    assert auth.authenticate("alice", "secret")
    assert not auth.authenticate("alice", "wrong")
    assert not auth.authenticate("bob", "secret")


def test_password_file(pkg, tmp_path):
    p = tmp_path / "password.db"
    p.write_text("# users\nalice:s3cret\nbob:hunter2\n\n")
    auth = sec(pkg).PasswordAuthenticator.from_file(str(p))
    assert auth.authenticate("bob", "hunter2") and auth.authenticate("alice", "s3cret")
    assert not auth.authenticate("bob", "nope")


def test_basic_credentials_match_jax():
    headers = [
        None, "Bearer x", "Basic !!!", "Basic " + base64.b64encode(b"alice:wrong").decode(),
        "Basic " + base64.b64encode(b"alice:pw").decode(),
        "Basic " + base64.b64encode(b"nobody:pw").decode(),
    ]
    got = []
    for p in PKGS:
        auth = sec(p).PasswordAuthenticator({"alice": "pw"})
        got.append([outcome(lambda h=h: auth.authenticate_basic(h)) for h in headers])
    assert got[0] == got[1]
    assert got[1][4] == ("ok", "alice")


RULES = [
    {"user": "alice", "catalog": "tpch", "privileges": ["select"]},
    {"user": "bob", "catalog": "memory", "schema": "default", "table": "t.*",
     "privileges": ["SELECT", "INSERT"]},
    {"user": "bob", "catalog": "memory"},
    {"user": "admin", "privileges": ["SELECT", "INSERT", "UPDATE", "DELETE", "OWNERSHIP"]},
]
CHECKS = [
    (m, u, c, s, t)
    for m in ("select", "write", "delete", "update")
    for u in ("alice", "bob", "admin", "eve")
    for c, s, t in (("tpch", "tiny", "nation"), ("memory", "default", "t1"),
                    ("memory", "default", "x"))
]


@pytest.mark.parametrize("query_users", [".*", "alice|admin"])
def test_rule_based_control_matches_jax(query_users):
    got = []
    for p in PKGS:
        ac = sec(p).RuleBasedAccessControl.from_dicts(RULES, query_users=query_users)
        row = [outcome(lambda m=m, a=a: getattr(ac, f"check_can_{m}")(*a)) for m, *a in CHECKS]
        row += [outcome(lambda u=u: ac.check_can_execute_query(u))
                for u in ("alice", "bob", "admin", "eve")]
        row += [ac.filter_catalogs(u, ["memory", "system", "tpch"])
                for u in ("alice", "bob", "admin", "eve")]
        got.append(row)
    assert got[0] == got[1]
    assert ("ok", None) in got[1] and any(o[0] == "raise" for o in got[1][:-4])


def test_rule_based_select_control(pkg):
    S = sec(pkg)
    ac = S.RuleBasedAccessControl([
        S.AccessRule(user="alice", catalog="tpch", privileges=("SELECT",)),
        S.AccessRule(user="admin"),
    ])
    ac.check_can_select("alice", "tpch", "tiny", "nation")
    ac.check_can_write("admin", "memory", "default", "t")
    with pytest.raises(S.AccessDeniedError):
        ac.check_can_select("alice", "memory", "default", "t")  # no rule
    with pytest.raises(S.AccessDeniedError):
        ac.check_can_write("alice", "tpch", "tiny", "nation")  # SELECT only


def test_grant_manager_matches_jax():
    """Roles (transitive membership), grants, owners and the SQL-standard
    control's decisions, step by step, in both packages."""
    def script(S):
        g = S.GrantManager()
        ac = S.SqlStandardAccessControl(g)
        out = []
        steps = [
            lambda: g.create_role("analysts"), lambda: g.create_role("analysts"),
            lambda: g.create_role("readers"), lambda: g.grant_role("readers", "analysts"),
            lambda: g.grant_role("analysts", "alice"), lambda: g.grant_role("nope", "alice"),
            lambda: sorted(g.principals_of("alice")),
            lambda: g.grant("readers", ["select"], "tpch", "tiny", "nation"),
            lambda: g.grant("bob", ["all"], "memory", "default", "t"),
            lambda: g.grant("bob", ["fly"], "memory", "default", "t"),
            lambda: ac.check_can_select("alice", "tpch", "tiny", "nation"),
            lambda: ac.check_can_select("alice", "tpch", "tiny", "region"),
            lambda: ac.check_can_update("bob", "memory", "default", "t"),
            lambda: ac.check_can_write("admin", "tpch", "tiny", "region"),
            lambda: g.set_owner("memory", "default", "u", "carol"),
            lambda: ac.check_can_delete("carol", "memory", "default", "u"),
            lambda: g.grants_for(), lambda: g.grants_for("memory", "default", "t"),
            lambda: g.revoke("bob", ["insert"], "memory", "default", "t"),
            lambda: ac.check_can_write("bob", "memory", "default", "t"),
            lambda: ac.check_can_update("bob", "memory", "default", "t"),
            lambda: g.revoke("bob", ["all"], "memory", "default", "t"),
            lambda: g.revoke_role("analysts", "alice"),
            lambda: ac.check_can_select("alice", "tpch", "tiny", "nation"),
            lambda: g.drop_role("readers"), lambda: g.drop_role("readers"),
            lambda: g.list_roles(), lambda: g.grants_for(),
        ]
        for step in steps:
            out.append(outcome(step))
        return out

    got = [script(sec(p)) for p in PKGS]
    assert got[0] == got[1]


@pytest.mark.parametrize("who", ["user", "alice"])
def test_current_user(pkg, who):
    r = local_runner(pkg, catalog="tpch", schema="tiny", target_splits=2)
    if who != "user":
        r.user = who
    assert r.execute("select current_user").rows == [(who,)]


# -- GRANT, REVOKE and roles through the runners ----------------------------------

ROLE_SEQUENCE = [
    "show roles",
    "create role analysts",
    "create role readers",
    "create role analysts",
    "show roles",
    "grant readers to analysts",
    "grant analysts to alice",
    "grant select on tpch.tiny.nation to readers",
    "grant select, insert on region to bob",
    "grant all on tpch.tiny.orders to carol",
    "grant fly on tpch.tiny.orders to carol",
    "grant analysts to nobody_role_is_fine",
    "grant nope to alice",
    "show grants",
    "show grants on tpch.tiny.orders",
    "show grants on region",
    "revoke insert on region from bob",
    "revoke select on tpch.tiny.lineitem from bob",
    "revoke analysts from alice",
    "revoke nope from alice",
    "show grants",
    "revoke all on tpch.tiny.orders from carol",
    "drop role readers",
    "drop role readers",
    "show roles",
    "show grants",
]


def _jax_mesh():
    from trino_tpu.parallel import DistributedQueryRunner

    return DistributedQueryRunner(n_workers=2, catalog="tpch", schema="tiny")


def _port_mesh():
    from trino_tpu_torch.parallel import DistributedQueryRunner

    return DistributedQueryRunner(n_workers=4, catalog="tpch", schema="tiny", device="cpu")


def _run(runner, sql):
    def go():
        res = runner.execute(sql)
        return res.column_names, [t.name for t in res.types], res.rows

    return outcome(go)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_role_and_grant_sequence_matches_jax(where):
    jax = local_runner("trino_tpu", catalog="tpch", schema="tiny")
    port = local_runner("trino_tpu_torch", catalog="tpch", schema="tiny") if where == "local" \
        else _port_mesh()
    for sql in ROLE_SEQUENCE:
        assert _run(port, sql) == _run(jax, sql), sql
    assert port.grants.list_roles() == ["analysts"]


def test_security_state_shared_with_lanes():
    """The dispatcher's lanes share the grants and the access control; the
    user stays per lane."""
    r = local_runner("trino_tpu_torch")
    lane = r.clone_for_dispatch()
    assert lane.grants is r.grants and lane.access_control is r.access_control
    lane.execute("create role shared")
    assert r.execute("show roles").rows == [("shared",)]
    lane.user = "alice"
    assert r.user == "user"


def rule_control(pkg):
    S = sec(pkg)
    return S.RuleBasedAccessControl([
        S.AccessRule(user="alice", catalog="tpch", table="nation"),
        S.AccessRule(user="reader", privileges=("SELECT",)),
        S.AccessRule(user="writer", catalog="memory", privileges=("SELECT", "INSERT")),
        S.AccessRule(user="admin"),
    ], query_users="alice|reader|writer|admin")


def sql_standard_control(pkg):
    S = sec(pkg)
    return lambda grants: S.SqlStandardAccessControl(grants)


#: (user, statement): run in order on one memory-catalog runner per package
DENIAL_STEPS = {
    "rules": [
        ("alice", "select count(*) from tpch.tiny.nation"),
        ("alice", "select count(*) from tpch.tiny.region"),
        ("alice", "with x as (select * from tpch.tiny.region) select count(*) from x"),
        ("alice", "select n_name from tpch.tiny.nation where n_regionkey in "
                  "(select r_regionkey from tpch.tiny.region)"),
        ("eve", "select 1"),
        ("admin", "create table t (x bigint)"),
        ("admin", "insert into t values (1), (2)"),
        ("reader", "create table u (x bigint)"),
        ("reader", "select count(*) from t"),
        ("reader", "insert into t values (3)"),
        ("writer", "insert into t values (3)"),
        ("writer", "delete from t where x = 1"),
        ("writer", "update t set x = 5"),
        ("writer", "merge into t using (select 2 k) s on t.x = s.k when matched then delete"),
        ("writer", "alter table t add column y bigint"),
        ("writer", "drop table t"),
        ("admin", "create view v as select x from t"),
        ("reader", "select * from v"),
        ("admin", "drop table t"),
        ("admin", "drop table if exists t"),
        ("writer", "drop table if exists nothing_here"),
    ],
    "sql_standard": [
        ("alice", "create table t (x bigint)"),
        ("admin", "create table t (x bigint)"),
        ("admin", "insert into t values (1), (2)"),
        ("alice", "select * from t"),
        ("admin", "grant select on t to analysts"),
        ("admin", "create role analysts"),
        ("admin", "grant analysts to alice"),
        ("alice", "select count(*) from t"),
        ("alice", "insert into t values (3)"),
        ("bob", "create table b as select 1 x"),
        ("admin", "grant insert on b to bob"),
        ("bob", "create table b as select 1 x"),
        ("bob", "insert into b values (2)"),
        ("bob", "select count(*) from b"),
        ("bob", "alter table b rename to b2"),
        ("admin", "show grants"),
        ("admin", "revoke analysts from alice"),
        ("alice", "select count(*) from t"),
        ("carol", "update t set x = 0"),
        ("admin", "grant update on t to carol"),
        ("carol", "update t set x = 0"),
        ("carol", "delete from t"),
    ],
}


@pytest.mark.parametrize("control", list(DENIAL_STEPS))
def test_access_denials_match_jax(control):
    runners = {}
    for p in PKGS:
        r = local_runner(p, catalog="memory", schema="default")
        r.access_control = rule_control(p) if control == "rules" else \
            sql_standard_control(p)(r.grants)
        runners[p] = r
    seen = set()
    for user, sql in DENIAL_STEPS[control]:
        got = {}
        for p, r in runners.items():
            r.user = user
            got[p] = _run(r, sql)
        assert got["trino_tpu_torch"] == got["trino_tpu"], (user, sql)
        seen.add(got["trino_tpu"][:2] if got["trino_tpu"][0] == "raise" else "ok")
    assert "ok" in seen and ("raise", "AccessDeniedError") in seen
    tables = [r.execute("show tables").rows for r in runners.values()]
    assert tables[0] == tables[1]


def test_mesh_select_unchecked_like_jax():
    """The reference gap the port keeps: the mesh does not check SELECT (the
    local runners do); the write check is the statement's and holds."""
    from trino_tpu.server.security import AccessDeniedError as JDenied
    from trino_tpu_torch.server.security import AccessDeniedError as TDenied

    rows = {}
    for p, mesh in (("trino_tpu", _jax_mesh()), ("trino_tpu_torch", _port_mesh())):
        mesh.access_control = rule_control(p)
        mesh.user = "alice"
        rows[p] = mesh.execute("select count(*) from tpch.tiny.region").rows
        mesh.user = "reader"
        with pytest.raises(JDenied if p == "trino_tpu" else TDenied,
                           match="lacks INSERT on memory.default.t"):
            mesh.execute("create table memory.default.t (x bigint)")
        mesh.user = "eve"
        with pytest.raises(JDenied if p == "trino_tpu" else TDenied,
                           match="cannot execute queries"):
            mesh.execute("select 1")
    assert rows["trino_tpu_torch"] == rows["trino_tpu"] == [(5,)]
    for p in PKGS:
        r = local_runner(p, catalog="tpch", schema="tiny")
        r.access_control = rule_control(p)
        r.user = "alice"
        with pytest.raises(Exception, match="lacks SELECT on tpch.tiny.region"):
            r.execute("select count(*) from tpch.tiny.region")


def test_runner_enforces_access_control(pkg):
    S = sec(pkg)
    r = local_runner(pkg, catalog="tpch", schema="tiny")
    r.access_control = S.RuleBasedAccessControl(
        [S.AccessRule(user="alice", catalog="tpch", table="nation")]
    )
    r.user = "alice"
    assert r.execute("select count(*) from nation").rows == [(25,)]
    with pytest.raises(S.AccessDeniedError):
        r.execute("select count(*) from region")
    with pytest.raises(S.AccessDeniedError):
        r.execute("with x as (select * from region) select count(*) from x")


def test_runner_blocks_writes(pkg):
    S = sec(pkg)
    r = local_runner(pkg, catalog="memory", schema="default")
    r.access_control = S.RuleBasedAccessControl(
        [S.AccessRule(user="reader", privileges=("SELECT",))]
    )
    r.user = "reader"
    with pytest.raises(S.AccessDeniedError):
        r.execute("create table t (x bigint)")
    assert r.execute("show tables").rows == []


def _write_etc(tmp_path, name: str) -> str:
    etc = tmp_path / name
    (etc / "catalog").mkdir(parents=True)
    rules = tmp_path / f"{name}_rules.json"
    rules.write_text(json.dumps({"tables": [
        {"user": "user", "catalog": "tpch", "table": "nation", "privileges": ["SELECT"]},
        {"user": "user", "catalog": "memory", "privileges": ["SELECT", "INSERT"]},
    ]}))
    (etc / "config.properties").write_text(
        f"default.catalog=tpch\ndefault.schema=tiny\naccess-control.config-file={rules}\n")
    (etc / "catalog" / "tpch.properties").write_text("connector.name=tpch\n")
    (etc / "catalog" / "memory.properties").write_text("connector.name=memory\n")
    return str(etc)


def test_runner_from_etc_access_control_matches_jax(tmp_path):
    got = {}
    for p in PKGS:
        cfg = mod(p, "runtime.config")
        etc = _write_etc(tmp_path, p)
        try:
            r = cfg.runner_from_etc(etc) if p == "trino_tpu" else cfg.runner_from_etc(
                etc, device="cpu")
            assert type(r.access_control).__name__ == "RuleBasedAccessControl"
            got[p] = [_run(r, sql) for sql in (
                "select count(*) from nation", "select count(*) from region",
                "create table memory.default.t as select n_name from nation",
                "select count(*) from memory.default.t", "delete from memory.default.t",
            )]
        finally:
            mod(p, "config").reset_config()
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    assert got["trino_tpu_torch"][0] == ("ok", (["count"], ["bigint"], [(25,)]))
    assert got["trino_tpu_torch"][1][:2] == ("raise", "AccessDeniedError")


# -- over HTTP -----------------------------------------------------------------------


def basic(user: str, password: str) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


@pytest.fixture(scope="module")
def secured():
    out = {}
    for p in PKGS:
        S = sec(p)
        runner = local_runner(p, catalog="tpch", schema="tiny")
        out[p] = make_server(
            p, runner=runner,
            authenticator=S.PasswordAuthenticator({"alice": "pw-a", "admin": "pw-b"}),
            access_control=S.RuleBasedAccessControl.from_dicts([
                {"user": "alice", "catalog": "tpch", "privileges": ["SELECT"]},
                {"user": "admin", "privileges": ["SELECT", "INSERT", "UPDATE", "DELETE",
                                                 "OWNERSHIP"]},
            ]),
        )
    yield out
    for srv in out.values():
        srv.shutdown()


def test_coordinator_basic_auth(secured, pkg):
    url = base(secured[pkg])
    assert http("POST", url + "/v1/statement", b"select 1")[0] == 401
    status, _, raw = http("POST", url + "/v1/statement", b"select 1", basic("alice", "wrong"))
    assert status == 401 and json.loads(raw)["error"]["errorName"] == "AUTHENTICATION_FAILED"
    status, _, raw = http("POST", url + "/v1/statement", b"select 1", basic("alice", "pw-a"))
    assert status == 200
    assert json.loads(raw)["stats"]["state"] in ("QUEUED", "RUNNING", "FINISHED")
    for method, path in (("GET", "/ui/api/query"), ("GET", "/ui/"),
                         ("GET", "/v1/statement/executing/x/0"), ("GET", "/v1/metrics"),
                         ("DELETE", "/v1/query/q_1"), ("PUT", "/v1/worker/register")):
        assert http(method, url + path)[0] == 401, path
    stats = json.loads(http("GET", url + "/ui/api/stats", headers=basic("alice", "pw-a"))[2])
    assert stats["totalQueries"] >= 1


#: (user, SQL) over HTTP, in order
SECURED_EXCHANGES = [
    ("alice", "select count(*), sum(n_regionkey) from nation"),
    ("alice", "select current_user"),
    ("alice", "create table memory.default.t as select * from nation"),
    ("alice", "select count(*) from system.runtime.nodes"),
    ("admin", "show tables from memory.default"),
    ("admin", "create role analysts"),
    ("admin", "grant select on tpch.tiny.nation to analysts"),
    ("admin", "grant analysts to alice"),
    ("admin", "show grants"),
    ("admin", "show grants on tpch.tiny.nation"),
    ("admin", "revoke select on tpch.tiny.nation from analysts"),
    ("admin", "show grants"),
    ("admin", "show roles"),
    ("admin", "drop role analysts"),
    ("admin", "show roles"),
]


def test_secured_exchanges_match_jax(secured):
    passwords = {"alice": "pw-a", "admin": "pw-b"}
    for user, sql in SECURED_EXCHANGES:
        got = {p: exchange(p, base(srv), sql, basic(user, passwords[user]))
               for p, srv in secured.items()}
        want, mine = got["trino_tpu"], got["trino_tpu_torch"]
        assert mine["statuses"] == want["statuses"] == {200}, (user, sql)
        assert mine["columns"] == want["columns"] and mine["rows"] == want["rows"], (user, sql)
        assert (mine["error"] is None) == (want["error"] is None), (user, sql, mine["error"])
        if want["error"] is not None:
            keys = ("message", "errorName", "errorType", "errorCode")
            assert {k: mine["error"][k] for k in keys} == {k: want["error"][k] for k in keys}
        if sql.startswith("create table"):
            assert mine["error"]["errorName"] == "AccessDeniedError"
        if sql.startswith("show tables"):
            assert mine["rows"] == []  # the denied CTAS created nothing


def test_client_credentials_and_proxy(secured):
    """The port's Client and dbapi.connect send Basic credentials, and its
    proxy forwards them (the JAX client sends none, and the JAX proxy drops
    the header, so its backend answers 401 through it)."""
    from trino_tpu_torch import dbapi
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.server.proxy import ProxyServer

    url = base(secured["trino_tpu_torch"])
    assert Client(url, user="alice", password="pw-a").execute(
        "select count(*) from nation")[1] == [(25,)]
    with pytest.raises(urllib.error.HTTPError) as ei:
        Client(url, user="alice", password="nope").execute("select 1")
    assert ei.value.code == 401
    cur = dbapi.connect(url, user="admin", password="pw-b").cursor()
    assert cur.execute("select current_user").fetchall() == [("admin",)]
    with pytest.raises(dbapi.DatabaseError, match="401"):
        dbapi.connect(url, user="admin", password="pw-a").cursor().execute("select 1")
    proxies = {p: mod(p, "server.proxy").ProxyServer(base(secured[p])).start() for p in PKGS}
    try:
        assert isinstance(proxies["trino_tpu_torch"], ProxyServer)
        assert Client(proxies["trino_tpu_torch"].url, user="alice", password="pw-a").execute(
            "select n_name from nation where n_nationkey = 1")[1] == [("ARGENTINA",)]
        status = http("POST", proxies["trino_tpu"].url + "/v1/statement", b"select 1",
                      basic("alice", "pw-a"))[0]
        assert status == 401
    finally:
        for proxy in proxies.values():
            proxy.shutdown()
