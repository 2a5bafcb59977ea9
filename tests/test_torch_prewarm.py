"""The port's restart prewarm against the JAX package's: the workload
manifest, the prewarm executor, its `system.prewarm` admission, the
`prewarm` and `dictionary` config sections, and the start and grow
replays.

The prewarm cases of tests/test_restart.py (the manifest round trip,
record/filter/dedup, `save` never clobbering an operator's manifest, the
restarted process's closure, dictionary codes from the manifest, the grow
at a new mesh signature, `prewarm.on-grow`, the multi-host `add_worker`
kick, unclosed and failed replays, a kick racing a live replay, the
coordinator's prewarm on start and the adopted executor), the
system-admission case of tests/test_dispatcher.py, the manifest cases of
tests/test_dictionary_service.py and the lock pair of
tests/test_concurrency.py.  Each case runs the same statements through
both packages' executors and compares their states, replay counts,
`verify_events`, metric deltas, the manifest's JSON keys and the rows.
A port "restart" clears the step cache (parallel/spmd.TRACE_CACHE) and
forgets the loaded kernel libraries (kernels/build.unload_all); on the
CPU there are no kernel loads, so the step cache is the only source of
compile events.
"""

import importlib
import json
import threading
import time

import pytest

from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)

PKGS = ("trino_tpu", "trino_tpu_torch")

SQL = "select count(*) from region"

#: a varchar group-by: its dictionary rides the manifest
VSQL = "select o_orderpriority, count(*) from orders group by o_orderpriority"

#: a join with one integer key per side: the speculative capacity path
JSQL = (
    "select n_name, count(*) from nation join region "
    "on n_regionkey = r_regionkey group by n_name"
)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        mod(p, "config").reset_config()
        mod(p, "runtime.retry").BREAKERS.reset()
    yield
    for p in PKGS:
        mod(p, "config").reset_config()
        mod(p, "runtime.retry").BREAKERS.reset()


def install(pkg: str, props: dict) -> None:
    C = mod(pkg, "config")
    C.install_config(C.load_cluster_config(props, env={}))


def mesh(pkg: str, n: int):
    if pkg == "trino_tpu":
        from trino_tpu.parallel import DistributedQueryRunner

        return DistributedQueryRunner(n_workers=n, schema="tiny")
    from trino_tpu_torch.parallel import DistributedQueryRunner

    return DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=n, device="cpu")


def local(pkg: str):
    if pkg == "trino_tpu":
        from trino_tpu.runtime.runner import LocalQueryRunner

        return LocalQueryRunner(catalog="tpch", schema="tiny")
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    return LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")


def restart(pkg: str) -> None:
    """What dies with the process: the step (trace) cache and, in the
    port, the loaded kernel libraries."""
    mod(pkg, "parallel.spmd").TRACE_CACHE.clear()
    if pkg == "trino_tpu_torch":
        from trino_tpu_torch.kernels import build

        build.unload_all()


def observatory(pkg: str):
    return mod(pkg, "telemetry.compile_events").OBSERVATORY


class Meter:
    """The prewarm metric family's deltas over a block."""

    CELLS = [(r, o) for r in ("start", "grow", "manual")
             for o in ("warm", "unclosed", "failed", "empty")]

    def __init__(self, pkg: str):
        self.m = mod(pkg, "telemetry.metrics")
        self.before = self._read()

    def _read(self):
        runs = self.m.prewarm_runs_counter()
        return (
            {c: runs.labels(*c).value() for c in self.CELLS},
            self.m.prewarm_statements_counter().value(),
        )

    def delta(self) -> dict:
        runs, stmts = self._read()
        out = {c: runs[c] - self.before[0][c] for c in self.CELLS}
        return {
            "runs": {f"{r}/{o}": v for (r, o), v in out.items() if v},
            "statements": stmts - self.before[1],
            "state": self.m.prewarm_state_gauge().value(),
        }


def executor_view(ex) -> dict:
    return {
        "state": ex.state,
        "runs": ex.runs,
        "verify_events": ex.verify_events,
        "watermark_taken": ex.watermark is not None,
        "last_error": ex.last_error,
    }


@pytest.fixture(scope="module")
def mesh2():
    return {p: mesh(p, 2) for p in PKGS}


# -- the config sections ------------------------------------------------------


def test_config_sections_resolve_env_and_props(pkg):
    C = mod(pkg, "config")
    cfg = C.ClusterConfig()
    assert cfg.prewarm.manifest_path == "" and cfg.prewarm.on_start and cfg.prewarm.on_grow
    assert cfg.dictionary.max_inline_values == 1 << 16
    cfg = C.load_cluster_config(
        {"prewarm.manifest-path": "/m.json", "prewarm.on-start": "false",
         "prewarm.on-grow@tpch": "false"},
        env={"TRINO_TPU_PREWARM_ON_START": "true", "TRINO_TPU_DICTIONARY_MAX_INLINE_VALUES": "7"},
    )
    assert cfg.prewarm.manifest_path == "/m.json" and cfg.prewarm.on_start is True
    assert cfg.dictionary.max_inline_values == 7
    assert cfg.prewarm.on_grow is True
    assert cfg.section_for("prewarm", catalog="tpch").on_grow is False
    with pytest.raises(ValueError, match="prewarm.on-grow"):
        C.load_cluster_config({"prewarm.on-grow": "sometimes"}, env={})


# -- the workload manifest ------------------------------------------------------


def test_manifest_save_load_roundtrip(pkg, tmp_path):
    P = mod(pkg, "runtime.prewarm")
    loc = str(tmp_path / "m.json")
    m = P.WorkloadManifest(
        statements=[SQL], cap_history=[{"key": "('a',)", "cap": 8}],
        watermark=7, closed=True, workers=2,
    )
    P.save_manifest(m, loc, extra={"schema": "tiny"})
    got = P.load_manifest(loc)
    assert got.statements == [SQL] and got.watermark == 7
    assert got.closed is True and got.workers == 2
    with open(loc) as fh:
        doc = json.load(fh)
    assert doc["schema"] == "tiny" and doc["sql"] == [SQL]


def test_manifest_documents_equal_and_cross_load(tmp_path):
    """One manifest, written by each package: the same JSON document, and
    each package loads the other's."""
    docs = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        m = P.WorkloadManifest(
            statements=[SQL, VSQL], cap_history=[{"key": "('j',)", "cap": 2048}],
            watermark=3, closed=None, workers=4,
            compile_keys=[{"step": "chain", "buckets": [1024]}],
            dictionaries={"version": 1, "entries": []},
        )
        P.save_manifest(m, str(tmp_path / f"{p}.json"))
        docs[p] = json.loads((tmp_path / f"{p}.json").read_text())
    assert docs["trino_tpu"] == docs["trino_tpu_torch"]
    assert sorted(docs["trino_tpu"]) == [
        "cap_history", "closed", "dictionaries", "manifest", "sql", "version",
        "watermark", "workers",
    ]
    for reader, writer in (("trino_tpu", "trino_tpu_torch"), ("trino_tpu_torch", "trino_tpu")):
        got = mod(reader, "runtime.prewarm").load_manifest(str(tmp_path / f"{writer}.json"))
        assert got.to_json() == docs[writer]


def test_manifest_load_is_tolerant(pkg, tmp_path):
    P = mod(pkg, "runtime.prewarm")
    (tmp_path / "m.json").write_text('{"sql": ["select 1"]}')
    got = P.load_manifest(str(tmp_path / "m.json"))
    assert got.statements == ["select 1"] and got.watermark == 0
    assert P.load_manifest(str(tmp_path / "missing.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert P.load_manifest(str(tmp_path / "bad.json")) is None


def test_replay_limits_equal_jax():
    got = [
        (P.RECORD_LIMIT, P.MAX_CAPACITY_ROUNDS, P.MANIFEST_VERSION)
        for P in (mod(p, "runtime.prewarm") for p in PKGS)
    ]
    assert got[0] == got[1]
    statements = ["select 1", " WITH t as (select 1) select * from t", "values 1",
                  "table nation", "set session x = 1", "insert into t values 1",
                  "explain select 1", "create table t as select 1"]
    flags = [[mod(p, "runtime.prewarm")._is_replayable(s) for s in statements] for p in PKGS]
    assert flags[0] == flags[1] == [True, True, True, True, False, False, False, False]


def test_record_filters_and_dedups(tmp_path):
    got = {}
    for p in PKGS:
        class _R:
            pass

        ex = mod(p, "runtime.prewarm").PrewarmExecutor(_R(), str(tmp_path / f"{p}.json"))
        flags = [
            ex.record(SQL), ex.record(SQL),
            ex.record("  WITH t as (select 1) select * from t"),
            ex.record("set session query_trace = false"),
            ex.record("insert into t values (1)"),
        ]
        got[p] = (flags, ex.manifest().statements)
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    assert got["trino_tpu_torch"] == (
        [True, False, True, False, False],
        [SQL, "  WITH t as (select 1) select * from t"],
    )


def test_record_limit_bounds_the_replay_set(pkg):
    P = mod(pkg, "runtime.prewarm")

    class _R:
        pass

    ex = P.PrewarmExecutor(_R(), None)
    added = sum(ex.record(f"select {i}") for i in range(P.RECORD_LIMIT + 5))
    assert added == P.RECORD_LIMIT == len(ex.manifest().statements)


def test_save_never_clobbers_operator_manifest(tmp_path):
    got = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        P.save_manifest(P.WorkloadManifest(statements=[SQL, "select 9"]), loc)

        class _R:
            pass

        ex = P.PrewarmExecutor(_R(), loc)
        first = ex.save()  # nothing recorded: the seed survives intact
        seed = P.load_manifest(loc).statements
        ex.record("select 10")
        second = ex.save()
        got[p] = (first, seed, second, P.load_manifest(loc).statements,
                  P.PrewarmExecutor(_R(), None).save())
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    assert got["trino_tpu_torch"][3] == [SQL, "select 9", "select 10"]


def test_manifest_carries_and_restores_dictionaries():
    """tests/test_dictionary_service.py's manifest cases on both packages:
    the snapshot document rides the manifest and restores the codes."""
    key = ("tpch", "tiny", "t", "c")
    for p in PKGS:
        D = mod(p, "runtime.dictionary_service")
        SD = mod(p, "columnar").StringDictionary
        P = mod(p, "runtime.prewarm")
        svc = D.GlobalDictionaryService()
        svc.register(*key, SD(["a", "b"]), unique=True)
        m = P.WorkloadManifest(statements=["select 1"], dictionaries=svc.snapshot_doc())
        back = P.WorkloadManifest.from_json(m.to_json())
        assert back.dictionaries == m.dictionaries
        fresh = D.GlobalDictionaryService()
        assert fresh.load_doc(back.dictionaries) == 1
        assert tuple(fresh.resolve(key, 1).values) == ("a", "b")
        doc = P.WorkloadManifest(statements=["select 1"]).to_json()
        doc.pop("dictionaries", None)
        assert P.WorkloadManifest.from_json(doc).dictionaries is None


# -- the restart-closure bar ------------------------------------------------------


@pytest.fixture
def saved_dictionaries():
    """A restart resets the global dictionary service: the assignments
    other tests of this process registered come back afterwards."""
    attrs = ("_entries", "_latest", "_by_fp", "_adopt")
    saved = []
    for p in PKGS:
        svc = mod(p, "runtime.dictionary_service").DICTIONARY_SERVICE
        with svc._lock:
            saved.append((svc, {a: dict(getattr(svc, a)) for a in attrs}))
    yield
    for svc, state in saved:
        with svc._lock:
            for a, v in state.items():
                getattr(svc, a).clear()
                getattr(svc, a).update(v)


def _restart_closure(p: str, tmp_path, first, sql: str) -> dict:
    """Record and save on `first`, "restart", replay on a fresh mesh, then
    run the statement for real: the executor's view, the metric deltas,
    the compile events of the first real run and its rows."""
    P = mod(p, "runtime.prewarm")
    loc = str(tmp_path / f"{p}.json")
    rows = sorted(first.execute(sql).rows)
    ex = P.PrewarmExecutor(first, loc)
    ex.record(sql)
    assert ex.save() is True
    doc = json.loads((tmp_path / f"{p}.json").read_text())
    restart(p)
    restarted = mesh(p, 2)
    meter = Meter(p)
    obs = observatory(p)
    cold = obs.mark()
    ex2 = P.attach_prewarm(restarted, loc)
    assert restarted.prewarm is ex2
    ex2.run(reason="start", wait=True)
    view = executor_view(ex2)
    mark = obs.mark()
    again = sorted(restarted.execute(sql).rows)
    return {
        "executor": view,
        "metrics": meter.delta(),
        "above": obs.mark() - mark,
        "rows": (rows, again),
        "keys": sorted(doc),
        "statements": doc["sql"],
        "workers": doc["workers"],
        # the replay itself built the restarted process's steps
        "replay_built": ex2.watermark > cold,
    }


def test_restarted_process_prewarm_closure(tmp_path, mesh2):
    """Kill-and-restart: the first incarnation records and saves a
    manifest, the step cache dies, the restarted incarnation replays it to
    WARM and its first real query records zero compile events above the
    closure watermark, in both packages."""
    got = {p: _restart_closure(p, tmp_path, mesh2[p], SQL) for p in PKGS}
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    port = got["trino_tpu_torch"]
    assert port["executor"]["state"] == "WARM" and port["executor"]["verify_events"] == 0
    assert port["above"] == 0 and port["rows"] == ([(5,)], [(5,)])
    assert port["replay_built"]
    assert port["metrics"] == {"runs": {"start/warm": 1}, "statements": 2, "state": 2}


def test_restart_resolves_dictionary_codes_from_manifest(tmp_path, mesh2, saved_dictionaries):
    """The manifest carries the versioned code assignment; the restarted
    process adopts it BEFORE replaying, and a warm varchar statement then
    records zero compile events above the watermark."""
    got = {}
    for p in PKGS:
        D = mod(p, "runtime.dictionary_service").DICTIONARY_SERVICE
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        mesh2[p].execute(VSQL)
        ex = P.PrewarmExecutor(mesh2[p], loc)
        ex.record(VSQL)
        assert ex.save() is True
        m = P.load_manifest(loc)
        # the snapshot holds every dictionary this process registered
        # (other tests' too): only the statement's own is compared
        carried = ("tpch", "tiny", "orders", "o_orderpriority") in {
            tuple(e["key"]) for e in m.dictionaries["entries"]}
        restart(p)
        D.reset()
        restarted = mesh(p, 2)
        ex2 = P.attach_prewarm(restarted, loc)
        ex2.run(reason="start", wait=True)
        versions = D.stats()["versions"]
        obs = observatory(p)
        mark = obs.mark()
        rows = sorted(restarted.execute(VSQL).rows)
        got[p] = {
            "executor": executor_view(ex2),
            "carried": carried,
            "readopted": versions > 0,
            "above": obs.mark() - mark,
            "rows": rows,
        }
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    port = got["trino_tpu_torch"]
    assert port["executor"]["state"] == "WARM" and port["readopted"]
    assert port["above"] == 0 and len(port["rows"]) == 5
    assert port["carried"]


def test_grow_prewarms_at_new_mesh_signature(tmp_path):
    """After the mesh grows, the kicked replay builds the manifest at the
    NEW mesh signature, so the next query builds nothing even though every
    step-cache key changed; a join's learned capacity rides along."""
    got = {}
    for p in PKGS:
        S = mod(p, "parallel.spmd")
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        runner = mesh(p, 2)
        runner.execute(SQL)
        runner.execute(JSQL)
        ex = P.attach_prewarm(runner, loc)
        ex.record(SQL)
        ex.record(JSQL)
        ex.save()
        meter = Meter(p)
        out = []
        for w in (3, 4):
            old = S.mesh_key(runner.wm)
            grown = observatory(p).mark()
            runner.resize_mesh(w)
            assert runner.wm.n == w and S.mesh_key(runner.wm) != old
            t = ex._thread
            assert t is not None, "grow must kick a background prewarm"
            t.join(timeout=120)
            obs = observatory(p)
            mark = obs.mark()
            rows = [sorted(runner.execute(s).rows) for s in (SQL, JSQL)]
            # the kicked replay built the new signature's steps
            assert ex.watermark > grown
            out.append((executor_view(ex), obs.mark() - mark, rows))
        got[p] = (out, meter.delta())
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    out, metrics = got["trino_tpu_torch"]
    assert [(v["state"], above) for v, above, _ in out] == [("WARM", 0), ("WARM", 0)]
    assert metrics["runs"] == {"grow/warm": 2}


def test_grow_respects_on_grow_knob(tmp_path):
    got = {}
    for p in PKGS:
        install(p, {"prewarm.on-grow": "false"})
        runner = mesh(p, 2)
        ex = mod(p, "runtime.prewarm").attach_prewarm(runner, str(tmp_path / f"{p}.json"))
        runner.resize_mesh(3)
        got[p] = (ex._thread, ex.state, runner.wm.n)
    assert got["trino_tpu"] == got["trino_tpu_torch"] == (None, "IDLE", 3)


def test_attach_without_location_is_a_no_op(pkg):
    class _R:
        pass

    r = _R()
    assert mod(pkg, "runtime.prewarm").attach_prewarm(r) is None
    assert not hasattr(r, "prewarm")
    assert mod(pkg, "runtime.prewarm").kick_grow_prewarm(r) is None


def test_multihost_add_worker_kicks_prewarm():
    """The multi-host grow path consults the same hook (registration is
    coordinator-local: no HTTP), and `prewarm.on-grow=false` stops it."""
    got = {}
    for p in PKGS:
        R = mod(p, "parallel.remote")
        kw = {} if p == "trino_tpu" else {"device": "cpu"}
        kicked = []

        class _Stub:
            def run(self, reason="manual", **k):
                kicked.append(reason)

        mh = R.MultiHostQueryRunner(["http://127.0.0.1:1"], schema="tiny", **kw)
        mh.prewarm = _Stub()
        mh.add_worker("http://127.0.0.1:2")
        state = mh.membership.state("http://127.0.0.1:2")
        install(p, {"prewarm.on-grow": "false"})
        mh.add_worker("http://127.0.0.1:3")
        got[p] = (kicked, state, list(mh.worker_urls))
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    assert got["trino_tpu_torch"][:2] == (["grow"], "ACTIVE")


def test_multihost_grow_replays_real_executor(tmp_path):
    """An attached executor on the port's multi-host runner replays its
    manifest after add_worker and records the workers it saw."""
    from trino_tpu_torch.parallel.remote import MultiHostQueryRunner
    from trino_tpu_torch.runtime.prewarm import attach_prewarm, save_manifest, WorkloadManifest

    class _Runner(MultiHostQueryRunner):
        def execute(self, sql):
            self.replayed.append(sql)

    loc = str(tmp_path / "m.json")
    save_manifest(WorkloadManifest(statements=[SQL]), loc)
    mh = _Runner(["http://127.0.0.1:1"], schema="tiny", device="cpu")
    mh.replayed = []
    ex = attach_prewarm(mh, loc)
    mh.add_worker("http://127.0.0.1:2")
    ex._thread.join(timeout=30)
    assert ex.state == "WARM" and mh.replayed == [SQL, SQL]
    assert ex.manifest().workers == 2


# -- the executor's state machine -------------------------------------------------


def _leaky(p: str):
    obs = observatory(p)

    class _Runner:
        def execute(self, sql):
            # every execution records a fresh compile event: never closes
            obs.abort(obs.open_miss(("spmd", False, False, (1,), "leaky", sql)))

    return _Runner()


def _failing(p: str):
    class _Runner:
        def execute(self, sql):
            raise RuntimeError("boom")

    return _Runner()


def _empty(p: str):
    class _Runner:
        def execute(self, sql):
            raise AssertionError("nothing to replay")

    return _Runner()


@pytest.mark.parametrize("case", ["unclosed", "failed", "empty"])
def test_executor_outcomes_equal_jax(case, tmp_path):
    """A replay that still builds on the verify pass is UNCLOSED (never
    WARM), one that raises is FAILED, and an empty manifest is IDLE."""
    got = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        runner = {"unclosed": _leaky, "failed": _failing, "empty": _empty}[case](p)
        meter = Meter(p)
        if case == "empty":
            ex = P.PrewarmExecutor(runner, str(tmp_path / "missing.json"))
            ex.run(wait=True)
        else:
            ex = P.PrewarmExecutor(runner, None)
            ex.run(statements=["select 1"], wait=True)
        got[p] = (executor_view(ex), meter.delta())
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    view, metrics = got["trino_tpu_torch"]
    assert view["state"] == {"unclosed": "UNCLOSED", "failed": "FAILED", "empty": "IDLE"}[case]
    if case == "unclosed":
        assert view["verify_events"] == 1
    if case == "failed":
        assert "boom" in view["last_error"]
    assert metrics["runs"] == {
        "unclosed": {"manual/unclosed": 1},
        "failed": {"manual/failed": 1},
        "empty": {"manual/empty": 1},
    }[case]


def test_run_queues_kick_racing_live_replay():
    """A grow kick racing an in-flight replay is QUEUED and runs after it,
    never dropped."""
    got = {}
    for p in PKGS:
        gate = threading.Event()
        ran = []

        class _Runner:
            def execute(self, sql):
                ran.append(sql)
                gate.wait(timeout=10.0)

        ex = mod(p, "runtime.prewarm").PrewarmExecutor(_Runner(), None, verify=False)
        t1 = ex.run(reason="start", statements=["select 1"])
        deadline = time.monotonic() + 5.0
        while not ran and time.monotonic() < deadline:
            time.sleep(0.001)
        assert ran, "first replay must be in flight"
        ex.run(reason="grow", statements=["select 2"])
        # a second kick while the first waits: the latest wins
        ex.run(reason="grow", statements=["select 3"])
        gate.set()
        t1.join(timeout=10.0)
        with ex._state_lock:
            follow = ex._thread
        assert follow is not None and follow is not t1
        follow.join(timeout=10.0)
        got[p] = (ran, ex.runs, ex.state)
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    assert got["trino_tpu_torch"] == (["select 1", "select 3"], 2, "WARM")


def test_wait_joins_the_queued_follow_up():
    """The port's `wait(timeout)`: False while a replay is held, then True
    only once the kick queued behind it has run too."""
    from trino_tpu_torch.runtime.prewarm import PrewarmExecutor

    gate = threading.Event()
    ran = []

    class _Runner:
        def execute(self, sql):
            ran.append(sql)
            gate.wait(timeout=10.0)

    ex = PrewarmExecutor(_Runner(), None, verify=False)
    assert ex.wait(0.0)
    ex.run(reason="start", statements=["select 1"])
    ex.run(reason="grow", statements=["select 2"])
    assert not ex.wait(0.05)
    gate.set()
    assert ex.wait(10.0)
    assert (ran, ex.runs, ex.state) == (["select 1", "select 2"], 2, "WARM")


def test_engine_locks_compose_acyclically():
    """tests/test_concurrency.py's lock pair on the port: the replay takes
    the engine lock, then the state lock, and the order graph stays
    acyclic."""
    from trino_tpu_torch.runtime.lifecycle import QueryTracker
    from trino_tpu_torch.runtime.prewarm import PrewarmExecutor
    from trino_tpu_torch.verify.lockgraph import LockGraph, instrument_attr

    g = LockGraph()

    class _Runner:
        def execute(self, sql):
            return None

    pw = PrewarmExecutor(_Runner(), manifest_location=None, verify=False)
    instrument_attr(pw, "_engine_lock", "prewarm.engine", g)
    instrument_attr(pw, "_state_lock", "prewarm.state", g)
    pw.record("select 1")
    pw.run(statements=["select 1"], wait=True)
    tracker = QueryTracker()
    instrument_attr(tracker, "_lock", "tracker", g)
    ctx = tracker.create("q1")
    instrument_attr(ctx, "_lock", "query", g)
    ctx.begin()
    ctx.finish()
    tracker.remove(ctx)
    g.assert_acyclic()
    assert ("prewarm.engine", "prewarm.state") in g.edges()


# -- admission and serving ----------------------------------------------------------


def test_replay_admits_through_system_prewarm_group():
    """tests/test_dispatcher.py's case with a real replay: an executor that
    adopted the dispatcher's admission replays on the primary lane through
    the system.prewarm group while a user statement takes the other lane."""
    got = {}
    for p in PKGS:
        D = mod(p, "runtime.dispatcher")
        RG = mod(p, "runtime.resource_groups")
        gate = threading.Event()
        inside = threading.Event()

        class _Runner:
            def clone_for_dispatch(self):
                return _Runner()

            def execute(self, sql):
                inside.set()
                gate.wait(timeout=10.0)

        d = D.QueryDispatcher(_Runner(), RG.ResourceGroupManager(), lanes=2)
        ex = mod(p, "runtime.prewarm").PrewarmExecutor(d.runner, None, verify=False)
        ex.use_admission(d.system_admission)
        t = ex.run(reason="start", statements=["select 1"])
        assert inside.wait(timeout=10.0)
        running = {s["name"]: s["running"] for s in d.stats()}["system.prewarm"]
        user = d.enqueue()
        assert user.wait() is not None
        user_lane0 = user.lane is d._lanes[0]
        d.release(user)
        gate.set()
        t.join(timeout=10.0)
        stats = {s["name"]: s for s in d.stats()}["system.prewarm"]
        got[p] = (running, user_lane0, stats["running"], stats["total_admitted"], ex.state)
    assert got["trino_tpu"] == got["trino_tpu_torch"] == (1, False, 0, 1, "WARM")


def _server(p: str, **kw):
    S = mod(p, "server.coordinator")
    if p == "trino_tpu_torch":
        kw.setdefault("device", "cpu")
    return S.CoordinatorServer(port=0, **kw)


def test_coordinator_prewarm_on_start_and_records(tmp_path):
    """start() attaches an executor from prewarm.manifest-path, replays it
    through system_admission, shows its state in system.runtime.nodes, and
    shutdown() saves the union of the seed and the observed statements."""
    got = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        P.save_manifest(P.WorkloadManifest(statements=["select 41 + 1"]), loc)
        install(p, {"prewarm.manifest-path": loc})
        meter = Meter(p)
        srv = _server(p)
        srv.start()
        try:
            pw = srv.runner.prewarm
            assert type(pw).__module__ == f"{p}.runtime.prewarm"
            pw._thread.join(timeout=30)
            states = {r[0] for r in srv.runner.execute(
                "select prewarm from system.runtime.nodes").rows}
            q = srv.submit("select 2 + 2")
            assert q.done.wait(timeout=30) and q.state == "FINISHED"
            admitted = {s["name"]: s for s in srv.dispatcher.stats()}[
                "system.prewarm"]["total_admitted"]
        finally:
            srv.shutdown()
        got[p] = (executor_view(pw), states, admitted, meter.delta(),
                  sorted(P.load_manifest(loc).statements))
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    view, states, admitted, metrics, stmts = got["trino_tpu_torch"]
    assert view["state"] == "WARM" and states == {"WARM"} and admitted == 1
    assert metrics["runs"] == {"start/warm": 1} and metrics["statements"] == 2
    assert stmts == ["select 2 + 2", "select 41 + 1"]


def test_coordinator_on_start_off_still_saves(tmp_path):
    got = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        P.save_manifest(P.WorkloadManifest(statements=["select 7"]), loc)
        install(p, {"prewarm.manifest-path": loc, "prewarm.on-start": "false"})
        srv = _server(p)
        srv.start()
        try:
            pw = srv.runner.prewarm
            q = srv.submit("select 8")
            assert q.done.wait(timeout=30) and q.state == "FINISHED"
        finally:
            srv.shutdown()
        got[p] = (pw._thread, pw.state, P.load_manifest(loc).statements)
    assert got["trino_tpu"] == got["trino_tpu_torch"] == (None, "IDLE", ["select 7", "select 8"])


def test_coordinator_adopts_preattached_executor_lock(tmp_path):
    """An executor attached before the server (as runner_from_etc does)
    adopts the server's dispatcher admission: its replay goes through the
    system.prewarm group, not a private lock."""
    got = {}
    for p in PKGS:
        P = mod(p, "runtime.prewarm")
        loc = str(tmp_path / f"{p}.json")
        P.save_manifest(P.WorkloadManifest(statements=["select 1"]), loc)
        r = local(p)
        pre = P.attach_prewarm(r, loc)
        srv = _server(p, runner=r)
        srv.start()
        try:
            adopted = r.prewarm is pre and pre._admission is not None
            pre._thread.join(timeout=30)
            admitted = {s["name"]: s for s in srv.dispatcher.stats()}[
                "system.prewarm"]["total_admitted"]
        finally:
            srv.shutdown()
        got[p] = (adopted, pre.state, admitted)
    assert got["trino_tpu"] == got["trino_tpu_torch"] == (True, "WARM", 1)


def test_nodes_prewarm_column_with_executor(tmp_path):
    """tests/test_membership.py's nodes case with an executor attached: the
    prewarm column gives its state (NULL without one), in both packages."""
    got = {}
    for p in PKGS:
        M = mod(p, "runtime.membership")
        system = mod(p, "connectors.system")
        P = mod(p, "runtime.prewarm")

        class _Stub:
            membership = M.ClusterMembership(["wa", "wb"])
            prewarm = None

        stub = _Stub()
        before = [r[4] for r in system.SystemConnector(runner=stub)._rows("nodes")]

        class _Runner:
            def execute(self, sql):
                return None

        stub.prewarm = P.PrewarmExecutor(_Runner(), None)
        idle = [r[4] for r in system.SystemConnector(runner=stub)._rows("nodes")]
        stub.prewarm.run(statements=["select 1"], wait=True)
        warm = [r[4] for r in system.SystemConnector(runner=stub)._rows("nodes")]
        got[p] = (before, idle, warm)
    assert got["trino_tpu"] == got["trino_tpu_torch"] == (
        [None, None], ["IDLE", "IDLE"], ["WARM", "WARM"])


def test_port_local_runner_nodes_row_gives_prewarm_state(tmp_path):
    """The port's runner without membership lists its device; the prewarm
    column still gives the attached executor's state."""
    from trino_tpu_torch.runtime.prewarm import attach_prewarm, save_manifest, WorkloadManifest

    r = local("trino_tpu_torch")
    q = "select node_id, prewarm from system.runtime.nodes"
    assert r.execute(q).rows == [("cpu", None)]
    loc = str(tmp_path / "m.json")
    save_manifest(WorkloadManifest(statements=[SQL]), loc)
    attach_prewarm(r, loc).run(reason="start", wait=True)
    assert r.execute(q).rows == [("cpu", "WARM")]


def test_recorded_manifest_replays_in_the_other_package(tmp_path, mesh2):
    """A manifest each package recorded from its own mesh (statements, the
    learned join capacities, the dictionary snapshot) replays to WARM in
    the other package, with the same rows."""
    got = {}
    for writer, reader in (("trino_tpu", "trino_tpu_torch"), ("trino_tpu_torch", "trino_tpu")):
        loc = str(tmp_path / f"{writer}.json")
        ex = mod(writer, "runtime.prewarm").PrewarmExecutor(mesh2[writer], loc)
        for s in (JSQL, VSQL):
            mesh2[writer].execute(s)
            ex.record(s)
        assert ex.save() is True
        doc = json.loads((tmp_path / f"{writer}.json").read_text())
        other = mesh(reader, 2)
        ex2 = mod(reader, "runtime.prewarm").attach_prewarm(other, loc)
        ex2.run(reason="start", wait=True)
        obs = observatory(reader)
        mark = obs.mark()
        rows = [sorted(other.execute(s).rows) for s in (JSQL, VSQL)]
        got[reader] = (executor_view(ex2), obs.mark() - mark, rows, sorted(doc),
                       bool(doc["dictionaries"]))
    assert got["trino_tpu"] == got["trino_tpu_torch"]
    view, above, rows, keys, dicts = got["trino_tpu_torch"]
    assert view["state"] == "WARM" and above == 0 and dicts
    assert len(rows[0]) == 25 and len(rows[1]) == 5
