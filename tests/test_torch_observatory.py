"""The port's query performance observatory against the JAX package: the
plan-decision ledger, the compile observatory, the profile archive and the
audit log.

  * the pure-ledger cases of tests/test_decisions.py (recording, byte
    attribution under decision scopes, hindsight verdicts, lane safety),
    once per package (`pkg`);
  * the ledger of every TPC-H query on the 4-worker mesh: the planner's
    decisions of all 22 plans (both packages' `create_subplan` under one
    statement context each) and, for the queries no other file runs on
    both meshes, the whole executed ledger.  The other executed queries
    hold their ledgers where they already run on both meshes
    (`assert_same_ledger`, called by tests/test_torch_tpch.py,
    test_torch_mesh.py, test_torch_semi_cross.py and test_torch_verify.py);
  * the cases of tests/test_profile_store.py (artifacts, the store, the
    device gate's telemetry, the runner integration, tools/profile_diff.py,
    the audit log, lane safety) but the coordinator endpoint; the port's
    artifacts load in the unchanged tools/profile_diff.py and
    tools/decision_report.py;
  * the compile observatory: a warm mesh replay records zero events
    (tests/test_telemetry.py), `system.runtime.compilations` answers and
    kernel builds/loads are events.

Walls are never compared; byte counts and verdicts are compared where the
two engines attribute the same bytes (ROADMAP.md section 3 lists where
they do not, and why).
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import time

import pytest

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

PKGS = ("trino_tpu", "trino_tpu_torch")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _tool(name):
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def local_runner(pkg: str, **kw):
    R = mod(pkg, "runtime.runner").LocalQueryRunner
    if pkg == "trino_tpu_torch":
        kw["device"] = "cpu"
    return R(catalog="tpch", schema="tiny", **kw)


# -- ledger parity helpers (also used by the mesh test files) -----------------


def _pkg_of(runner) -> str:
    return type(runner).__module__.split(".")[0]


def attach_stores(*runners) -> None:
    """A memory-only profile store on each runner that has none, so its
    statements' ledgers can be read back."""
    for r in runners:
        if r.profile_store is None:
            ps = mod(_pkg_of(r), "telemetry.profile_store")
            ps.attach_profile_store(r, ps.ProfileStore(ring_limit=16))


def ledger_of(runner, sql: str) -> dict:
    """The decision ledger (JSON) of the runner's last run of `sql`."""
    store = runner.profile_store
    for ref in reversed(store.refs()):
        art = store.get(ref["key"])
        if art["sql"] == sql[:2000]:
            return art["decisions"]
    raise AssertionError(f"no archived artifact for {sql[:60]!r}")


def sequence(ledger: dict, learned: tuple = ()) -> list:
    """(kind, site, choice, rejected) per decision; the choice of the
    capacity decisions at the positions in `learned` is left out."""
    return [
        (d["kind"], d["site"]) + (() if i in learned else (d["choice"], d["alternative"]))
        for i, d in enumerate(ledger["decisions"])
    ]


def assert_same_ledger(jax_runner, port_runner, sql: str) -> None:
    """The port's ledger of its last run of `sql` has the JAX ledger's
    (kind, site, choice, rejected) sequence, and the same verdict wherever
    the two attribute the same bytes.  A licensed join's capacity choice
    also reads the process's capacity history (`learned_cap`), which a
    test process fills with whatever ran before in it: where the two
    histories gave different learned widths, that one choice is not
    compared (test_executed_ledger_equals_jax compares it from empty
    histories)."""
    jl, pl = ledger_of(jax_runner, sql), ledger_of(port_runner, sql)
    learned = tuple(
        i for i, (jd, pd) in enumerate(zip(jl["decisions"], pl["decisions"]))
        if jd["kind"] == pd["kind"] == "join_capacity"
        and jd["inputs"].get("learned_cap") != pd["inputs"].get("learned_cap")
    )
    assert sequence(pl, learned) == sequence(jl, learned)
    for i, (jd, pd) in enumerate(zip(jl["decisions"], pl["decisions"])):
        if i in learned:
            continue
        if jd["bytes_by"] == pd["bytes_by"] and jd["measured"].keys() == pd["measured"].keys():
            assert pd["hindsight"] == jd["hindsight"], (jd, pd)


def plan_ledger(runner, sql: str) -> list:
    """(kind, site, choice, rejected, inputs) of the decisions the planner
    records for `sql`'s mesh plan, under a statement context of its own."""
    pkg = _pkg_of(runner)
    lc = mod(pkg, "runtime.lifecycle")
    ctx = lc.QueryContext("q_plan")
    led = mod(pkg, "telemetry.decisions").ensure_ledger(ctx)
    token = lc.set_current(ctx)
    try:
        runner.create_subplan(runner.create_plan(sql))
    finally:
        lc.reset_current(token)
    return [(d.kind, d.site, d.choice, d.alternative, d.inputs) for d in led.decisions]


@pytest.fixture(scope="module")
def meshes():
    from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
    from trino_tpu_torch.parallel import DistributedQueryRunner

    jax_mesh = JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=4)
    port_mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    attach_stores(jax_mesh, port_mesh)
    return jax_mesh, port_mesh


@pytest.mark.parametrize("qid", range(1, 23))
def test_planner_decisions_equal_jax(meshes, qid):
    """Every decision the planner records for the 4-worker mesh plan of
    each TPC-H query — the sequence and the inputs each choice saw —
    equals the JAX package's."""
    from trino_tpu.connectors.tpch.queries import QUERIES

    jax_mesh, port_mesh = meshes
    assert plan_ledger(port_mesh, QUERIES[qid]) == plan_ledger(jax_mesh, QUERIES[qid])


@pytest.mark.parametrize("qid", [12, 15, 19])
def test_executed_ledger_equals_jax(meshes, qid):
    """The executed ledger (the planner's decisions, the capacity sources
    the runtime chose, the measured bytes and verdicts) of the TPC-H
    queries no other test file runs on both 4-worker meshes."""
    from trino_tpu.connectors.tpch.queries import QUERIES
    from test_torch_e2e import assert_same_rows

    jax_mesh, port_mesh = meshes
    # both capacity histories empty, so every capacity choice compares
    for p in PKGS:
        mod(p, "partitioning.speculative").CAP_HISTORY.clear()
    expected = jax_mesh.execute(QUERIES[qid])
    actual = port_mesh.execute(QUERIES[qid])
    assert_same_rows(actual.rows, expected.rows, ordered=False, float_rtol=1e-9)
    assert_same_ledger(jax_mesh, port_mesh, QUERIES[qid])
    assert sequence(ledger_of(port_mesh, QUERIES[qid])) == sequence(
        ledger_of(jax_mesh, QUERIES[qid])
    )
    led = ledger_of(port_mesh, QUERIES[qid])
    assert led["finalized"] and led["unattributed_bytes_by"] == {}
    # the join decisions carry the runner-side measurements
    for d in led["decisions"]:
        if d["kind"] == "join_distribution" and d["choice"] == "broadcast":
            assert d["exchange_bytes"] > 0 and "build_bytes" in d["measured"]


def test_remote_sources_carry_decision_ids(meshes):
    """Under a statement the fragmenter stamps each cut exchange's decision
    onto its RemoteSourceNode, and the ids resolve in the statement's
    ledger; planned bare (no statement) they stay None."""
    from trino_tpu.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.planner.fragmenter import RemoteSourceNode
    from trino_tpu_torch.runtime import lifecycle as lc
    from trino_tpu_torch.telemetry.decisions import ensure_ledger

    _, port_mesh = meshes

    def remotes(sub):
        def walk(node):
            yield node
            for c in node.children:
                yield from walk(c)

        return [
            n for f in sub.all_fragments() for n in walk(f.root)
            if isinstance(n, RemoteSourceNode) and n.exchange_kind in ("broadcast", "repartition")
        ]

    bare = remotes(port_mesh.create_subplan(port_mesh.create_plan(QUERIES[3])))
    assert bare and all(n.decision_id is None for n in bare)
    ctx = lc.QueryContext("q_ids")
    led = ensure_ledger(ctx)
    token = lc.set_current(ctx)
    try:
        stamped = remotes(port_mesh.create_subplan(port_mesh.create_plan(QUERIES[3])))
    finally:
        lc.reset_current(token)
    ids = {d.decision_id for d in led.decisions}
    assert len(stamped) == len(bare)
    assert all(n.decision_id in ids for n in stamped)


def test_plan_decisions_table_lists_join_distributions(meshes):
    """system.runtime.plan_decisions reads the attached store's ledgers:
    the mesh Q3's join distributions with measured bytes and a verdict."""
    from trino_tpu.connectors.tpch.queries import QUERIES

    _, port_mesh = meshes
    port_mesh.execute(QUERIES[3])
    rows = port_mesh.execute(
        "select query_id, kind, choice, exchange_bytes, hindsight "
        "from system.runtime.plan_decisions where kind = 'join_distribution'"
    ).rows
    qid = port_mesh.profile_store.refs()[-2]["query_id"]
    mine = [r for r in rows if r[0] == qid]
    assert len(mine) == 2
    assert all(r[2] == "broadcast" and r[3] > 0 and r[4] == "vindicated" for r in mine)


# -- ledger unit behaviour (tests/test_decisions.py) ---------------------------


def test_record_assigns_stable_ids_and_copies_inputs(pkg):
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_t")
    seen = {"estimated_build_rows": 5}
    d0 = led.record("join_distribution", "planner", "broadcast", "partitioned", seen)
    d1 = led.record("exchange", "planner", "repartition", "")
    assert (d0, d1) == ("d000", "d001")
    seen["estimated_build_rows"] = 999
    assert led.decisions[0].inputs == {"estimated_build_rows": 5}
    assert isinstance(led.decisions[0].audit_seq, int)
    assert led.decisions[1].audit_seq >= led.decisions[0].audit_seq


def test_observe_merges_and_ignores_unknown(pkg):
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_t")
    did = led.record("join_capacity", "runtime", "licensed", "runtime_check")
    led.observe(did, live_cap=128)
    led.observe(did, executed=1)
    led.observe("d999", bogus=1)
    led.observe(None, bogus=1)
    assert led.decisions[0].measured == {"live_cap": 128, "executed": 1}


def test_collective_attribution_and_unattributed_bucket(pkg):
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_t")
    did = led.record("join_distribution", "planner", "broadcast", "partitioned")
    led.observe_collective(did, 0, 1000, "all_gather", "broadcast")
    led.observe_collective(did, 0, 24, "all_gather", "broadcast")
    led.observe_collective(did, 1, 8, "gather", "capacity_sizing")
    d = led.decisions[0]
    assert d.bytes_by == {("all_gather", "broadcast"): 1024, ("gather", "capacity_sizing"): 8}
    assert d.exchange_bytes == 1024
    assert sorted(set(d.fragments)) == [0, 1]
    led.observe_collective(None, 2, 77, "all_to_all", "repartition")
    assert led.unattributed == {("all_to_all", "repartition"): 77}
    led.observe_collective(None, 2, 5, "gather", "result")
    assert ("gather", "result") not in led.unattributed


def test_ledger_to_json_shape(pkg):
    D = mod(pkg, "telemetry.decisions")
    led = D.DecisionLedger("q_t")
    did = led.record("exchange", "planner", "repartition", "broadcast")
    led.observe_collective(did, 3, 64, "all_to_all", "repartition")
    led.finalize()
    doc = led.to_json()
    assert doc["query_id"] == "q_t" and doc["finalized"] is True
    (d,) = doc["decisions"]
    assert d["kind"] == "exchange" and d["choice"] == "repartition"
    assert d["bytes_by"] == {"all_to_all/repartition": 64}
    assert d["exchange_bytes"] == 64 and d["fragments"] == [3]
    assert d["hindsight"] in D.HINDSIGHT
    json.dumps(doc)


def test_finalize_idempotent(pkg):
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_t")
    did = led.record("exchange", "planner", "repartition", "")
    led.observe_collective(did, 0, 10, "all_to_all", "repartition")
    c = mod(pkg, "telemetry.metrics").plan_decisions_counter().labels(
        "exchange", "repartition", "vindicated"
    )
    before = c.value()
    led.finalize()
    led.finalize()
    assert c.value() == before + 1
    assert led.decisions[0].hindsight == "vindicated"


def test_fragment_wall_join(pkg):
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_t")
    did = led.record("exchange", "planner", "repartition", "")
    for fid in (0, 0, 2):
        led.observe_collective(did, fid, 10, "all_to_all", "repartition")
    led.finalize(fragment_phases={0: 1.5, 1: 9.0, 2: 0.25})
    assert led.decisions[0].measured["fragment_wall_s"] == pytest.approx(1.75)


#: tests/test_decisions.py's hindsight rules: (kind, choice, alternative,
#: inputs, bytes_by, measured) -> (verdict, substring of the detail)
HINDSIGHT_CASES = {
    "broadcast_regret": (
        ("join_distribution", "broadcast", "partitioned", None,
         [("all_gather", "broadcast", 8 << 20)], {"probe_move_bytes": 0}),
        ("regret", "broadcast moved"),
    ),
    "broadcast_under_floor": (
        ("join_distribution", "broadcast", "partitioned", None,
         [("all_gather", "broadcast", 4096)], {"probe_move_bytes": 0}),
        ("vindicated", "floor"),
    ),
    "broadcast_probe_move_dominates": (
        ("join_distribution", "broadcast", "partitioned", None,
         [("all_gather", "broadcast", 8 << 20)], {"probe_move_bytes": 32 << 20}),
        ("vindicated", ""),
    ),
    "broadcast_unmeasured": (
        ("join_distribution", "broadcast", "partitioned", None, [], None),
        ("unmeasured", ""),
    ),
    "partitioned_regret": (
        ("join_distribution", "partitioned", "broadcast", None,
         [("all_to_all", "repartition", 64 << 20)], {"build_bytes": 1 << 20}),
        ("regret", ""),
    ),
    "partitioned_vindicated": (
        ("join_distribution", "partitioned", "broadcast", None,
         [("all_to_all", "repartition", 2 << 20)], {"build_bytes": 1 << 20}),
        ("vindicated", ""),
    ),
    "licensed_regret": (
        ("join_capacity", "licensed", "runtime_check", {"licensed_cap": 65536}, [],
         {"executed": 1, "live_cap": 2048}),
        ("regret", ""),
    ),
    "licensed_vindicated": (
        ("join_capacity", "licensed", "runtime_check", {"licensed_cap": 4096}, [],
         {"executed": 1, "live_cap": 4096}),
        ("vindicated", ""),
    ),
    "declined_regret": (
        ("join_capacity", "declined", "licensed", {"licensed_cap": 4096}, [],
         {"executed": 1, "runtime_cap": 4096}),
        ("regret", "bought nothing"),
    ),
    "declined_vindicated": (
        ("join_capacity", "declined", "licensed", {"licensed_cap": 4096}, [],
         {"executed": 1, "runtime_cap": 512}),
        ("vindicated", ""),
    ),
    "runtime_check_measured": (
        ("join_capacity", "runtime_check", "", None, [], {"executed": 1, "runtime_cap": 512}),
        ("vindicated", ""),
    ),
    "runtime_check_unmeasured": (
        ("join_capacity", "runtime_check", "", None, [], None),
        ("unmeasured", ""),
    ),
    "mechanical_measured": (
        ("exchange", "repartition", "", None, [("all_to_all", "repartition", 100)], None),
        ("vindicated", ""),
    ),
    "schedule_license_unmeasured": (
        ("schedule_license", "sync", "async", None, [], None),
        ("unmeasured", ""),
    ),
}


@pytest.mark.parametrize("case", list(HINDSIGHT_CASES))
def test_hindsight_rules(pkg, case):
    (kind, choice, alternative, inputs, bytes_by, measured), (verdict, detail) = (
        HINDSIGHT_CASES[case]
    )
    led = mod(pkg, "telemetry.decisions").DecisionLedger("q_h")
    did = led.record(kind, "site", choice, alternative, inputs)
    for ck, purpose, nbytes in bytes_by:
        led.observe_collective(did, 0, nbytes, ck, purpose)
    led.observe(did, **(measured or {}))
    led.finalize(n_workers=8, regret_ratio=2.0, min_bytes=1 << 20)
    d = led.decisions[0]
    assert d.hindsight == verdict and detail in d.hindsight_detail


def test_record_decision_noops_outside_statement(pkg):
    D = mod(pkg, "telemetry.decisions")
    assert mod(pkg, "runtime.lifecycle").current_query() is None
    assert D.record_decision("exchange", "s", "repartition") is None
    D.observe_collective(0, 10, "all_to_all", "repartition")
    D.observe_decision("d000", x=1)


def test_decision_scope_innermost_wins(pkg):
    D = mod(pkg, "telemetry.decisions")
    lc = mod(pkg, "runtime.lifecycle")
    ctx = lc.QueryContext("q_scope")
    led = D.ensure_ledger(ctx)
    token = lc.set_current(ctx)
    try:
        outer = D.record_decision("join_distribution", "s", "partitioned")
        inner = D.record_decision("exchange", "s", "repartition")
        assert D.current_decision() is None
        with D.decision_scope(outer):
            D.observe_collective(0, 100, "all_to_all", "repartition")
            with D.decision_scope(inner):
                assert D.current_decision() == inner
                D.observe_collective(0, 7, "all_to_all", "repartition")
            with D.decision_scope(None):
                assert D.current_decision() == outer
                D.observe_collective(0, 1, "all_gather", "broadcast")
        assert D.current_decision() is None
    finally:
        lc.reset_current(token)
    assert led._by_id[outer].bytes_by == {
        ("all_to_all", "repartition"): 100, ("all_gather", "broadcast"): 1,
    }
    assert led._by_id[inner].bytes_by == {("all_to_all", "repartition"): 7}


def test_ledgers_isolate_across_threads(pkg):
    D = mod(pkg, "telemetry.decisions")
    lc = mod(pkg, "runtime.lifecycle")
    results = {}

    def lane(qid):
        ctx = lc.QueryContext(qid)
        led = D.ensure_ledger(ctx)
        token = lc.set_current(ctx)
        try:
            for _ in range(50):
                did = D.record_decision("exchange", qid, "repartition")
                with D.decision_scope(did):
                    D.observe_collective(0, 10, "all_to_all", "repartition")
        finally:
            lc.reset_current(token)
        results[qid] = led

    ts = [threading.Thread(target=lane, args=(f"q_iso_{i}",)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len(results) == 4
    for qid, led in results.items():
        assert len(led.decisions) == 50 and led.unattributed == {}
        assert all(d.site == qid for d in led.decisions)


def test_decision_vocabulary_equals_jax():
    for name in ("DECISION_KINDS", "HINDSIGHT", "EXCHANGE_KINDS"):
        assert getattr(mod("trino_tpu_torch", "telemetry.decisions"), name) == getattr(
            mod("trino_tpu", "telemetry.decisions"), name
        )


# -- profile artifacts (tests/test_profile_store.py) ---------------------------


def _artifact(pkg, query_id="query_1", sql="select 1", wall=1.0, phases=None,
              fragments=(), gate_wait=0.0, counters=None, coll=None):
    """Hand-built artifact with chosen phase values (via a stub profile)."""

    class _Prof:
        def to_json(self):
            return {
                "fragments": list(fragments),
                "counters": dict(counters or {}),
                "trace_cache": {"hits": 0, "misses": 0, "retraces": 0},
                "collective_bytes_by": dict(coll or {}),
            }

        def phase_totals(self):
            return dict(phases or {})

    return mod(pkg, "telemetry.profile_store").build_artifact(
        query_id=query_id, sql=sql, state="FINISHED", wall_s=wall,
        mesh_profile=_Prof() if phases is not None or fragments else None,
        gate_wait_s=gate_wait, created_at=0.0,
    )


def test_artifact_equals_jax():
    """The same inputs build the same artifact in both packages."""
    arts = [
        _artifact(p, wall=2.5, phases={"trace": 0.5, "compute": 1.0}, gate_wait=0.125,
                  coll={"all_gather/broadcast": 10}, counters={"x": 1})
        for p in PKGS
    ]
    assert arts[0] == arts[1]
    assert mod("trino_tpu_torch", "telemetry.profile_store").ARTIFACT_PHASES == mod(
        "trino_tpu", "telemetry.profile_store"
    ).ARTIFACT_PHASES


def test_phases_sum_to_wall_exactly(pkg):
    art = _artifact(pkg, wall=2.5, phases={"trace": 0.5, "compute": 1.0, "transfer": 0.25},
                    gate_wait=0.125)
    assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-12
    assert art["phases"]["gate_wait"] == 0.125
    assert art["phases"]["unattributed"] == pytest.approx(0.625)


def test_unattributed_can_go_negative_but_still_sums(pkg):
    art = _artifact(pkg, wall=1.0, phases={"compute": 1.5})
    assert art["phases"]["unattributed"] == pytest.approx(-0.5)
    assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-12


def test_artifact_key_and_hash(pkg):
    a = _artifact(pkg, sql="select  1")
    b = _artifact(pkg, query_id="query_2", sql="SELECT 1")
    assert a["sql_hash"] == b["sql_hash"] and a["key"] != b["key"] and a["version"] == 1


def test_local_artifact_has_empty_mesh_sections(pkg):
    art = _artifact(pkg)
    assert art["fragments"] == [] and art["mesh"] == "local"
    assert art["phases"]["unattributed"] == pytest.approx(1.0)


# -- the store --------------------------------------------------------------------


def _store(pkg, **kw):
    return mod(pkg, "telemetry.profile_store").ProfileStore(**kw)


def test_archive_ring_and_rows(pkg):
    store = _store(pkg)
    ref = store.archive(_artifact(pkg))
    assert ref["path"] is None
    assert store.get("query_1")["query_id"] == "query_1"
    assert store.get(ref["key"]) is not None
    rows = store.rows()
    assert len(rows) == 1 and rows[0][0] == "query_1"


def test_archive_to_disk_through_spi(pkg, tmp_path):
    store = _store(pkg, archive_dir=str(tmp_path))
    ref = store.archive(_artifact(pkg))
    assert store.flush(5.0)
    assert os.path.exists(ref["path"])
    assert json.loads(open(ref["path"]).read())["query_id"] == "query_1"


def test_get_from_disk_survives_restart(pkg, tmp_path):
    _store(pkg, archive_dir=str(tmp_path), synchronous=True).archive(_artifact(pkg))
    art = _store(pkg, archive_dir=str(tmp_path)).get("query_1")
    assert art is not None and art["query_id"] == "query_1"


def test_concurrent_archives_produce_distinct_wellformed_files(pkg, tmp_path):
    store = _store(pkg, archive_dir=str(tmp_path))
    K = 8

    def complete(i):
        for j in range(5):
            store.archive(_artifact(pkg, query_id=f"query_{i}_{j}",
                                    sql=f"select {i * 100 + j}", wall=0.01 * (i + 1)))

    threads = [threading.Thread(target=complete, args=(i,), daemon=True) for i in range(K)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert store.flush(10.0)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == K * 5
    for f in files:
        art = json.loads(open(tmp_path / f).read())
        assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-9


def test_retention_sweep_deletes_only_expired(pkg, tmp_path):
    t = [1000.0]
    store = _store(pkg, archive_dir=str(tmp_path), retention_max_age_s=100.0,
                   synchronous=True, clock=lambda: t[0])
    old = store.archive(_artifact(pkg, query_id="query_old"))
    os.utime(old["path"], (800.0, 800.0))
    young = store.archive(_artifact(pkg, query_id="query_young"))
    os.utime(young["path"], (950.0, 950.0))
    assert store.sweep() == [old["path"]]
    assert os.path.exists(young["path"]) and not os.path.exists(old["path"])


def test_retention_count_prunes_oldest_first(pkg, tmp_path):
    store = _store(pkg, archive_dir=str(tmp_path), retention_max_count=2, synchronous=True)
    refs = []
    for i in range(4):
        r = store.archive(_artifact(pkg, query_id=f"query_{i}"))
        os.utime(r["path"], (100.0 + i, 100.0 + i))
        refs.append(r)
    assert sorted(store.sweep(now_s=200.0)) == sorted([refs[0]["path"], refs[1]["path"]])
    assert os.path.exists(refs[2]["path"]) and os.path.exists(refs[3]["path"])


def test_sweep_ignores_non_artifacts(pkg, tmp_path):
    (tmp_path / "spool.npz").write_bytes(b"not a profile")
    store = _store(pkg, archive_dir=str(tmp_path), retention_max_count=1, synchronous=True)
    store.sweep(now_s=1e12)
    assert (tmp_path / "spool.npz").exists()


def test_ring_bounded(pkg):
    store = _store(pkg, ring_limit=3)
    for i in range(5):
        store.archive(_artifact(pkg, query_id=f"query_{i}"))
    assert len(store.refs()) == 3 and store.get("query_0") is None


# -- device-gate telemetry -----------------------------------------------------------


def _hist_count(pkg, name):
    return mod(pkg, "telemetry").REGISTRY.histogram("trino_tpu_" + name).value()


def test_uncontended_gate_observes_nothing(pkg):
    device_slice = mod(pkg, "runtime.dispatcher").device_slice
    w0 = _hist_count(pkg, "device_gate_wait_seconds")
    h0 = _hist_count(pkg, "device_gate_hold_seconds")
    for _ in range(100):
        with device_slice():
            pass
    assert _hist_count(pkg, "device_gate_wait_seconds") == w0
    assert _hist_count(pkg, "device_gate_hold_seconds") == h0


def test_contended_gate_observes_wait_and_hold(pkg):
    dsp = mod(pkg, "runtime.dispatcher")
    w0 = _hist_count(pkg, "device_gate_wait_seconds")
    h0 = _hist_count(pkg, "device_gate_hold_seconds")
    holding, release = threading.Event(), threading.Event()

    def holder():
        with dsp.device_slice():
            holding.set()
            release.wait(5.0)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    holding.wait(5.0)
    seen = dsp.gate_holder()

    def waiter():
        with dsp.device_slice():
            pass

    t2 = threading.Thread(target=waiter, daemon=True)
    t2.start()
    time.sleep(0.05)
    release.set()
    t.join(5.0)
    t2.join(5.0)
    assert seen == 0 and dsp.gate_holder() == -1
    assert _hist_count(pkg, "device_gate_wait_seconds") == w0 + 1
    assert _hist_count(pkg, "device_gate_hold_seconds") >= h0 + 1


def test_gate_wait_attributed_to_executing_query(pkg):
    dsp = mod(pkg, "runtime.dispatcher")
    lc = mod(pkg, "runtime.lifecycle")
    ctx = lc.QueryContext("query_gate")
    holding, release = threading.Event(), threading.Event()

    def holder():
        with dsp.device_slice():
            holding.set()
            release.wait(5.0)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    holding.wait(5.0)
    token = lc.set_current(ctx)
    try:
        threading.Thread(
            target=lambda: (time.sleep(0.02), release.set()), daemon=True
        ).start()
        with dsp.device_slice():
            pass
    finally:
        lc.reset_current(token)
    t.join(5.0)
    assert ctx.gate_wait_s > 0.0


def test_reentrant_gate_hold_counts_once(pkg):
    dsp = mod(pkg, "runtime.dispatcher")
    with dsp.device_slice():
        with dsp.device_slice():
            assert dsp.gate_holder() == 0
        assert dsp.gate_holder() == 0
    assert dsp.gate_holder() == -1


def test_observatory_vocabulary_preregistered(pkg):
    text = mod(pkg, "telemetry").REGISTRY.render_prometheus()
    for name in (
        "trino_tpu_device_gate_wait_seconds", "trino_tpu_device_gate_hold_seconds",
        "trino_tpu_device_gate_occupied", "trino_tpu_profiles_archived_total",
        "trino_tpu_profiles_pruned_total", "trino_tpu_audit_events_total",
        "trino_tpu_compile_seconds", "trino_tpu_compile_events_total",
    ):
        assert name in text


# -- runner integration ------------------------------------------------------------


def _attach(pkg, r, store=None):
    ps = mod(pkg, "telemetry.profile_store")
    return ps.attach_profile_store(r, store if store is not None else ps.ProfileStore())


def test_local_execute_archives_artifact(pkg):
    r = local_runner(pkg)
    store = _attach(pkg, r)
    r.execute("set session query_trace = true")
    assert r.execute("select count(*) from region").rows == [(5,)]
    art = store.get(store.refs()[-1]["query_id"])
    assert art["state"] == "FINISHED" and art["rows"] == 1
    assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-9
    assert art["spans"] and art["decisions"]["finalized"]


def test_failed_statement_archives_with_error_code(pkg):
    r = local_runner(pkg)
    store = _attach(pkg, r)
    with pytest.raises(Exception):
        r.execute("select * from no_such_table")
    arts = [store.get(ref["query_id"]) for ref in store.refs()]
    assert [a["state"] for a in arts] == ["FAILED"]


def test_no_store_means_no_archiving_cost(pkg):
    r = local_runner(pkg)
    assert r.profile_store is None
    c = mod(pkg, "telemetry").REGISTRY.counter("trino_tpu_profiles_archived_total")
    c0 = c.value()
    r.execute("select 1")
    assert c.value() == c0


def test_system_table_and_statistics(pkg):
    r = local_runner(pkg)
    _attach(pkg, r)
    ev = mod(pkg, "runtime.events").CollectingEventListener()
    r.events.add(ev)
    r.execute("select count(*) from nation")
    qid = ev.completed[0].query_id
    rows = r.execute(
        "select query_id, state, wall_s, resource_group, gate_wait_s "
        "from system.runtime.query_profiles"
    ).rows
    assert any(row[0] == qid and row[1] == "FINISHED" for row in rows)
    stats = ev.completed[0].statistics
    assert stats.gate_wait_s == 0.0 and stats.profile_key


def test_mesh_artifact_carries_fragments_and_collectives(meshes):
    """A 4-worker mesh statement's artifact: the mesh key, its fragments,
    phases that sum to the wall with the mesh decomposition in them."""
    _, port_mesh = meshes
    store = port_mesh.profile_store
    port_mesh.execute("select l_returnflag, count(*) from lineitem group by l_returnflag")
    art = store.get(store.refs()[-1]["query_id"])
    assert art["mesh"] == "(4, 'cpu')"
    assert len(art["fragments"]) >= 2
    assert abs(sum(art["phases"].values()) - art["wall_s"]) < 1e-9
    tracked = sum(art["phases"][p] for p in ("trace", "compute", "collective", "transfer", "other"))
    assert tracked > 0
    assert art["peak_memory_bytes"] == port_mesh.last_query.peak_memory


def test_port_artifacts_load_in_the_tools(meshes, tmp_path):
    """Two archived runs of one mesh statement diff in tools/profile_diff.py
    (phases sum to the wall delta, exit code by threshold) and render in
    tools/decision_report.py (exit code by regrets)."""
    from trino_tpu.connectors.tpch.queries import QUERIES

    pd = _tool("profile_diff")
    dr = _tool("decision_report")
    _, port_mesh = meshes
    store = port_mesh.profile_store
    paths = []
    for i in range(2):
        port_mesh.execute(QUERIES[3])
        art = store.get(store.refs()[-1]["query_id"])
        p = tmp_path / f"a{i}.json"
        p.write_text(json.dumps(art, sort_keys=True))
        paths.append(str(p))
    a, b = (json.loads(open(p).read()) for p in paths)
    rep = pd.diff_artifacts(a, b)
    assert rep["comparable"] and rep["sums_to_wall"]
    assert pd.main([paths[0], paths[0]]) == 0
    assert pd.main([paths[0], paths[1], "--threshold", "1e9"]) == 0
    want = 2 if any(d["hindsight"] == "regret" for d in a["decisions"]["decisions"]) else 0
    assert dr.main([paths[0], "--json"]) == want
    rep = dr.report(a)
    assert rep["finalized"] and len(rep["rows"]) == len(a["decisions"]["decisions"])


class _Pair:
    def _pair(self, pkg):
        frag_a = [{"fragment": 0, "kind": "SOURCE", "wall_s": 0.5,
                   "phases_ms": {"compute": 400.0, "transfer": 100.0}}]
        frag_b = [{"fragment": 0, "kind": "SOURCE", "wall_s": 1.5,
                   "phases_ms": {"compute": 400.0, "transfer": 1100.0}}]
        a = _artifact(pkg, query_id="query_a", wall=1.0,
                      phases={"compute": 0.4, "transfer": 0.1}, fragments=frag_a,
                      coll={"all_gather/broadcast": 1000}, counters={"exchange_elided": 3})
        b = _artifact(pkg, query_id="query_b", wall=2.2,
                      phases={"compute": 0.4, "transfer": 1.1}, fragments=frag_b,
                      gate_wait=0.2, coll={"all_gather/broadcast": 5000},
                      counters={"exchange_elided": 1})
        return a, b


class TestProfileDiff(_Pair):
    """tests/test_profile_store.py's profile_diff cases over the port's
    artifacts."""

    PKG = "trino_tpu_torch"

    def test_diff_sums_to_wall_delta(self):
        pd = _tool("profile_diff")
        a, b = self._pair(self.PKG)
        rep = pd.diff_artifacts(a, b)
        assert rep["comparable"] and rep["sums_to_wall"] is True
        assert rep["wall_delta_s"] == pytest.approx(1.2)
        assert sum(rep["phases_delta_s"].values()) == pytest.approx(rep["wall_delta_s"], abs=1e-9)

    def test_dominant_phase_and_fragment_named(self):
        pd = _tool("profile_diff")
        rep = pd.diff_artifacts(*self._pair(self.PKG))
        assert rep["dominant_phase"] == "transfer" and rep["dominant_fragment"] == 0
        assert rep["collective_bytes_delta"] == {"all_gather/broadcast": 4000}
        assert rep["counters_delta"] == {"exchange_elided": -2}
        assert rep["gate_wait_delta_s"] == pytest.approx(0.2)

    def test_null_diff_contract(self):
        pd = _tool("profile_diff")
        a, b = self._pair(self.PKG)
        rep = pd.diff_artifacts(a, a)
        assert rep["wall_delta_s"] == 0.0 and pd.null_diff_ok(rep)
        assert not pd.null_diff_ok(pd.diff_artifacts(a, b))

    def test_incompatible_versions_refused(self):
        pd = _tool("profile_diff")
        a, b = self._pair(self.PKG)
        with pytest.raises(ValueError):
            pd.diff_artifacts(a, dict(b, version=99))

    def test_different_statements_flagged_not_comparable(self):
        pd = _tool("profile_diff")
        a, _ = self._pair(self.PKG)
        b = _artifact(self.PKG, query_id="query_c", sql="select 2", wall=1.0)
        assert pd.diff_artifacts(a, b)["comparable"] is False

    def test_cli_threshold_exit_codes(self, tmp_path):
        pd = _tool("profile_diff")
        a, b = self._pair(self.PKG)
        pa, pb = tmp_path / "a.json", tmp_path / "b.json"
        pa.write_text(json.dumps(a))
        pb.write_text(json.dumps(b))
        assert pd.main([str(pa), str(pb)]) == 2
        assert pd.main([str(pa), str(pa)]) == 0
        assert pd.main([str(pa), str(pb), "--threshold", "5.0"]) == 0


# -- audit log (tests/test_profile_store.py) ------------------------------------


def test_audit_one_line_per_completion_with_fields(pkg, tmp_path):
    path = str(tmp_path / "audit.jsonl")
    r = local_runner(pkg)
    r.events.add(mod(pkg, "telemetry.audit").QueryAuditLog(path))
    r.execute("select count(*) from region")
    with pytest.raises(Exception):
        r.execute("select * from missing_table")
    lines = [json.loads(l) for l in open(path).read().splitlines() if l]
    assert len(lines) == 2
    ok, bad = lines
    assert ok["state"] == "FINISHED" and ok["rows"] == 1 and ok["wall_s"] > 0
    assert "gate_wait_s" in ok and "peak_memory_bytes" in ok
    assert bad["state"] == "FAILED" and bad["error_type"] == "USER_ERROR"
    assert bad["seq"] > ok["seq"]


def test_audit_size_based_rotation(pkg, tmp_path):
    ev = mod(pkg, "runtime.events")
    path = str(tmp_path / "audit.jsonl")
    log = mod(pkg, "telemetry.audit").QueryAuditLog(path, rotate_bytes=600, rotate_keep=2)
    for i in range(12):
        log.query_completed(ev.QueryCompletedEvent(f"query_{i}", "select 1", "FINISHED", 0.0, 0.1))
    assert os.path.exists(path + ".1") and os.path.getsize(path) <= 600
    for p in (path, path + ".1"):
        for line in open(p).read().splitlines():
            if line:
                json.loads(line)
    assert not os.path.exists(path + ".3")


def test_audit_unwritable_path_fails_at_startup(pkg, tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory must go")
    with pytest.raises(OSError):
        mod(pkg, "telemetry.audit").QueryAuditLog(str(blocker / "x.jsonl"))


def test_audit_config_attach_is_noop_without_knob(pkg):
    assert mod(pkg, "telemetry.audit").attach_audit_log(local_runner(pkg)) is None


def test_audit_counts_metric(pkg, tmp_path):
    c = mod(pkg, "telemetry").REGISTRY.counter("trino_tpu_audit_events_total")
    c0 = c.value()
    r = local_runner(pkg)
    r.events.add(mod(pkg, "telemetry.audit").QueryAuditLog(str(tmp_path / "a.jsonl")))
    r.execute("select 1")
    assert c.value() == c0 + 1


def test_audit_sequence_watermark_orders_decisions(tmp_path):
    """A decision records the audit watermark of its moment: lines written
    after it carry higher sequence numbers."""
    from trino_tpu_torch.telemetry import audit

    r = local_runner("trino_tpu_torch")
    r.events.add(audit.QueryAuditLog(str(tmp_path / "a.jsonl")))
    _attach("trino_tpu_torch", r)
    r.execute("select 1")
    mark = audit.sequence_watermark()
    r.execute("select n_regionkey, count(*) from nation group by 1")
    lines = [json.loads(l) for l in open(tmp_path / "a.jsonl").read().splitlines()]
    assert lines[-1]["seq"] == mark + 1 > lines[0]["seq"]


# -- lane safety ---------------------------------------------------------------


def test_per_statement_handles_resolve_through_contextvar(pkg):
    lc = mod(pkg, "runtime.lifecycle")
    r = local_runner(pkg)
    prof_a, prof_b = object(), object()
    ctx_a, ctx_b = lc.QueryContext("query_a"), lc.QueryContext("query_b")
    ctx_a.mesh_profile, ctx_b.mesh_profile = prof_a, prof_b
    results = {}

    def read(name, ctx):
        token = lc.set_current(ctx)
        try:
            results[name] = r.last_mesh_profile
        finally:
            lc.reset_current(token)

    ts = [threading.Thread(target=read, args=a, daemon=True)
          for a in (("a", ctx_a), ("b", ctx_b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(5.0)
    assert results["a"] is prof_a and results["b"] is prof_b
    assert r.last_mesh_profile is None


def test_concurrent_traced_statements_keep_their_own_traces(pkg):
    r = local_runner(pkg)
    failures = []

    def client(i):
        sql = f"explain analyze verbose select {i} + 0"
        for _ in range(3):
            try:
                text = "\n".join(row[0] for row in r.execute(sql).rows)
                trace = json.loads(text.split("Trace JSON: ", 1)[1])
                sqls = [e["args"]["sql"] for e in trace["traceEvents"] if e["name"] == "query"]
                if sqls != [sql]:
                    failures.append((i, sqls))
            except Exception as e:  # noqa: BLE001 — collected and asserted
                failures.append((i, repr(e)))

    ts = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert not failures, failures[:3]


def test_concurrent_lanes_archive_distinct_artifacts(pkg, tmp_path):
    r = local_runner(pkg)
    store = _attach(pkg, r, _store(pkg, archive_dir=str(tmp_path)))
    errors = []

    def client(i):
        try:
            r.execute(f"select {i} * 10")
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append(repr(e))

    ts = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
    assert not errors and store.flush(10.0)
    arts = [store.get(ref["query_id"]) for ref in store.refs()]
    assert sorted(a["sql"] for a in arts) == sorted(f"select {i} * 10" for i in range(4))
    for a in arts:
        assert a["state"] == "FINISHED"
        assert abs(sum(a["phases"].values()) - a["wall_s"]) < 1e-9


def test_dispatcher_lanes_share_the_store(pkg):
    """clone_for_dispatch hands the parent's store to every lane, and the
    statistics carry the admission's group."""
    rg = mod(pkg, "runtime.resource_groups")
    r = local_runner(pkg)
    store = _attach(pkg, r)
    ev = mod(pkg, "runtime.events").CollectingEventListener()
    r.events.add(ev)
    d = mod(pkg, "runtime.dispatcher").QueryDispatcher(
        r, rg.ResourceGroupManager(rg.ResourceGroupConfig("global", hard_concurrency=2,
                                                          max_queued=8)),
        lanes=2,
    )
    ticket = d.enqueue()
    ticket.wait()
    d.run_admitted(ticket, lambda lane: lane.execute("select 7"))
    stats = ev.completed[-1].statistics
    assert stats.group == "global" and stats.queued_s >= 0.0 and stats.gate_wait_s >= 0.0
    assert store.get(ev.completed[-1].query_id)["admission"]["group"] == "global"


# -- the compile observatory --------------------------------------------------------


def test_warm_mesh_replay_adds_zero_compile_events(meshes):
    """tests/test_telemetry.py's coldstart contract: after a first run, a
    warm replay records ZERO new compile events; the first run's closed
    events name their steps and walls."""
    from trino_tpu_torch.parallel.spmd import TRACE_CACHE
    from trino_tpu_torch.telemetry import REGISTRY
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    _, port_mesh = meshes
    sql = "select sum(l_extendedprice * l_discount) from lineitem where l_quantity < 23"
    TRACE_CACHE.clear()
    mark = OBSERVATORY.mark()
    port_mesh.execute(sql)
    cold = OBSERVATORY.events_above(mark)
    assert cold and all(e.closed and e.step and e.wall_s >= e.build_s for e in cold)
    assert not OBSERVATORY.has_open()
    qid = port_mesh.last_query.query_id
    assert {e.query_id for e in cold} == {qid}
    mark = OBSERVATORY.mark()
    port_mesh.execute(sql)
    assert OBSERVATORY.count == mark, "warm replay recorded new compile events"
    assert REGISTRY.histogram("trino_tpu_compile_seconds").value() > 0
    art = port_mesh.profile_store.get(qid)
    assert art["compile"]["events"] and art["compile"]["compile_s"] > 0


def test_compilations_table_and_manifest(meshes):
    """system.runtime.compilations answers with the ring; the manifest is
    deduplicated and most expensive first."""
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    _, port_mesh = meshes
    port_mesh.execute("select count(*) from orders where o_totalprice > 1000")
    mark = OBSERVATORY.mark()
    rows = port_mesh.execute(
        "select seq, step, bucket, mesh, query_id, fragment, wall_s "
        "from system.runtime.compilations"
    ).rows
    # the ring as it stood when the table was read: its events in order,
    # through the last one recorded before the read
    seqs = [r[0] for r in rows]
    assert seqs == sorted(set(seqs)) and seqs[-1] >= mark
    assert len(rows) <= len(OBSERVATORY.events())
    assert any(r[3] == "(4, 'cpu')" and r[6] >= 0.0 for r in rows)
    man = port_mesh.compile_manifest()
    assert len({e["key_fp"] for e in man}) == len(man)
    assert [e["compile_s"] for e in man] == sorted((e["compile_s"] for e in man), reverse=True)


def test_kernel_builds_and_loads_are_events():
    """A kernel build and a library load are closed `kernel:<name>`
    events with their seconds; `unload_all` makes the next load an event
    again."""
    from trino_tpu_torch.kernels import build
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    mark = OBSERVATORY.mark()
    ev = OBSERVATORY.record_kernel("locate_sorted", 0.25, "nvcc")
    OBSERVATORY.record_kernel("locate_sorted", 0.01, "load")
    new = OBSERVATORY.events_above(mark)
    assert [(e.step, e.key, e.closed) for e in new] == [
        ("kernel:locate_sorted", "nvcc locate_sorted", True),
        ("kernel:locate_sorted", "load locate_sorted", True),
    ]
    assert ev.wall_s == 0.25 and ev.bucket is None
    assert not OBSERVATORY.has_open()
    assert any(r[1] == "kernel:locate_sorted" for r in OBSERVATORY.rows())
    saved = dict(build._LOADED)
    try:
        build._LOADED.update({"b": object(), "a": object()})
        assert build.unload_all() == sorted(set(saved) | {"a", "b"})
        assert build._LOADED == {}
    finally:
        build._LOADED.update(saved)


def test_unit_cache_miss_opens_and_launch_closes():
    """A step-cache miss opens an event with its build seconds; the step's
    launch outside a statement closes it with its bucket."""
    import torch

    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.parallel.spmd import WorkerMesh, cached_spmd_step
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
    from trino_tpu_torch import types as T

    wm = WorkerMesh(2, "cpu")
    mark = OBSERVATORY.mark()
    fn = cached_spmd_step(wm, ("unit_observatory", time.time()), lambda: (lambda b: b))
    assert OBSERVATORY.has_open()
    b = Batch([Column(torch.zeros((2, 64), dtype=torch.int64), T.BIGINT)],
              torch.ones((2, 64), dtype=torch.bool))
    fn(b)
    (ev,) = OBSERVATORY.events_above(mark)
    assert ev.step == "unit_observatory" and ev.closed and ev.bucket == 64
    assert ev.mesh == (2, "cpu") and ev.wall_s >= ev.build_s >= 0.0


def test_lockgraph_wraps_observatory_audit_and_store_locks(meshes):
    from trino_tpu_torch.telemetry import audit
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
    from trino_tpu_torch.verify import lockgraph as L

    _, port_mesh = meshes
    store = port_mesh.profile_store
    with L.capture(runners=[port_mesh]) as g:
        assert isinstance(OBSERVATORY._lock, L.InstrumentedLock)
        assert isinstance(audit._seq_lock, L.InstrumentedLock)
        assert isinstance(store._lock, L.InstrumentedLock)
        port_mesh.execute("select count(*) from nation")
    assert not isinstance(store._lock, L.InstrumentedLock)
    g.assert_acyclic()
