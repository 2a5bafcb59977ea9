"""The port's concurrent dispatcher and resource groups against the JAX
package's: the cases of tests/test_dispatcher.py up to the coordinator
(weighted-fair scheduling, group concurrency, lanes, shedding, queue
deadlines, cancel while queued and racing admission, drain, the legacy
admission surface, shared transactions, the prewarm group, the
properties file and the group memory sub-pools) and the resource-groups
table, the queued span and the spill release on abort.

The scheduler cases drive a stand-in runner and run once per package
(`pkg`) with the same inputs; they hold the same admission orders,
counts and error codes.  The runner cases drive the port's
LocalQueryRunner (`device="cpu"`) on two dispatcher lanes and hold every
result to the JAX LocalQueryRunner's rows at tpch.tiny.  Real timeouts
are kept to tens of milliseconds.
"""

import importlib
import threading
import time

import pytest

PKGS = ("trino_tpu", "trino_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


class _DummyRunner:
    """Engine stand-in for scheduler-only tests: cloneable, no device."""

    def clone_for_dispatch(self):
        return _DummyRunner()


class _Pkg:
    """The dispatcher, resource-group and lifecycle names of one package."""

    def __init__(self, pkg: str):
        D = mod(pkg, "runtime.dispatcher")
        G = mod(pkg, "runtime.resource_groups")
        L = mod(pkg, "runtime.lifecycle")
        self.QueryDispatcher = D.QueryDispatcher
        self.QueryShedError = D.QueryShedError
        self.DispatcherStoppedError = D.DispatcherStoppedError
        self.ResourceGroupConfig = G.ResourceGroupConfig
        self.ResourceGroupManager = G.ResourceGroupManager
        self.ResourceGroup = G.ResourceGroup
        self.QueryCanceledException = L.QueryCanceledException
        self.QueryQueuedTimeExceeded = L.QueryQueuedTimeExceeded
        self.metrics = mod(pkg, "telemetry.metrics")
        self.pkg = pkg

    def manager(self, *configs):
        mgr = self.ResourceGroupManager()
        for c in configs:
            mgr.add(c)
        return mgr


def _run_all(dispatcher, tickets, fn):
    threads = []
    for t in tickets:
        def work(t=t):
            try:
                t.wait()
            except Exception:
                return
            dispatcher.run_admitted(t, lambda _r: fn(t.group_name))

        th = threading.Thread(target=work, daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive(), "admission wait hung"


# -- weighted-fair scheduling --------------------------------------------------


def _weighted_order(pkg: str) -> list:
    P = _Pkg(pkg)
    mgr = P.manager(
        P.ResourceGroupConfig("a", hard_concurrency=1, weight=3),
        P.ResourceGroupConfig("b", hard_concurrency=1, weight=1),
    )
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=1)
    gate = threading.Event()
    blocker = d.enqueue(group_name="global")
    blocker.wait()
    done = threading.Thread(
        target=lambda: d.run_admitted(blocker, lambda _r: gate.wait(10)), daemon=True,
    )
    done.start()
    tickets = [d.enqueue(group_name="a") for _ in range(9)]
    tickets += [d.enqueue(group_name="b") for _ in range(3)]
    order = []
    lock = threading.Lock()

    def record(group):
        with lock:
            order.append(group)

    gate.set()
    _run_all(d, tickets, record)
    done.join(timeout=10)
    return order


def test_weighted_fair_ratio_across_saturated_groups(pkg):
    order = _weighted_order(pkg)
    assert order.count("a") == 9 and order.count("b") == 3
    first8 = order[:8]
    assert first8.count("a") == 6 and first8.count("b") == 2, order


def test_group_hard_concurrency_bounds_parallelism(pkg):
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", hard_concurrency=2, max_queued=16))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=4)
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()

    def tracked(_group):
        with lock:
            peak["now"] += 1
            peak["max"] = max(peak["max"], peak["now"])
        time.sleep(0.02)
        with lock:
            peak["now"] -= 1

    tickets = [d.enqueue(group_name="g") for _ in range(6)]
    _run_all(d, tickets, tracked)
    assert peak["max"] == 2


def test_lanes_overlap_execution(pkg):
    P = _Pkg(pkg)
    mgr = P.ResourceGroupManager(P.ResourceGroupConfig("global", hard_concurrency=2))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=2)
    barrier = threading.Barrier(2, timeout=10)
    tickets = [d.enqueue() for _ in range(2)]
    _run_all(d, tickets, lambda _g: barrier.wait())
    assert not barrier.broken


# -- shedding + queue deadlines ------------------------------------------------


def test_full_queue_sheds_with_retry_after(pkg):
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", hard_concurrency=1, max_queued=1))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=1)
    d.enqueue(group_name="g")
    d.enqueue(group_name="g")
    shed0 = P.metrics.queries_shed_counter().value(("g",))
    with pytest.raises(P.QueryShedError) as ei:
        d.enqueue(group_name="g")
    assert ei.value.retryable and ei.value.retry_after_s > 0
    assert ei.value.error_code == "QUERY_QUEUE_FULL"
    assert P.metrics.queries_shed_counter().value(("g",)) == shed0 + 1
    mgr.add_user_rule("u", "g")
    assert d.shed_probe("u") is not None


def test_shed_probe_admits_when_idle_even_with_zero_queue(pkg):
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", hard_concurrency=1, max_queued=0))
    mgr.add_user_rule("u", "g")
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=1)
    assert d.shed_probe("u") is None
    t = d.enqueue(group_name="g")
    assert t.wait() is not None
    assert d.shed_probe("u") is not None
    d.release(t)


def test_queue_deadline_raises_exceeded_queued_time(pkg):
    P = _Pkg(pkg)
    d = P.QueryDispatcher(_DummyRunner(), P.manager(), lanes=1)
    blocker = d.enqueue()
    blocker.wait()
    n0 = P.metrics.query_queued_histogram().value()
    t = d.enqueue(queue_deadline_s=0.05)
    with pytest.raises(P.QueryQueuedTimeExceeded) as ei:
        t.wait()
    assert ei.value.error_code == "EXCEEDED_QUEUED_TIME_LIMIT"
    assert P.metrics.query_queued_histogram().value() == n0 + 1
    d.release(blocker)
    assert all(s["queued"] == 0 for s in d.stats())


def test_query_max_queued_time_session_property(pkg):
    """The queue deadline defaults to the primary runner's
    query_max_queued_time session property."""
    P = _Pkg(pkg)

    class _Props:
        def get(self, name):
            assert name == "query_max_queued_time"
            return 0.05

    class _Runner(_DummyRunner):
        properties = _Props()

    d = P.QueryDispatcher(_Runner(), P.manager(), lanes=1)
    blocker = d.enqueue()
    blocker.wait()
    t = d.enqueue()
    with pytest.raises(P.QueryQueuedTimeExceeded):
        t.wait()
    d.release(blocker)


# -- queued-query cancel -------------------------------------------------------


def test_cancel_while_queued_never_acquires_slot(pkg):
    P = _Pkg(pkg)
    d = P.QueryDispatcher(_DummyRunner(), P.manager(), lanes=1)
    blocker = d.enqueue()
    blocker.wait()
    admitted_before = d.stats()[0]["total_admitted"]
    t = d.enqueue()
    t.cancel()
    with pytest.raises(P.QueryCanceledException):
        t.wait()
    d.release(blocker)
    stats = {s["name"]: s for s in d.stats()}
    assert stats["global"]["total_admitted"] == admitted_before
    assert stats["global"]["queued"] == 0


def test_cancel_racing_admission_hands_slot_back(pkg):
    P = _Pkg(pkg)
    d = P.QueryDispatcher(_DummyRunner(), P.manager(), lanes=1)
    t = d.enqueue()
    t.cancel()
    with pytest.raises(P.QueryCanceledException):
        t.wait()
    stats = {s["name"]: s for s in d.stats()}
    assert stats["global"]["running"] == 0
    t2 = d.enqueue()
    assert t2.wait() is not None
    d.release(t2)


# -- drain ---------------------------------------------------------------------


def test_drain_fails_queued_classified_and_force_kills_running(pkg):
    P = _Pkg(pkg)
    d = P.QueryDispatcher(_DummyRunner(), P.manager(), lanes=1)
    running_ev = threading.Event()
    blocker = d.enqueue()
    blocker.wait()
    blocker.on_force_kill = running_ev.set
    th = threading.Thread(
        target=lambda: d.run_admitted(blocker, lambda _r: running_ev.wait(10)),
        daemon=True,
    )
    th.start()
    queued = d.enqueue()
    clean = d.drain(wait_s=0.05, grace_s=5.0)
    with pytest.raises(P.DispatcherStoppedError) as ei:
        queued.wait()
    assert ei.value.error_code == "SERVER_SHUTTING_DOWN"
    assert running_ev.is_set()
    assert clean
    th.join(timeout=10)
    with pytest.raises(P.DispatcherStoppedError):
        d.enqueue()


# -- legacy interop ------------------------------------------------------------


def test_legacy_release_wakes_queued_dispatcher_ticket(pkg):
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", hard_concurrency=1, max_queued=4))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=2)
    g = mgr.groups["g"]
    g.acquire()
    t = d.enqueue(group_name="g")
    admitted = threading.Event()

    def waiter():
        t.wait()
        admitted.set()

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.05)
    assert not admitted.is_set()
    g.release()
    assert admitted.wait(timeout=5)
    d.release(t)
    th.join(timeout=5)


def test_lanes_share_transaction_state():
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    primary = LocalQueryRunner(device="cpu")
    lane = primary.clone_for_dispatch()
    assert lane.transactions is primary.transactions
    assert lane.device == primary.device
    lane.execute("start transaction")
    assert primary.in_transaction
    primary.execute("commit")
    assert not lane.in_transaction


def test_mesh_runner_runs_on_one_lane():
    """A mesh runner cannot be cloned: the dispatcher over it has one lane,
    as in the JAX package."""
    from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
    from trino_tpu.runtime.dispatcher import QueryDispatcher as JaxDispatcher
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.runtime.dispatcher import QueryDispatcher

    port = DistributedQueryRunner(n_workers=4, device="cpu")
    assert port.clone_for_dispatch() is None
    assert QueryDispatcher(port, lanes=4).lanes == 1
    assert JaxDispatcher(JaxMesh(n_workers=4), lanes=4).lanes == 1


def test_legacy_acquire_shares_the_concurrency_limit(pkg):
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", hard_concurrency=1, max_queued=0))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=2)
    g = mgr.groups["g"]
    g.acquire()
    with pytest.raises(P.QueryShedError):
        d.enqueue(group_name="g")
    g.release()
    t = d.enqueue(group_name="g")
    assert t.wait() is not None
    d.release(t)


def test_system_admission_holds_primary_lane_while_users_flow(pkg):
    """JAX: a prewarm replay holds the primary lane while users flow.  The
    port has no prewarm, so system_admission raises by name (the idle
    system.prewarm group is still listed)."""
    P = _Pkg(pkg)
    d = P.QueryDispatcher(_DummyRunner(), P.manager(), lanes=2)
    if pkg == "trino_tpu_torch":
        with pytest.raises(NotImplementedError, match="prewarm"):
            d.system_admission()
        assert {s["name"]: s for s in d.stats()}["system.prewarm"]["running"] == 0
        t = d.enqueue()
        assert t.wait() is not None
        d.release(t)
        return
    with d.system_admission() as runner:
        assert runner is d.runner
        stats = {s["name"]: s for s in d.stats()}
        assert stats["system.prewarm"]["running"] == 1
        t = d.enqueue()
        assert t.wait() is not None
        d.release(t)
    stats = {s["name"]: s for s in d.stats()}
    assert stats["system.prewarm"]["running"] == 0


def test_resource_groups_from_properties(pkg):
    P = _Pkg(pkg)
    mgr = P.ResourceGroupManager.from_properties({
        "resource-groups.global.max-concurrency": "4",
        "resource-groups.etl.weight": "2",
        "resource-groups.etl.max-queued": "7",
        "resource-groups.etl.memory-limit-bytes": "1048576",
        "resource-groups.user.batch": "etl",
        "unrelated.key": "x",
    })
    assert mgr.default.config.hard_concurrency == 4
    etl = mgr.groups["etl"].config
    assert (etl.weight, etl.max_queued, etl.memory_limit_bytes) == (2, 7, 1048576)
    assert mgr.select("batch").config.name == "etl"
    assert mgr.select("adhoc").config.name == "global"
    with pytest.raises(ValueError):
        P.ResourceGroupManager.from_properties({"resource-groups.g.max-concurency": "4"})
    with pytest.raises(ValueError):
        P.ResourceGroupManager.from_properties({"resource-groups.user.u": "nope"})


# -- per-group memory sub-pools ------------------------------------------------


def _pool_with_groups(P):
    pool = mod(P.pkg, "runtime.memory").MemoryPool(limit_bytes=0)
    a = P.ResourceGroup(P.ResourceGroupConfig("a", memory_limit_bytes=1000)).memory_context(pool.root)
    b = P.ResourceGroup(P.ResourceGroupConfig("b", memory_limit_bytes=1000)).memory_context(pool.root)
    return pool, a, b


def _query_under(group_ctx, pool, name):
    q = group_ctx.child(name)
    q.is_query_root = True
    with pool.root._lock:
        group_ctx.query_children.append(q)
        pool.root.query_children.append(q)
    return q


class _Killable:
    def __init__(self):
        self.killed = None

    def kill(self, reason, detail=None):
        self.killed = (reason, detail)


def test_group_limit_kills_largest_in_group_never_bystander(pkg):
    P = _Pkg(pkg)
    pool, a, b = _pool_with_groups(P)
    q1 = _query_under(a, pool, "query:q1")
    q2 = _query_under(a, pool, "query:q2")
    q2.owner = _Killable()
    bystander = _query_under(b, pool, "query:by")
    bystander.owner = _Killable()
    bystander.add_bytes(900)
    q2.add_bytes(600)
    q1.add_bytes(600)
    assert q2.owner.killed is not None and q2.owner.killed[0] == "memory"
    assert bystander.owner.killed is None
    assert bystander.reserved == 900
    assert a.reserved == 600 and q1.reserved == 600
    assert a.on_exceeded.kill_log == [("a", "query:q2")]


def test_group_limit_requester_largest_fails_own_reservation(pkg):
    P = _Pkg(pkg)
    pool, a, _b = _pool_with_groups(P)
    q1 = _query_under(a, pool, "query:q1")
    q1.owner = _Killable()
    q1.add_bytes(800)
    with pytest.raises(mod(pkg, "runtime.memory").ExceededMemoryLimitException):
        q1.add_bytes(800)
    assert q1.owner.killed is None
    assert q1.reserved == 800


def test_group_revoke_tier_spills_own_group_only(pkg):
    P = _Pkg(pkg)
    S = mod(pkg, "runtime.spill")
    pool, a, b = _pool_with_groups(P)
    qa = _query_under(a, pool, "query:qa")
    qb = _query_under(b, pool, "query:qb")
    qa_op = qa.child("join_build")
    qb_op = qb.child("join_build")
    qa_op.add_bytes(700)
    qb_op.add_bytes(900)
    freed = {"a": 0, "b": 0}

    def spill_a():
        freed["a"] += 1
        qa_op.set_bytes(0)
        return 700

    def spill_b():
        freed["b"] += 1
        qb_op.set_bytes(0)
        return 900

    ha = S.REVOCABLES.register(S.RevocableOperator("join", qa_op, spill_a))
    hb = S.REVOCABLES.register(S.RevocableOperator("join", qb_op, spill_b))
    try:
        qa.add_bytes(600)
        assert freed == {"a": 1, "b": 0}
        assert qa.reserved == 600
        assert qb_op.reserved == 900
    finally:
        ha.finish()
        hb.finish()


def test_sibling_group_pools_never_overadmit_root(pkg):
    P = _Pkg(pkg)
    M = mod(pkg, "runtime.memory")
    pool = M.MemoryPool(limit_bytes=10_000)
    pool.root.on_exceeded = None
    groups = [
        P.ResourceGroup(P.ResourceGroupConfig(f"g{i}", memory_limit_bytes=8_000)).memory_context(pool.root)
        for i in range(4)
    ]
    for g in groups:
        g.on_exceeded = None
    violations = []

    def hammer(g):
        q = _query_under(g, pool, "query:h")
        for _ in range(200):
            try:
                q.add_bytes(173)
            except M.ExceededMemoryLimitException:
                q.set_bytes(0)
            with pool.root._lock:
                if pool.root.reserved > pool.root.limit_bytes:
                    violations.append(pool.root.reserved)
        q.set_bytes(0)

    threads = [threading.Thread(target=hammer, args=(g,), daemon=True) for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not violations
    assert pool.root.reserved == 0


def test_query_root_resolves_through_group_layer(pkg):
    P = _Pkg(pkg)
    pool, a, _b = _pool_with_groups(P)
    q = _query_under(a, pool, "query:q")
    op = q.child("aggregation")
    assert op.query_root() is q
    q.add_bytes(10)
    q.force_release()
    assert q not in a.query_children
    assert q not in pool.root.query_children
    assert a.reserved == 0 and pool.root.reserved == 0


def test_admitted_statement_reserves_under_its_group(pkg):
    """A statement run on a lane reserves its memory under its group's
    sub-pool (query_memory_context reads the group contextvar)."""
    L = mod(pkg, "runtime.lifecycle")
    P = _Pkg(pkg)
    mgr = P.manager(P.ResourceGroupConfig("g", memory_limit_bytes=1 << 20))
    d = P.QueryDispatcher(_DummyRunner(), mgr, lanes=1)
    t = d.enqueue(group_name="g")
    t.wait()
    seen = {}

    def run(_runner):
        ctx = L.QueryContext("q_group")
        tok = L.set_current(ctx)
        try:
            mem = L.query_memory_context()
            mem.add_bytes(100)
            seen["group_reserved"] = mgr.groups["g"].memory_context(
                L.memory_pool().root
            ).reserved
        finally:
            L.reset_current(tok)
            ctx.release_memory()

    d.run_admitted(t, run)
    assert seen["group_reserved"] == 100


# -- the runners ------------------------------------------------------------------


def test_system_resource_groups_table():
    from trino_tpu.runtime.dispatcher import QueryDispatcher as JaxDispatcher
    from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
    from trino_tpu_torch.runtime.dispatcher import QueryDispatcher
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    sql = (
        "select name, max_concurrency, weight from "
        "system.runtime.resource_groups order by name"
    )
    out = []
    for runner, disp in (
        (JaxRunner(), JaxDispatcher),
        (LocalQueryRunner(device="cpu"), QueryDispatcher),
    ):
        runner.dispatcher = disp(runner, lanes=2)
        out.append(runner.execute(sql).rows)
    assert out[0] == out[1]
    names = [r[0] for r in out[1]]
    assert "global" in names and "system.prewarm" in names


def test_queued_span_recorded_in_trace():
    from trino_tpu_torch.runtime import lifecycle
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    r = LocalQueryRunner(device="cpu")
    token = lifecycle.set_admission_info(("global", 0.01))
    try:
        r.execute("select 1")
    finally:
        lifecycle.reset_admission_info(token)
    names = [e["name"] for e in r.last_trace["traceEvents"]]
    assert "queued" in names and "query" in names


def test_mid_wave_kill_leaves_spill_dir_empty(tmp_path):
    from trino_tpu_torch.config import install_config, load_cluster_config, reset_config
    from trino_tpu_torch.runtime.lifecycle import QueryDeadlineExceeded, memory_pool
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.telemetry.metrics import spill_bytes_counter

    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    install_config(load_cluster_config({"memory.spill-dir": str(spill_dir)}, env={}))
    try:
        r = LocalQueryRunner(catalog="tpch", schema="tiny", target_splits=2, device="cpu")
        r.properties.set("query_max_memory", 200_000)
        r.properties.set("memory_wave_partitions", 2)
        r.properties.set("query_max_run_time", 5.0)
        spill0 = spill_bytes_counter().value()

        def clock():
            return 1000.0 if spill_bytes_counter().value() > spill0 else 0.0

        r.query_tracker.clock = clock
        with pytest.raises(QueryDeadlineExceeded):
            r.execute(
                "select o_orderpriority, count(*) from orders join "
                "lineitem on o_orderkey = l_orderkey group by o_orderpriority"
            )
        assert spill_bytes_counter().value() > spill0
        assert list(spill_dir.rglob("*.npz")) == []
        assert memory_pool().root.reserved == 0
    finally:
        reset_config()


QUERIES = {
    "nations": "select n_regionkey, count(*) from nation group by n_regionkey order by 1",
    "orders": "select o_orderpriority, count(*), sum(o_totalprice) from orders "
              "group by 1 order by 1",
    "lineitem": "select l_returnflag, sum(l_quantity) from lineitem group by 1 order by 1",
}


def test_two_lanes_two_groups_equal_jax_rows():
    """Two lanes over one port runner, `etl` (weight 1, one at a time) and
    `adhoc` (weight 3, two at a time): six threads submit twelve
    statements; every result equals the JAX local rows, the
    resource-groups table counts them, and a flooded third group sheds."""
    from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
    from trino_tpu_torch.runtime.dispatcher import QueryDispatcher, QueryShedError
    from trino_tpu_torch.runtime.resource_groups import (
        ResourceGroupConfig,
        ResourceGroupManager,
    )
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    jax = JaxRunner(catalog="tpch", schema="tiny")
    expected = {k: jax.execute(sql).rows for k, sql in QUERIES.items()}
    runner = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    mgr = ResourceGroupManager()
    mgr.add(ResourceGroupConfig("etl", hard_concurrency=1, weight=1, max_queued=16))
    mgr.add(ResourceGroupConfig("adhoc", hard_concurrency=2, weight=3, max_queued=16))
    mgr.add(ResourceGroupConfig("flood", hard_concurrency=1, weight=1, max_queued=1))
    d = QueryDispatcher(runner, mgr, lanes=2)
    runner.dispatcher = d
    assert d.lanes == 2
    names = list(QUERIES)
    jobs = [(("etl", "adhoc")[i % 2], names[i % 3]) for i in range(12)]
    results, errors = [], []
    lock = threading.Lock()

    def client(k):
        for group, name in jobs[k::6]:
            try:
                t = d.enqueue(group_name=group)
                t.wait()
                res = d.run_admitted(t, lambda r, name=name: r.execute(QUERIES[name]))
                with lock:
                    results.append((name, res.rows))
            except Exception as e:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == 12
    for name, rows in results:
        assert rows == expected[name], name
    stats = {
        row[0]: row[1:] for row in runner.execute(
            "select name, total_admitted, running, queued from system.runtime.resource_groups"
        ).rows
    }
    assert stats["etl"][0] + stats["adhoc"][0] == 12
    # the flooded group: one runs, one queues, the next sheds
    hold = d.enqueue(group_name="flood")
    hold.wait()
    queued = d.enqueue(group_name="flood")
    with pytest.raises(QueryShedError):
        d.enqueue(group_name="flood")
    d.release(hold)
    queued.wait()
    d.release(queued)
    assert d.drain(wait_s=1.0, grace_s=0.0)
