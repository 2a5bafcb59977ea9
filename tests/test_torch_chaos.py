"""The worker cases of tests/test_chaos.py on the port's multi-host tier:
a worker killed mid-query (the query re-plans at W - 1), a drain landing
mid-query, a grow landing mid-query (it joins the next query's mesh
only), and the membership kill sweep (whichever worker dies, the answer
is the local rows or a classified failure, never a hang).

Port WorkerServers on `device="cpu"` in threads on ephemeral ports, the
port's MultiHostQueryRunner, the port's FAILURE_INJECTOR; every answer is
held to the JAX LocalQueryRunner's rows.  The module runs under the
port's instrumented locks (verify.lockgraph) and fails if their order
graph has a cycle.  Marked `slow` and `heavy` as the reference module
is: real HTTP workers and real injected latency.
"""

import threading
import time

import pytest

from test_torch_e2e import assert_same_rows
from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.parallel.remote import MultiHostQueryRunner
from trino_tpu_torch.runtime.lifecycle import QueryAbortedException
from trino_tpu_torch.runtime.retry import BREAKERS, FAILURE_INJECTOR
from trino_tpu_torch.server.worker import WorkerServer

pytestmark = [pytest.mark.slow, pytest.mark.heavy]

#: chaos queries must finish (or abort) well inside it
DEADLINE_S = 60.0

#: tests/test_chaos.py's QUERIES
QUERIES = [
    "select count(*), sum(l_quantity) from lineitem",
    "select l_returnflag, count(*), sum(l_extendedprice) "
    "from lineitem group by l_returnflag",
    "select count(*) from lineitem, orders where l_orderkey = o_orderkey",
]


@pytest.fixture(scope="module", autouse=True)
def lockgraph():
    from trino_tpu_torch.verify import lockgraph as lg

    with lg.capture() as graph:
        yield graph
    graph.assert_acyclic()


@pytest.fixture(scope="module")
def expected():
    jax = JaxRunner(catalog="tpch", schema="tiny")
    return {sql: jax.execute(sql).rows for sql in QUERIES}


@pytest.fixture(autouse=True)
def clean_chaos():
    FAILURE_INJECTOR.clear()
    BREAKERS.reset()
    yield
    FAILURE_INJECTOR.clear()
    BREAKERS.reset()


def _workers(n: int) -> list:
    return [WorkerServer(port=0, device="cpu").start() for _ in range(n)]


def _runner(ws) -> MultiHostQueryRunner:
    mh = MultiHostQueryRunner([w.url for w in ws], catalog="tpch", schema="tiny", device="cpu")
    mh.properties.set("query_max_run_time", DEADLINE_S)
    return mh


def _shutdown(ws) -> None:
    for w in ws:
        try:
            w.shutdown()
        except Exception:
            pass


def _match(rows, expected, sql) -> None:
    assert_same_rows(rows, expected[sql], ordered=False, float_rtol=1e-9)


def _killing(victim, fired: dict, orig):
    """A FAILURE_INJECTOR hook that shuts `victim` down at the first data
    plane pull: the worker dies under the running query."""

    def hook(point):
        if point.startswith("fetch:") and not fired["done"]:
            fired["done"] = True
            threading.Thread(target=victim.shutdown, daemon=True).start()
            time.sleep(0.2)  # let the socket actually close
        return orig(point)

    return hook


def test_chaos_worker_killed_mid_query_replans_at_w_minus_1(expected):
    """A worker dying mid-query re-plans the query against the survivors
    (W - 1), which still answers the local rows inside the deadline; the
    next query plans at W - 1 directly."""
    ws = _workers(3)
    victim = ws[2]
    fired = {"done": False}
    orig = FAILURE_INJECTOR.maybe_fail
    FAILURE_INJECTOR.maybe_fail = _killing(victim, fired, orig)
    try:
        mh = _runner(ws)
        sql = QUERIES[1]
        t0 = time.monotonic()
        got = mh.execute(sql).rows
        assert time.monotonic() - t0 < DEADLINE_S
        _match(got, expected, sql)
        assert fired["done"], "the kill hook never fired"
        assert mh.membership.state(victim.url) == "DEAD"
        assert len(mh.last_plan_workers) == 2, mh.last_plan_workers
        FAILURE_INJECTOR.maybe_fail = orig
        _match(mh.execute(sql).rows, expected, sql)
        assert mh.last_replans == 0 and len(mh.last_plan_workers) == 2
    finally:
        FAILURE_INJECTOR.maybe_fail = orig
        _shutdown(ws)


def test_chaos_drain_mid_query_finishes_or_replans(expected):
    """A drain landing mid-submission: the drainee finishes its running
    tasks and refuses new ones (no breaker vote); every query answers the
    local rows, and the drainee is out of the next mesh."""
    ws = _workers(3)
    drainee = ws[1]
    drained = {"done": False}
    orig = FAILURE_INJECTOR.maybe_fail

    def drain_hook(point):
        if point.startswith(f"submit:{drainee.url}") and not drained["done"]:
            drained["done"] = True
            drainee.begin_drain(exit_on_idle=False)
        return orig(point)

    FAILURE_INJECTOR.maybe_fail = drain_hook
    try:
        mh = _runner(ws)
        for sql in QUERIES:
            t0 = time.monotonic()
            got = mh.execute(sql).rows
            assert time.monotonic() - t0 < DEADLINE_S
            _match(got, expected, sql)
        assert drained["done"], "the drain hook never fired"
        assert BREAKERS.states().get(drainee.url, "closed") != "open"
        assert drainee.url not in mh.last_plan_workers
    finally:
        FAILURE_INJECTOR.maybe_fail = orig
        _shutdown(ws)


def test_chaos_grow_mid_query_joins_next_mesh_only(expected):
    """A worker registering while a query runs never joins that query's
    mesh; it serves from the next query on."""
    ws = _workers(2)
    w3 = _workers(1)[0]
    try:
        mh = _runner(ws)
        FAILURE_INJECTOR.inject_latency("fetch:", delay_s=0.5, times=2)
        grown = threading.Timer(0.2, mh.add_worker, args=(w3.url,))
        grown.start()
        sql = QUERIES[0]
        got = mh.execute(sql).rows
        grown.join()
        _match(got, expected, sql)
        assert w3.url not in mh.last_plan_workers
        FAILURE_INJECTOR.clear()
        _match(mh.execute(sql).rows, expected, sql)
        assert w3.url in mh.last_plan_workers and len(mh.last_plan_workers) == 3
    finally:
        _shutdown(ws + [w3])


@pytest.mark.parametrize("victim_idx", range(3))
def test_chaos_membership_sweep_kill_each_worker(expected, victim_idx):
    """Whichever worker dies mid-query, the single death is absorbed by
    the re-plan: the local rows, inside the deadline."""
    ws = _workers(3)
    fired = {"done": False}
    orig = FAILURE_INJECTOR.maybe_fail
    FAILURE_INJECTOR.maybe_fail = _killing(ws[victim_idx], fired, orig)
    try:
        mh = _runner(ws)
        sql = QUERIES[2]
        t0 = time.monotonic()
        try:
            got = mh.execute(sql).rows
        except (QueryAbortedException, RuntimeError, OSError) as e:
            pytest.fail(f"victim {victim_idx}: a single death must be absorbed "
                        f"by the re-plan, got {type(e).__name__}: {e}")
        assert time.monotonic() - t0 < DEADLINE_S, f"victim {victim_idx} blew the deadline"
        _match(got, expected, sql)
        assert fired["done"]
    finally:
        FAILURE_INJECTOR.maybe_fail = orig
        _shutdown(ws)
