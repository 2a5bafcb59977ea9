"""The port's query lifecycle, events and retry against the JAX package's.

The cases of tests/test_lifecycle.py (less the spool GC, the lint rule and
the worker server's result wait) and of
tests/test_events_retry.py.  The unit cases run once per package (`pkg`)
with the same inputs, fake clocks and seeded rngs, and hold the same
outcomes; the runner cases run one statement sequence through the JAX
LocalQueryRunner and the port's (`device="cpu"`) at tpch.tiny and hold
the states, error types, error codes and rows equal.  Times are never
compared.  The session deadlines, cancel and the retry policy, which the
port accepted and ignored before, raise alike in both packages, locally
and on the port's 4-worker mesh.
"""

import importlib
import logging
import threading

import pytest

from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)

PKGS = ("trino_tpu", "trino_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeSleep:
    def __init__(self):
        self.calls: list = []

    def __call__(self, s: float) -> None:
        self.calls.append(s)


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean_globals():
    for p in PKGS:
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()
        mod(p, "runtime.retry").BREAKERS.reset()
    yield
    for p in PKGS:
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()
        mod(p, "runtime.retry").BREAKERS.reset()


# -- state machine ------------------------------------------------------------


def test_state_machine_happy_path(pkg):
    L = mod(pkg, "runtime.lifecycle")
    ctx = L.QueryContext("q1")
    assert ctx.state == L.QUEUED
    ctx.begin()
    assert ctx.state == L.RUNNING
    ctx.finishing()
    assert ctx.state == L.FINISHING
    ctx.transition(L.FINISHED)
    assert ctx.done


def test_state_machine_rejects_illegal_transitions(pkg):
    L = mod(pkg, "runtime.lifecycle")
    ctx = L.QueryContext("q1")
    with pytest.raises(L.InvalidStateTransition):
        ctx.transition(L.FINISHED)
    ctx.begin()
    ctx.transition(L.FAILED)
    for to in (L.RUNNING, L.FINISHED, L.CANCELED):
        with pytest.raises(L.InvalidStateTransition):
            ctx.transition(to)


def test_fail_maps_cancel_to_canceled_state(pkg):
    L = mod(pkg, "runtime.lifecycle")
    ctx = L.QueryContext("q1")
    ctx.begin()
    assert ctx.fail(L.QueryCanceledException("x")) == L.CANCELED
    ctx2 = L.QueryContext("q2")
    ctx2.begin()
    assert ctx2.fail(RuntimeError("boom")) == L.FAILED
    assert ctx2.fail(L.QueryCanceledException("late")) == L.CANCELED
    assert ctx2.state == L.FAILED


# -- deadlines + cancellation token -------------------------------------------


def test_deadline_enforced_by_check(pkg):
    L = mod(pkg, "runtime.lifecycle")
    clock = FakeClock()
    ctx = L.QueryContext("q1", max_run_time_s=10.0, clock=clock)
    ctx.check()
    clock.advance(10.5)
    with pytest.raises(L.QueryDeadlineExceeded, match="query_max_run_time"):
        ctx.check()
    assert ctx.kill_reason == "deadline"


def test_planning_deadline_separate_from_run_deadline(pkg):
    L = mod(pkg, "runtime.lifecycle")
    clock = FakeClock()
    ctx = L.QueryContext("q1", max_run_time_s=100.0, max_planning_time_s=5.0, clock=clock)
    clock.advance(6.0)
    ctx.check()
    with pytest.raises(L.QueryDeadlineExceeded, match="query_max_planning_time"):
        ctx.check_planning()


def test_cancel_aborts_at_next_check_and_first_reason_wins(pkg):
    L = mod(pkg, "runtime.lifecycle")
    ctx = L.QueryContext("q1")
    ctx.kill("memory", detail="killed by the low-memory killer")
    ctx.cancel()
    assert ctx.kill_reason == "memory"
    with pytest.raises(L.QueryKilledException, match="low-memory killer"):
        ctx.check()


def test_cancel_fans_out_to_registered_tasks(pkg):
    """A cancel, a kill and a failure cancel every registered remote task."""
    L = mod(pkg, "runtime.lifecycle")
    canceled = []

    class FakeTask:
        def __init__(self, n):
            self.n = n

        def cancel(self):
            canceled.append(self.n)

    ctx = L.QueryContext("q1")
    ctx.register_task(FakeTask(1))
    ctx.register_task(FakeTask(2))
    ctx.cancel()
    assert sorted(canceled) == [1, 2]
    ctx.register_task(FakeTask(3))
    ctx.cancel_tasks()
    assert sorted(canceled) == [1, 2, 3]
    ctx2 = L.QueryContext("q2")
    ctx2.begin()
    token = L.set_current(ctx2)
    try:
        L.register_task(FakeTask(4))  # the executing query's
    finally:
        L.reset_current(token)
    L.register_task(FakeTask(5))  # no executing query: a no-op
    ctx2.fail(RuntimeError("boom"))
    assert sorted(canceled) == [1, 2, 3, 4]


def test_http_timeout_derives_from_remaining_deadline(pkg):
    """The HTTP timeout follows the remaining deadline."""
    L = mod(pkg, "runtime.lifecycle")
    clock = FakeClock()
    ctx = L.QueryContext("q1", max_run_time_s=10.0, clock=clock)
    assert ctx.http_timeout(600.0) == pytest.approx(10.0)
    clock.advance(7.0)
    assert ctx.http_timeout(600.0) == pytest.approx(3.0)
    assert ctx.http_timeout(1.0) == pytest.approx(1.0)
    clock.advance(5.0)
    with pytest.raises(L.QueryDeadlineExceeded):
        ctx.http_timeout(600.0)
    assert L.QueryContext("q2").http_timeout(600.0) == 600.0


def test_request_timeout_uses_contextvar(pkg):
    """The request timeout reads the executing query's deadline."""
    L = mod(pkg, "runtime.lifecycle")
    assert L.request_timeout(42.0) == 42.0
    assert L.request_timeout() == 600.0  # the typed config's default
    clock = FakeClock()
    ctx = L.QueryContext("q1", max_run_time_s=5.0, clock=clock)
    token = L.set_current(ctx)
    try:
        assert L.request_timeout(600.0) == pytest.approx(5.0)
    finally:
        L.reset_current(token)
    assert L.request_timeout(600.0) == 600.0


# -- tracker ------------------------------------------------------------------


def test_tracker_reads_session_properties(pkg):
    L = mod(pkg, "runtime.lifecycle")
    S = mod(pkg, "runtime.session")
    clock = FakeClock()
    props = S.SessionProperties()
    props.set("query_max_run_time", 30)
    props.set("query_max_planning_time", 5)
    tracker = L.QueryTracker(clock=clock)
    ctx = tracker.create("q1", props)
    assert ctx.deadline == pytest.approx(clock.t + 30)
    assert ctx.planning_deadline == pytest.approx(clock.t + 5)
    assert tracker.get("q1") is ctx
    tracker.remove(ctx)
    assert tracker.get("q1") is None


def test_tracker_cancel_live_and_precancel_queued(pkg):
    L = mod(pkg, "runtime.lifecycle")
    tracker = L.QueryTracker()
    ctx = tracker.create("q1")
    assert tracker.cancel("q1") is True
    with pytest.raises(L.QueryCanceledException):
        ctx.check()
    assert tracker.cancel("q_future") is False
    late = tracker.create("q_future")
    with pytest.raises(L.QueryCanceledException, match="before execution"):
        late.check()


# -- error classification -----------------------------------------------------


def test_lifecycle_errors_classify_before_generic_rules(pkg):
    L = mod(pkg, "runtime.lifecycle")
    E = mod(pkg, "runtime.events")
    M = mod(pkg, "runtime.memory")
    assert E.classify_error(L.QueryCanceledException("x")) == "USER_ERROR"
    assert E.classify_error(L.QueryDeadlineExceeded("x")) == "RESOURCE_ERROR"
    assert E.classify_error(L.QueryKilledException("x")) == "RESOURCE_ERROR"
    assert E.classify_error(M.ExceededMemoryLimitException("x")) == "RESOURCE_ERROR"
    assert E.classify_error(ValueError("x")) == "USER_ERROR"
    assert E.classify_error(RuntimeError("x")) == "INTERNAL_ERROR"


def test_error_codes_and_recovery_actions_match_jax():
    """error_code_of / recovery_action over the errors both packages have."""
    out = {}
    for p in PKGS:
        L = mod(p, "runtime.lifecycle")
        R = mod(p, "runtime.retry")
        errs = [
            L.QueryCanceledException("x"), L.QueryDeadlineExceeded("x"),
            L.QueryQueuedTimeExceeded("x"), L.QueryKilledException("x"),
            R.StageFailedException("x"), ConnectionResetError("x"),
            TimeoutError("x"), RuntimeError("x"), ValueError("x"),
        ]
        out[p] = [(L.error_code_of(e), L.recovery_action(e)) for e in errs]
    assert out["trino_tpu_torch"] == out["trino_tpu"]
    assert ("TRANSIENT_FETCH", "retry") in out["trino_tpu_torch"]


# -- backoff ------------------------------------------------------------------


def test_backoff_full_jitter_schedule(pkg):
    import random

    R = mod(pkg, "runtime.retry")
    b = R.Backoff(base_s=0.1, cap_s=1.0, rng=random.Random(7), sleep=FakeSleep())
    for attempt in range(8):
        ceiling = min(1.0, 0.1 * 2**attempt)
        for _ in range(50):
            assert 0.0 <= b.delay(attempt) <= ceiling


def test_backoff_delays_equal_jax():
    import random

    seqs = []
    for p in PKGS:
        R = mod(p, "runtime.retry")
        b = R.Backoff(base_s=0.1, cap_s=1.0, rng=random.Random(11), sleep=FakeSleep())
        seqs.append([b.delay(k % 6) for k in range(40)])
    assert seqs[0] == seqs[1]


def test_backoff_wait_uses_injected_sleep(pkg):
    import random

    R = mod(pkg, "runtime.retry")
    sleep = FakeSleep()
    b = R.Backoff(base_s=0.5, cap_s=4.0, rng=random.Random(3), sleep=sleep)
    total = sum(b.wait(k) for k in range(5))
    assert sleep.calls and total == pytest.approx(b.total_wait_s)
    with pytest.raises(ValueError):
        R.Backoff(base_s=0.0)


# -- execute_with_retry -------------------------------------------------------


def test_retry_validates_attempts_and_backs_off(pkg):
    R = mod(pkg, "runtime.retry")
    sleep = FakeSleep()
    backoff = R.Backoff(base_s=0.1, sleep=sleep)
    with pytest.raises(ValueError, match="max_attempts"):
        R.execute_with_retry(lambda: 1, "QUERY", max_attempts=0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise R.InjectedFailure("boom")
        return "ok"

    assert R.execute_with_retry(flaky, "QUERY", max_attempts=4, backoff=backoff) == "ok"
    assert calls["n"] == 3
    assert len(sleep.calls) == 2


def test_retry_never_reruns_aborted_queries(pkg):
    L = mod(pkg, "runtime.lifecycle")
    R = mod(pkg, "runtime.retry")
    calls = {"n": 0}

    def canceled():
        calls["n"] += 1
        raise L.QueryCanceledException("user said stop")

    with pytest.raises(L.QueryCanceledException):
        R.execute_with_retry(canceled, "QUERY", max_attempts=4)
    assert calls["n"] == 1


def test_retry_exhaustion_raises_last_error(pkg):
    R = mod(pkg, "runtime.retry")
    sleep = FakeSleep()

    def always():
        raise R.InjectedFailure("persistent")

    with pytest.raises(R.InjectedFailure, match="persistent"):
        R.execute_with_retry(always, "QUERY", max_attempts=3, backoff=R.Backoff(sleep=sleep))
    assert len(sleep.calls) == 2


def test_task_policy_runs_once(pkg):
    """A TASK policy is stage-level retry, which the stage executor does:
    at the statement level it runs the statement once."""
    R = mod(pkg, "runtime.retry")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        raise R.InjectedFailure("boom")

    with pytest.raises(R.InjectedFailure):
        R.execute_with_retry(flaky, "TASK", max_attempts=4)
    assert calls["n"] == 1


# -- circuit breakers ---------------------------------------------------------


def test_breaker_trips_after_consecutive_failures(pkg):
    R = mod(pkg, "runtime.retry")
    b = R.CircuitBreaker(failure_threshold=3, cooldown_s=5.0, clock=FakeClock())
    b.record_failure()
    b.record_failure()
    assert b.state == "closed" and b.allow()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open" and not b.allow()


def test_breaker_half_open_probe_then_close_or_reopen(pkg):
    R = mod(pkg, "runtime.retry")
    clock = FakeClock()
    b = R.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=clock)
    b.record_failure()
    assert b.state == "open" and not b.allow()
    clock.advance(5.1)
    assert b.allow()
    assert b.state == "half_open"
    assert not b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    clock.advance(5.1)
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()
    with pytest.raises(ValueError):
        R.CircuitBreaker(failure_threshold=0)


def test_breaker_registry_states_surface_in_metrics(pkg):
    """Breaker states surface as the breaker_state gauge."""
    R = mod(pkg, "runtime.retry")
    REGISTRY = mod(pkg, "telemetry.metrics").REGISTRY
    reg = R.CircuitBreakerRegistry(failure_threshold=1, clock=FakeClock())
    assert reg.get("http://w1") is reg.get("http://w1")
    for _ in range(3):
        R.BREAKERS.get("http://w9").record_failure()
    rows = [r for r in REGISTRY.rows() if r[0] == "trino_tpu_breaker_state"]
    assert any("http://w9" in r[2] and r[3] == 2.0 for r in rows), rows
    assert "trino_tpu_breaker_state" in REGISTRY.render_prometheus()


# -- low-memory killer --------------------------------------------------------


class _Owner:
    def __init__(self):
        self.kills: list = []

    def kill(self, reason, detail=None):
        self.kills.append((reason, detail))


def _killer_pool(pkg, limit=1000):
    pool = mod(pkg, "runtime.memory").MemoryPool()
    pool.root.limit_bytes = limit
    pool.root.on_exceeded = mod(pkg, "runtime.lifecycle").LowMemoryKiller()
    return pool


def test_killer_shoots_largest_reservation_not_requester(pkg):
    L = mod(pkg, "runtime.lifecycle")
    kills = mod(pkg, "telemetry.metrics").memory_kills_counter()
    before = kills.value()
    pool = _killer_pool(pkg, 1000)
    big = pool.query_context("big")
    big.owner = _Owner()
    small = pool.query_context("small")
    small.owner = _Owner()
    big.add_bytes(800)
    small.add_bytes(100)
    small.add_bytes(300)
    assert big.owner.kills and big.owner.kills[0][0] == "memory"
    assert not small.owner.kills
    assert big.reserved == 0 and big.parent is None
    assert pool.root.reserved == 400
    assert kills.value() == before + 1
    ctx = L.QueryContext("big")
    ctx.kill("memory", detail="killed by the low-memory killer")
    with pytest.raises(L.QueryKilledException):
        ctx.check()


def test_killer_never_shoots_smaller_bystander(pkg):
    M = mod(pkg, "runtime.memory")
    pool = _killer_pool(pkg, 1000)
    big = pool.query_context("big")
    big.owner = _Owner()
    small = pool.query_context("small")
    small.owner = _Owner()
    small.add_bytes(100)
    big.add_bytes(800)
    with pytest.raises(M.ExceededMemoryLimitException):
        big.add_bytes(500)
    assert not small.owner.kills and not big.owner.kills
    assert pool.root.reserved == 900


def test_force_release_detaches_subtree_from_pool(pkg):
    pool = _killer_pool(pkg, 0)
    q = pool.query_context("q")
    op = q.child("op")
    op.add_bytes(500)
    assert pool.root.reserved == 500
    q.force_release()
    assert pool.root.reserved == 0 and q not in pool.root.query_children
    op.close()
    assert pool.root.reserved == 0


def test_per_query_budget_still_propagates_to_requester(pkg):
    M = mod(pkg, "runtime.memory")
    ctx = M.MemoryPool().query_context("q", limit_bytes=100)
    with pytest.raises(M.ExceededMemoryLimitException):
        ctx.add_bytes(200)


# -- failure injector ---------------------------------------------------------


def test_injector_latency_mode_uses_injectable_sleep(pkg):
    R = mod(pkg, "runtime.retry")
    sleep = FakeSleep()
    inj = R.FailureInjector(sleep=sleep)
    inj.inject_latency("fetch", 0.7, times=2)
    inj.maybe_fail("fetch:w1")
    inj.maybe_fail("fetch:w2")
    inj.maybe_fail("fetch:w3")
    assert sleep.calls == [0.7, 0.7]
    assert inj.visits["fetch:w1"] == 1
    inj.clear()
    assert inj.sleep is sleep


def test_injector_connection_flap_raises_retryable(pkg):
    R = mod(pkg, "runtime.retry")
    inj = R.FailureInjector()
    inj.inject_connection_flap("http", times=1)
    with pytest.raises(ConnectionResetError):
        inj.maybe_fail("http:w1")
    inj.maybe_fail("http:w1")
    assert isinstance(ConnectionResetError("x"), R.RETRYABLE)


# -- resource group timeout race ------------------------------------------------


def test_resource_group_timeout_raises_and_leaks_no_slot(pkg):
    G = mod(pkg, "runtime.resource_groups")
    g = G.ResourceGroup(G.ResourceGroupConfig("t", hard_concurrency=1))
    g.acquire()
    with pytest.raises(TimeoutError):
        g.acquire(timeout=0.01)
    assert len(g.queued) == 0
    g.release()
    g.acquire(timeout=0.01)
    g.release()


def test_resource_group_timeout_grant_race_hands_slot_onward(pkg):
    G = mod(pkg, "runtime.resource_groups")
    enqueued = threading.Event()
    released = threading.Event()

    class RacingGate(threading.Event):
        def wait(self, timeout=None):
            enqueued.set()
            released.wait(timeout=5.0)
            return False

    class RacingGroup(G.ResourceGroup):
        def _make_gate(self):
            return RacingGate()

    g = RacingGroup(G.ResourceGroupConfig("t", hard_concurrency=1))
    g.acquire()
    result: dict = {}

    def waiter():
        try:
            g.acquire(timeout=0.01)
            result["outcome"] = "admitted"
        except TimeoutError:
            result["outcome"] = "timeout"

    t = threading.Thread(target=waiter)
    t.start()
    assert enqueued.wait(timeout=5.0)
    g.release()
    released.set()
    t.join(timeout=5.0)
    assert result["outcome"] == "timeout"
    assert g.running == 0 and len(g.queued) == 0
    g.acquire(timeout=0.01)
    g.release()


# -- the runners: one statement sequence through both packages -------------------


@pytest.fixture(scope="module")
def runners():
    from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    return {
        "trino_tpu": JaxRunner(catalog="tpch", schema="tiny"),
        "trino_tpu_torch": LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    }


@pytest.fixture()
def both(runners):
    """Both runners with the session knobs this file sets put back."""
    yield runners
    for r in runners.values():
        for knob in ("query_max_run_time", "query_max_planning_time"):
            r.properties.set(knob, 0)
        r.properties.set("retry_policy", "NONE")
        r._query_context_cb = None


def _listen(r):
    listener = mod(type(r).__module__.split(".")[0], "runtime.events").CollectingEventListener()
    r.events.add(listener)
    return listener


def _outcome(r, sql):
    """(state, error type, error code, rows) of one statement, plus the
    exception's class name."""
    listener = _listen(r)
    try:
        rows = r.execute(sql).rows
        exc = None
    except Exception as e:  # noqa: BLE001 - the outcome is the point
        rows, exc = None, type(e).__name__
    finally:
        r.events.listeners.remove(listener)
    done = listener.completed[-1]
    return (done.state, done.error_type, done.error_code, rows, exc)


def _same(both, sql):
    got = {p: _outcome(r, sql) for p, r in both.items()}
    assert got["trino_tpu_torch"] == got["trino_tpu"], got
    return got["trino_tpu"]


def test_query_max_run_time_aborts_with_classified_event(both):
    for r in both.values():
        r.properties.set("query_max_run_time", 1e-9)
    state = _same(both, "select count(*) from region")
    assert state[:3] == ("FAILED", "RESOURCE_ERROR", "EXCEEDED_TIME_LIMIT")
    assert state[4] == "QueryDeadlineExceeded"
    for r in both.values():
        r.properties.set("query_max_run_time", 0)
    assert _same(both, "select count(*) from region")[3] == [(5,)]


def test_query_max_planning_time_property(both):
    for p, r in both.items():
        r.properties.set("query_max_planning_time", 1e-9)
        L = mod(p, "runtime.lifecycle")
        with pytest.raises(L.QueryDeadlineExceeded, match="planning"):
            r.execute("select count(*) from region")
        r.properties.set("query_max_planning_time", 0)


def test_cancel_surfaces_as_canceled_query(both):
    for r in both.values():
        r._query_context_cb = lambda ctx: ctx.cancel("canceled by test")
    state = _same(both, "select count(*) from region")
    assert state[:3] == ("CANCELED", "USER_ERROR", "USER_CANCELED")
    assert state[4] == "QueryCanceledException"


def test_system_runtime_queries_shows_kill_reason(both):
    for p, r in both.items():
        r.properties.set("query_max_run_time", 1e-9)
        with pytest.raises(mod(p, "runtime.lifecycle").QueryDeadlineExceeded):
            r.execute("select 1")
        r.properties.set("query_max_run_time", 0)
        rows = r.execute(
            "select state, error_type, error_code from system.runtime.queries "
            "where error_code is not null"
        ).rows
        assert ("FAILED", "RESOURCE_ERROR", "EXCEEDED_TIME_LIMIT") in rows


def test_tracker_registry_cleans_up_after_statement(both):
    for r in both.values():
        r.execute("select 1")
        assert r.query_tracker.live() == []


#: the fault this file holds: each session setting must stop the statement
#: with the JAX package's error code (the port used to return rows)
SESSION_ABORTS = {
    "run_time": ("set session query_max_run_time = 0.000001", "EXCEEDED_TIME_LIMIT"),
    "planning_time": ("set session query_max_planning_time = 0.000001", "EXCEEDED_TIME_LIMIT"),
    "cancel": (None, "USER_CANCELED"),
}


@pytest.mark.parametrize("case", list(SESSION_ABORTS))
def test_session_deadlines_and_cancel_raise_like_jax(both, case):
    setting, code = SESSION_ABORTS[case]
    for r in both.values():
        if setting is None:
            r._query_context_cb = lambda ctx: ctx.cancel()
        else:
            r.execute(setting)
    state = _same(both, "select count(*) from lineitem")
    assert state[2] == code and state[3] is None
    for r in both.values():
        r.execute("set session query_max_run_time = 0")
        r.execute("set session query_max_planning_time = 0")
    # the next statement runs, and the pool holds nothing of the aborted one
    assert _same(both, "select count(*) from lineitem")[3] == [(59823,)]
    from trino_tpu_torch.runtime.lifecycle import memory_pool

    assert memory_pool().root.reserved == 0


# -- events and retry (tests/test_events_retry.py) --------------------------------


def test_events_on_success(both):
    for r in both.values():
        listener = _listen(r)
        r.execute("select count(*) from region")
        r.events.listeners.remove(listener)
        assert len(listener.created) == 1
        done = listener.completed[0]
        assert done.state == "FINISHED" and done.rows == 1
        assert done.wall_s >= 0


def test_events_on_failure(both):
    state = _same(both, "select bogus_col from region")
    assert state[0] == "FAILED"
    for r in both.values():
        listener = _listen(r)
        with pytest.raises(Exception):
            r.execute("select bogus_col from region")
        r.events.listeners.remove(listener)
        assert "bogus_col" in listener.completed[0].error


def test_listener_failure_warns_once_and_does_not_propagate(both, caplog):
    for p, r in both.items():
        E = mod(p, "runtime.events")

        class _BrokenListener(E.CollectingEventListener):
            def query_completed(self, e):
                raise RuntimeError("sink is down")

        broken = _BrokenListener()
        healthy = E.CollectingEventListener()
        r.events.add(broken)
        r.events.add(healthy)
        caplog.clear()
        try:
            with caplog.at_level(logging.WARNING, logger=f"{p}.events"):
                r.execute("select count(*) from region")
                r.execute("select count(*) from region")
        finally:
            r.events.listeners.remove(broken)
            r.events.listeners.remove(healthy)
        assert len(healthy.completed) == 2
        warnings = [
            rec for rec in caplog.records
            if "_BrokenListener" in rec.getMessage()
            and "query_completed" in rec.getMessage()
        ]
        assert len(warnings) == 1
        assert not any("query_created" in rec.getMessage() for rec in caplog.records)


def test_error_classification_user_vs_internal(pkg):
    E = mod(pkg, "runtime.events")
    with pytest.raises(Exception) as ei:
        mod(pkg, "sql.parser").parse_statement("not sql at all")
    assert E.classify_error(ei.value) == "USER_ERROR"
    assert E.classify_error(mod(pkg, "planner.analyzer").AnalysisError("no such column")) == "USER_ERROR"
    assert E.classify_error(KeyError("missing table")) == "USER_ERROR"
    assert E.classify_error(NotImplementedError("stmt")) == "USER_ERROR"
    assert E.classify_error(RuntimeError("bug")) == "INTERNAL_ERROR"
    assert E.classify_error(ZeroDivisionError()) == "INTERNAL_ERROR"


def test_failed_event_carries_error_type_and_registry_counts(both):
    for p, r in both.items():
        c = mod(p, "telemetry").REGISTRY.counter("trino_tpu_queries_total")
        before = c.value(("FAILED", "USER_ERROR"))
        listener = _listen(r)
        with pytest.raises(Exception):
            r.execute("select bogus_col from region")
        r.events.listeners.remove(listener)
        done = listener.completed[-1]
        assert (done.state, done.error_type) == ("FAILED", "USER_ERROR")
        assert c.value(("FAILED", "USER_ERROR")) == before + 1


def test_completed_event_statistics_payload(both):
    for r in both.values():
        listener = _listen(r)
        r.execute("select count(*) from region")
        r.events.listeners.remove(listener)
        st = listener.completed[-1].statistics
        assert st is not None and st.rows == 1 and st.wall_s > 0
        assert st.spans > 0  # query_trace defaults on


def test_injected_failure_fails_without_retry(both):
    for p in PKGS:
        mod(p, "runtime.retry").FAILURE_INJECTOR.inject("scan:tiny.nation", times=1)
    state = _same(both, "select count(*) from nation")
    assert state[:2] == ("FAILED", "INTERNAL_ERROR") and state[4] == "InjectedFailure"


def test_query_retry_recovers(both):
    for p, r in both.items():
        mod(p, "runtime.retry").FAILURE_INJECTOR.inject("scan:tiny.nation", times=2)
        r.execute("set session retry_policy = 'QUERY'")
    assert _same(both, "select count(*) from nation")[3] == [(25,)]


def test_retry_exhaustion(both):
    for p, r in both.items():
        mod(p, "runtime.retry").FAILURE_INJECTOR.inject("scan:tiny.nation", times=100)
        r.execute("set session retry_policy = 'QUERY'")
    state = _same(both, "select count(*) from nation")
    assert state[4] == "InjectedFailure"


def test_task_retry_policy_runs_local_statement_once(both):
    """retry_policy = 'TASK' on a local runner: no stage executor, so the
    statement runs once and the injected failure surfaces, as in the JAX
    package."""
    for p, r in both.items():
        mod(p, "runtime.retry").FAILURE_INJECTOR.inject("scan:tiny.nation", times=1)
        r.execute("set session retry_policy = 'TASK'")
    state = _same(both, "select count(*) from nation")
    assert state[4] == "InjectedFailure"


# -- the 4-worker mesh ----------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    from trino_tpu_torch.parallel import DistributedQueryRunner

    return DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")


@pytest.mark.parametrize("knob", ["query_max_run_time", "query_max_planning_time"])
def test_mesh_deadline_matches_jax_local(both, mesh, knob):
    """A deadline on the mesh fails the statement with the JAX local
    runner's state, error type and code; the next statement runs."""
    sql = "select o_orderpriority, count(*) from orders group by 1"
    jax = both["trino_tpu"]
    jax.properties.set(knob, 1e-9)
    mesh.properties.set(knob, 1e-9)
    try:
        expected = _outcome(jax, sql)
        got = _outcome(mesh, sql)
    finally:
        jax.properties.set(knob, 0)
        mesh.properties.set(knob, 0)
    assert got[:3] == expected[:3] == ("FAILED", "RESOURCE_ERROR", "EXCEEDED_TIME_LIMIT")
    assert got[4] == expected[4]
    assert sorted(mesh.execute(sql).rows) == sorted(jax.execute(sql).rows)
    from trino_tpu_torch.runtime.lifecycle import memory_pool

    assert memory_pool().root.reserved == 0


def test_mesh_deadline_mid_run_stops_at_a_launch(mesh):
    """A run deadline that passes while the mesh runs (a fake clock that
    jumps at the first launch) stops the statement at its next check."""
    from trino_tpu_torch.parallel import spmd
    from trino_tpu_torch.runtime.lifecycle import QueryDeadlineExceeded

    t = {"now": 0.0}
    mesh.query_tracker.clock = lambda: t["now"]
    mesh.properties.set("query_max_run_time", 5.0)
    real = spmd.spmd_step

    def jumping(wm, step):
        run = real(wm, step)

        def go(*args):
            t["now"] = 100.0
            return run(*args)

        return go

    spmd.TRACE_CACHE.clear()
    spmd.spmd_step = jumping
    try:
        with pytest.raises(QueryDeadlineExceeded):
            mesh.execute("select count(*) from lineitem where l_quantity < 30")
    finally:
        spmd.spmd_step = real
        spmd.TRACE_CACHE.clear()
        mesh.properties.set("query_max_run_time", 0)
        import time

        mesh.query_tracker.clock = time.monotonic
    assert mesh.execute("select count(*) from lineitem").rows == [(59823,)]


def test_mesh_task_retry_policy_raises_by_name(mesh):
    """retry_policy = 'TASK' on the mesh runs now (tests/test_torch_fte.py):
    a stage that fails once is retried alone and the statement answers;
    a stage whose four attempts all fail raises StageFailedException, the
    error the JAX mesh raises, classified as the JAX package does."""
    from trino_tpu_torch.runtime.lifecycle import error_code_of
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR, StageFailedException

    mesh.execute("set session retry_policy = 'TASK'")
    try:
        FAILURE_INJECTOR.inject("stage:0", times=1)
        assert mesh.execute("select count(*) from nation").rows == [(25,)]
        FAILURE_INJECTOR.inject("stage:0", times=4)
        with pytest.raises(StageFailedException, match="after 4 attempts") as info:
            mesh.execute("select count(*) from nation")
        jax_error = mod("trino_tpu", "runtime.retry").StageFailedException("x")
        assert error_code_of(info.value) == mod(
            "trino_tpu", "runtime.lifecycle"
        ).error_code_of(jax_error)
    finally:
        FAILURE_INJECTOR.clear()
        mesh.execute("set session retry_policy = 'NONE'")
