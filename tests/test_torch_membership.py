"""The port's cluster membership, heartbeats, circuit breakers, typed
config sections and drain/shrink/grow against the JAX package.

The cases of tests/test_membership.py and the multi-host cases of
tests/test_fte.py (`test_heartbeat_detector`, `test_dead_worker_blocks_query`,
`test_remote_fte_resumes_from_spooled_fragments`).  The unit cases run once
per package (`pkg`) with the same inputs and the same injected clock and
prober; `test_state_machines_trace_equal_jax` drives both packages'
registry, detector and breakers through one script and holds every
transition, breaker state, membership event and liveness gauge equal.  The
HTTP cases run port WorkerServers on `device="cpu"` in this process
(ephemeral ports, no sleeps) and hold rows to the JAX LocalQueryRunner's.
"""

import importlib
import os
import pickle
import threading
import urllib.error
import urllib.request

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


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        mod(p, "config").reset_config()
        mod(p, "runtime.retry").BREAKERS.reset()
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()
    yield
    for p in PKGS:
        mod(p, "config").reset_config()
        mod(p, "runtime.retry").BREAKERS.reset()
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()


def _events(pkg, kind: str) -> float:
    return mod(pkg, "telemetry.metrics").membership_events_counter().value((kind,))


# -- typed config --------------------------------------------------------------


def test_config_defaults(pkg):
    cfg = mod(pkg, "config").ClusterConfig()
    assert (
        cfg.breaker.failure_threshold, cfg.breaker.cooldown_s,
        cfg.lifecycle.request_timeout_s, cfg.lifecycle.submit_timeout_s,
        cfg.lifecycle.cancel_timeout_s, cfg.lifecycle.probe_timeout_s,
        cfg.remote.submit_attempts, cfg.remote.fetch_attempts,
        cfg.remote.probe_ttl_s, cfg.remote.max_replans, cfg.remote.max_task_retries,
        cfg.worker.max_concurrent_tasks, cfg.worker.result_wait_s,
        cfg.worker.status_wait_s, cfg.worker.drain_grace_s,
        cfg.heartbeat.miss_threshold, cfg.heartbeat.interval_s,
    ) == (3, 5.0, 600.0, 60.0, 10.0, 5.0, 3, 3, 15.0, 8, 4, 4, 600.0, 1.0, 5.0, 3, 1.0)


def test_config_sections_describe_equal_jax():
    for section in ("BreakerConfig", "HeartbeatConfig", "LifecycleConfig",
                    "RemoteConfig", "WorkerConfig", "PrewarmConfig", "DictionaryConfig"):
        got = [getattr(mod(p, "config"), section)().describe() for p in PKGS]
        if section == "DictionaryConfig":
            # `dictionary.snapshot-path` is read by no code of the JAX
            # package, and the port leaves the dead knob out
            got[0] = [d for d in got[0] if d[0] != "dictionary.snapshot-path"]
            assert [d[0] for d in got[1]] == ["dictionary.max-inline-values"]
        assert got[0] == got[1], section


def test_config_resolution_order_env_props_default(pkg):
    props = {"breaker.failure-threshold": "5", "breaker.cooldown": "2.5"}
    env = {"TRINO_TPU_BREAKER_FAILURE_THRESHOLD": "9"}
    cfg = mod(pkg, "config").load_cluster_config(props, env=env)
    assert cfg.breaker.failure_threshold == 9
    assert cfg.breaker.cooldown_s == 2.5
    assert cfg.heartbeat.miss_threshold == 3


def test_config_per_worker_override_longest_token_wins(pkg):
    props = {
        "breaker.failure-threshold": "4",
        "breaker.failure-threshold@8123": "7",
        "breaker.failure-threshold@127.0.0.1:8123": "8",
        "worker.result-wait@tpch": "12",
    }
    cfg = mod(pkg, "config").load_cluster_config(props, env={})
    assert cfg.breaker.failure_threshold == 4
    assert cfg.breaker_for("http://127.0.0.1:8123").failure_threshold == 8
    assert cfg.breaker_for("http://10.0.0.2:8123").failure_threshold == 7
    assert cfg.breaker_for("http://10.0.0.2:9999").failure_threshold == 4
    assert cfg.section_for("worker", catalog="tpch").result_wait_s == 12.0
    assert cfg.section_for("worker", catalog="tpch_x").result_wait_s == 600.0


def test_config_bad_value_is_loud(pkg):
    with pytest.raises(ValueError, match="breaker.failure-threshold"):
        mod(pkg, "config").load_cluster_config({"breaker.failure-threshold": "many"}, env={})


def test_load_etc_installs_cluster_config(pkg, tmp_path):
    etc = tmp_path / "etc"
    etc.mkdir()
    (etc / "config.properties").write_text(
        "heartbeat.miss-threshold=6\nbreaker.cooldown=1.5\nlifecycle.request-timeout=50\n"
    )
    loaded = mod(pkg, "runtime.config").load_etc(str(etc))
    cfg = mod(pkg, "config").get_config()
    assert loaded.cluster.heartbeat.miss_threshold == cfg.heartbeat.miss_threshold == 6
    assert cfg.breaker.cooldown_s == 1.5
    L = mod(pkg, "runtime.lifecycle")
    assert L.request_timeout() == 50.0


def test_breakers_read_config_at_creation_time(pkg):
    C = mod(pkg, "config")
    R = mod(pkg, "runtime.retry")
    C.install_config(C.load_cluster_config({"breaker.failure-threshold": "1"}, env={}))
    b = R.BREAKERS.get("http://configured-worker")
    b.record_failure()
    assert b.state == "open"
    b2 = R.CircuitBreakerRegistry(failure_threshold=2).get("w")
    b2.record_failure()
    assert b2.state == "closed"
    C.install_config(C.load_cluster_config({"breaker.cooldown": "30"}, env={}))
    b3 = R.CircuitBreakerRegistry(failure_threshold=5).get("w-partial")
    assert (b3.failure_threshold, b3.cooldown_s) == (5, 30.0)


# -- membership registry and detector -----------------------------------------


def test_membership_state_machine_and_events(pkg):
    M = mod(pkg, "runtime.membership")
    m = M.ClusterMembership(clock=FakeClock())
    j0, d0, x0, r0 = (_events(pkg, k) for k in ("join", "drain", "death", "rejoin"))
    m.register("w1")
    m.register("w2")
    assert m.active_workers() == ["w1", "w2"]
    assert _events(pkg, "join") == j0 + 2
    assert m.drain("w1") is True and m.state("w1") == M.DRAINING
    assert m.active_workers() == ["w2"] and m.probe_targets() == ["w1", "w2"]
    assert _events(pkg, "drain") == d0 + 1
    assert m.drain("w1") is False
    assert m.mark_dead("w2") is True and m.mark_dead("w2") is False
    m.heartbeat("w2")
    assert m.state("w2") == M.DEAD and m.active_workers() == []
    assert _events(pkg, "death") == x0 + 1
    m.register("w2")
    assert m.state("w2") == M.ACTIVE and m.active_workers() == ["w2"]
    assert _events(pkg, "rejoin") == r0 + 1


def test_mark_dead_trips_breaker_and_rejoin_resets_it(pkg):
    M = mod(pkg, "runtime.membership")
    B = mod(pkg, "runtime.retry").BREAKERS
    m = M.ClusterMembership(["w1"])
    m.mark_dead("w1")
    assert B.get("w1").state == "open"
    m.register("w1")
    assert B.get("w1").state == "closed"


def test_snapshot_matches_nodes_table_shape(pkg):
    M = mod(pkg, "runtime.membership")
    clock = FakeClock()
    m = M.ClusterMembership(["w1"], clock=clock)
    clock.advance(2.0)
    ((wid, state, age, breaker),) = m.snapshot()
    assert (wid, state, breaker) == ("w1", M.ACTIVE, "closed")
    assert age == pytest.approx(2.0)


def _detector(pkg, m, prober, threshold=3):
    return mod(pkg, "runtime.membership").HeartbeatDetector(
        m, prober=prober,
        config=mod(pkg, "config").HeartbeatConfig(miss_threshold=threshold),
    )


def test_detector_declares_dead_at_miss_threshold(pkg):
    M = mod(pkg, "runtime.membership")
    B = mod(pkg, "runtime.retry").BREAKERS
    m = M.ClusterMembership(["w1", "w2"], clock=FakeClock())
    det = _detector(pkg, m, lambda w: w != "w1", threshold=3)
    assert [det.tick() for _ in range(3)] == [[], [], ["w1"]]
    assert (m.state("w1"), m.state("w2")) == (M.DEAD, M.ACTIVE)
    assert (B.get("w1").state, B.get("w2").state) == ("open", "closed")
    assert m.probe_targets() == ["w2"] and det.tick() == []


def test_detector_success_resets_miss_count(pkg):
    M = mod(pkg, "runtime.membership")
    m = M.ClusterMembership(["w1"], clock=FakeClock())
    answers = iter([False, False, True, False, False, True])
    det = _detector(pkg, m, lambda w: next(answers), threshold=3)
    for _ in range(6):
        det.tick()
    assert m.state("w1") == M.ACTIVE and det.rounds == 6


def test_flapping_worker_never_oscillates(pkg):
    M = mod(pkg, "runtime.membership")
    m = M.ClusterMembership(["w1"], clock=FakeClock())
    flap = {"n": 0}

    def prober(w):
        flap["n"] += 1
        return flap["n"] % 2 == 0

    det = _detector(pkg, m, prober, threshold=2)
    states = []
    for _ in range(10):
        det.tick()
        states.append(m.state("w1"))
    assert all(s == M.ACTIVE for s in states)
    det2 = _detector(pkg, m, lambda w: False, threshold=2)
    det2.tick(), det2.tick()
    assert m.state("w1") == M.DEAD
    det3 = _detector(pkg, m, lambda w: True, threshold=2)
    for _ in range(5):
        det3.tick()
    assert m.state("w1") == M.DEAD


def test_detector_success_never_closes_open_breaker(pkg):
    M = mod(pkg, "runtime.membership")
    B = mod(pkg, "runtime.retry").BREAKERS
    m = M.ClusterMembership(["wob"], clock=FakeClock())
    B.get("wob").trip()
    det = _detector(pkg, m, lambda w: True, threshold=3)
    for _ in range(5):
        det.tick()
    assert B.get("wob").state == "open" and m.state("wob") == M.ACTIVE


def test_draining_worker_death_never_trips_breaker(pkg):
    M = mod(pkg, "runtime.membership")
    B = mod(pkg, "runtime.retry").BREAKERS
    m = M.ClusterMembership(["wdx"], clock=FakeClock())
    m.drain("wdx")
    det = _detector(pkg, m, lambda w: False, threshold=3)
    for _ in range(4):
        det.tick()
    assert m.state("wdx") == M.DEAD and B.get("wdx").state != "open"


def test_register_resurrects_draining_worker(pkg):
    M = mod(pkg, "runtime.membership")
    m = M.ClusterMembership(["wd"], clock=FakeClock())
    m.drain("wd")
    assert m.active_workers() == []
    m.register("wd")
    assert m.state("wd") == M.ACTIVE and m.active_workers() == ["wd"]


def test_detector_restart_does_not_leak_probe_loop(pkg):
    M = mod(pkg, "runtime.membership")
    m = M.ClusterMembership(["wl"], clock=FakeClock())
    release = threading.Event()
    det = M.HeartbeatDetector(
        m, prober=lambda w: True,
        config=mod(pkg, "config").HeartbeatConfig(miss_threshold=3),
        sleep=lambda s: release.wait(5.0),
    )
    det.start()
    first_stop = det._stop
    det.stop()
    det.start()
    assert det._stop is not first_stop and first_stop.is_set()
    det.stop()
    release.set()


def test_detector_sets_alive_gauge(pkg):
    M = mod(pkg, "runtime.membership")
    gauge = mod(pkg, "telemetry.metrics").worker_alive_gauge
    m = M.ClusterMembership(["wg1"], clock=FakeClock())
    assert gauge().value(("wg1",)) == 1
    _detector(pkg, m, lambda w: False, threshold=1).tick()
    assert gauge().value(("wg1",)) == 0
    m.register("wg1")
    assert gauge().value(("wg1",)) == 1


def test_membership_event_vocabulary_preregistered():
    got = []
    for p in PKGS:
        metrics = mod(p, "telemetry.metrics")
        reg = metrics.MetricsRegistry()
        metrics._register_engine_metrics(reg)
        snap = reg.snapshot()
        for kind in metrics.MEMBERSHIP_EVENT_KINDS:
            assert snap.get('trino_tpu_membership_events_total{kind="%s"}' % kind) == 0
        got.append(metrics.MEMBERSHIP_EVENT_KINDS)
    assert got[0] == got[1]


def test_mesh_changed_error_is_not_retryable(pkg):
    M = mod(pkg, "runtime.membership")
    R = mod(pkg, "runtime.retry")
    assert not isinstance(M.MeshChangedError(dead=["w"]), R.RETRYABLE)
    assert not isinstance(M.MeshChangedError(dead=["w"]), ConnectionError)
    assert isinstance(M.WorkerDrainingError("x"), ConnectionRefusedError)


def _run_script(pkg) -> list:
    """One scripted life of a three-worker cluster: the registry, a
    detector with a scripted prober, the process breakers and the metrics,
    all on one fake clock.  Returns the observation after every step."""
    M = mod(pkg, "runtime.membership")
    R = mod(pkg, "runtime.retry")
    metrics = mod(pkg, "telemetry.metrics")
    clock = FakeClock()
    R.BREAKERS.clock = clock
    try:
        ids = [f"trace-{pkg}-w{i}" for i in range(3)]
        up = {w: True for w in ids}
        m = M.ClusterMembership(ids, clock=clock)
        det = _detector(pkg, m, lambda w: up[w], threshold=2)
        kinds = metrics.MEMBERSHIP_EVENT_KINDS
        base = {k: _events(pkg, k) for k in kinds}
        obs = []

        def look(step, result=None):
            obs.append((
                step, result,
                [(w[-2:], s, age, b) for w, s, age, b in m.snapshot()],
                [metrics.worker_alive_gauge().value((w,)) for w in ids],
                {k: _events(pkg, k) - base[k] for k in kinds},
                [R.BREAKERS.get(w).allow() for w in ids],
            ))

        look("start")
        up[ids[1]] = False
        for i in range(3):
            clock.advance(1.0)
            look(f"tick{i}", [w[-2:] for w in det.tick()])
        look("drain", m.drain(ids[2]))
        up[ids[2]] = False
        for i in range(3, 5):
            clock.advance(1.0)
            look(f"tick{i}", [w[-2:] for w in det.tick()])
        clock.advance(R.BREAKERS.get(ids[1]).cooldown_s + 0.5)
        look("cooldown")
        up[ids[1]] = True
        look("rejoin", m.register(ids[1]).state)
        R.BREAKERS.get(ids[0]).record_failure()
        look("flap")
        return obs
    finally:
        R.BREAKERS.clock = __import__("time").monotonic


def test_state_machines_trace_equal_jax():
    jax_trace, port_trace = (_run_script(p) for p in PKGS)
    assert port_trace == jax_trace
    assert any(step[1] == ["w1"] for step in port_trace)  # a death was seen


# -- drain refusal (a real port worker, no sleeps) -----------------------------


def _worker():
    from trino_tpu_torch.server.worker import WorkerServer

    return WorkerServer(port=0, device="cpu").start()


def test_drain_refuses_new_tasks_with_503():
    from trino_tpu_torch.parallel.remote import RemoteTaskClient
    from trino_tpu_torch.runtime.membership import WorkerDrainingError
    from trino_tpu_torch.runtime.retry import BREAKERS
    from trino_tpu_torch.server.worker import TaskDescriptor

    w = _worker()
    try:
        w.begin_drain(exit_on_idle=False)
        assert w.state == "DRAINING"
        with urllib.request.urlopen(f"{w.url}/v1/info", timeout=5.0) as r:
            assert b"DRAINING" in r.read()
        req = urllib.request.Request(f"{w.url}/v1/task", data=b"ignored", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5.0)
        assert ei.value.code == 503
        with pytest.raises(WorkerDrainingError):
            RemoteTaskClient(w.url, "t-drain").submit(TaskDescriptor("t-drain", None, []))
        assert BREAKERS.get(w.url).state == "closed"
        assert w.drained.wait(timeout=10.0)
    finally:
        w.shutdown()


def test_shutdown_endpoint_drains_and_exits():
    from trino_tpu_torch.config import get_config

    w = _worker()
    lingered = threading.Event()
    grace_seen = []

    def fake_sleep(s):
        grace_seen.append(s)
        lingered.set()

    w._sleep = fake_sleep
    req = urllib.request.Request(f"{w.url}/v1/worker/shutdown", method="PUT")
    with urllib.request.urlopen(req, timeout=5.0) as r:
        assert r.read() == b"DRAINING"
    assert w.drained.wait(timeout=10.0) and lingered.wait(timeout=10.0)
    assert grace_seen == [get_config().worker.drain_grace_s]


def test_submit_loses_drain_race_atomically():
    from trino_tpu_torch.server.worker import TaskDescriptor, WorkerDraining

    w = _worker()
    try:
        w.begin_drain(exit_on_idle=False)
        with pytest.raises(WorkerDraining):
            w.submit(TaskDescriptor("t-race", None, []))
        assert "t-race" not in w._tasks
    finally:
        w.shutdown()


def test_shutdown_and_submit_require_cluster_auth(monkeypatch):
    from trino_tpu_torch.server.worker import sign_body

    monkeypatch.setenv("TRINO_TPU_CLUSTER_SECRET", "s3cret")
    w = _worker()
    try:
        for path, method, body in (("/v1/worker/shutdown", "PUT", b""),
                                   ("/v1/task", "POST", pickle.dumps(None))):
            req = urllib.request.Request(w.url + path, data=body, method=method)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=5.0)
            assert ei.value.code == 401 and ei.value.read() == b"bad signature"
        assert w.state == "ACTIVE"
        req = urllib.request.Request(
            f"{w.url}/v1/worker/shutdown",
            headers={"X-Cluster-Auth": sign_body(b"s3cret", b"")}, method="PUT",
        )
        with urllib.request.urlopen(req, timeout=5.0) as r:
            assert r.read() == b"DRAINING"
    finally:
        w.shutdown()


def test_non_loopback_bind_needs_secret():
    from trino_tpu_torch.server.worker import WorkerServer

    with pytest.raises(ValueError, match="TRINO_TPU_CLUSTER_SECRET"):
        WorkerServer(port=0, host="0.0.0.0", device="cpu")


# -- shrink / grow / drain on a three-worker cluster --------------------------


@pytest.fixture()
def cluster3():
    ws = [_worker() for _ in range(3)]
    yield ws
    for w in ws:
        try:
            w.shutdown()
        except Exception:
            pass


def _mh(ws):
    from trino_tpu_torch.parallel.remote import MultiHostQueryRunner

    return MultiHostQueryRunner([w.url for w in ws], catalog="tpch", schema="tiny", device="cpu")


SQL = "select r_name, count(*) from region group by r_name"


@pytest.fixture(scope="module")
def want():
    from trino_tpu.runtime.runner import LocalQueryRunner

    return sorted(LocalQueryRunner(catalog="tpch", schema="tiny").execute(SQL).rows)


def test_shrink_replan_on_dead_worker(cluster3, want):
    from trino_tpu_torch.runtime.membership import DEAD
    from trino_tpu_torch.telemetry.metrics import membership_events_counter

    mh = _mh(cluster3)
    assert sorted(mh.execute(SQL).rows) == want
    assert len(mh.last_plan_workers) == 3 and mh.last_replans == 0
    cluster3[2].shutdown()
    mh._worker_health.clear()
    before = membership_events_counter().value(("shrink_replan",))
    assert sorted(mh.execute(SQL).rows) == want
    assert len(mh.last_plan_workers) == 2 and mh.last_replans >= 1
    assert membership_events_counter().value(("shrink_replan",)) == before + mh.last_replans
    assert mh.membership.state(cluster3[2].url) == DEAD
    assert sorted(mh.execute(SQL).rows) == want
    assert len(mh.last_plan_workers) == 2 and mh.last_replans == 0


def test_drain_excluded_from_next_mesh(cluster3, want):
    from trino_tpu_torch.runtime.membership import DRAINING

    mh = _mh(cluster3)
    mh.drain_worker(cluster3[0].url)
    assert sorted(mh.execute(SQL).rows) == want
    assert cluster3[0].url not in mh.last_plan_workers
    assert len(mh.last_plan_workers) == 2 and mh.last_replans == 0
    assert mh.membership.state(cluster3[0].url) == DRAINING


def test_grow_joins_next_query_mesh(cluster3, want):
    mh = _mh(cluster3[:2])
    assert sorted(mh.execute(SQL).rows) == want and len(mh.last_plan_workers) == 2
    mh.add_worker(cluster3[2].url)
    assert sorted(mh.execute(SQL).rows) == want
    assert cluster3[2].url in mh.last_plan_workers
    assert len(mh.last_plan_workers) == 3 and mh.last_replans == 0


@pytest.mark.parametrize("error", ["drain_503", "refused"])
def test_one_refused_submit_does_not_evict_live_worker(cluster3, want, error):
    """A 503 without a real drain, or one ECONNREFUSED, against a worker
    whose /v1/info still answers ACTIVE: another worker takes the task and
    the mesh stays W-wide."""
    from trino_tpu_torch.runtime.membership import ACTIVE, WorkerDrainingError
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR

    mh = _mh(cluster3)
    victim = cluster3[0].url
    exc = WorkerDrainingError if error == "drain_503" else ConnectionRefusedError
    FAILURE_INJECTOR.inject(f"submit:{victim}", times=1, error=exc)
    assert sorted(mh.execute(SQL).rows) == want
    assert mh.membership.state(victim) == ACTIVE
    assert mh.last_replans == 0 and len(mh.last_plan_workers) == 3


def test_breaker_open_worker_is_not_evicted(cluster3, want):
    from trino_tpu_torch.runtime.membership import ACTIVE
    from trino_tpu_torch.runtime.retry import BREAKERS

    mh = _mh(cluster3)
    cooling = cluster3[1].url
    BREAKERS.get(cooling).trip()
    assert sorted(mh.execute(SQL).rows) == want
    assert mh.membership.state(cooling) == ACTIVE and mh.last_replans == 0
    assert cooling in mh.last_plan_workers


def test_nodes_table_through_multihost_runner(cluster3, want):
    mh = _mh(cluster3)
    mh.drain_worker(cluster3[1].url)
    rows = mh.execute(
        "select node_id, state, heartbeat_age_s, breaker_state, prewarm "
        "from system.runtime.nodes"
    ).rows
    got = {r[0]: r for r in rows}
    assert got[cluster3[0].url][1] == "ACTIVE" and got[cluster3[1].url][1] == "DRAINING"
    assert all(r[3] == "closed" and r[4] is None and r[2] >= 0.0 for r in rows)
    assert sorted(mh.execute(SQL).rows) == want and len(mh.last_plan_workers) == 2


def test_nodes_table_reports_membership(pkg):
    M = mod(pkg, "runtime.membership")
    system = mod(pkg, "connectors.system")

    class _Stub:
        membership = M.ClusterMembership(["wa", "wb"], clock=FakeClock())
        prewarm = None

    _Stub.membership.drain("wb")
    rows = {r[0]: r for r in system.SystemConnector(runner=_Stub())._rows("nodes")}
    assert rows["wa"][1] == M.ACTIVE and rows["wb"][1] == M.DRAINING
    assert rows["wa"][4] is None
    assert all(len(r) == len(system._TABLES["nodes"]) for r in rows.values())


def test_mesh_nodes_table_lists_detector_workers():
    """The port's mesh lists its detector's workers (the JAX mesh's nodes
    table raises AttributeError: it reads a detector field that no longer
    exists)."""
    from trino_tpu_torch.parallel import DistributedQueryRunner

    m = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=3, device="cpu")
    rows = m.execute("select node_id, state, breaker_state from system.runtime.nodes").rows
    assert rows == [(f"worker-{i}", "ACTIVE", "closed") for i in range(3)]


def test_invalidate_mesh_scans_by_signature():
    from trino_tpu_torch.runtime.buffer_pool import POOL
    from trino_tpu_torch.runtime.membership import invalidate_mesh_scans

    with POOL.lock:
        POOL.device.entries[("mesh_scan", "sigA", None, ("s1",))] = (["b"], 0)
        POOL.device.entries[("mesh_scan", "sigA", None, ("s2",))] = (["b"], 0)
        POOL.device.entries[("mesh_scan", "sigB", None, ("s1",))] = (["b"], 0)
        POOL.device.entries[("other", "sigA")] = (["b"], 0)
    try:
        assert invalidate_mesh_scans("sigA") == 2
        with POOL.lock:
            keys = list(POOL.device.entries)
        assert ("mesh_scan", "sigB", None, ("s1",)) in keys and ("other", "sigA") in keys
        assert invalidate_mesh_scans() >= 1
        with POOL.lock:
            assert ("other", "sigA") in POOL.device.entries
    finally:
        with POOL.lock:
            POOL.device.entries.pop(("other", "sigA"), None)


def test_simple_types_unpickle_to_module_instances():
    """Plan fragments and page sets cross the tier as pickles, and the
    decoders test simple types by identity (`t is DATE`)."""
    from trino_tpu_torch import types as T

    for t in (T.DATE, T.TIMESTAMP, T.TIMESTAMP_TZ, T.BOOLEAN, T.UNKNOWN, T.BIGINT):
        assert pickle.loads(pickle.dumps(t)) is t
    assert pickle.loads(pickle.dumps(T.DecimalType(30, 2))) == T.DecimalType(30, 2)


def test_remote_module_has_no_knob_literals():
    """The port's parallel/remote.py holds no module-level numeric knob,
    under tools/lint_tpu.py's rule for the JAX module's path."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        lint_tpu = importlib.import_module("lint_tpu")
    finally:
        sys.path.pop(0)
    path = os.path.join(os.path.dirname(__file__), "..", "trino_tpu_torch", "parallel", "remote.py")
    rules = lint_tpu._rules_for_path("trino_tpu/parallel/remote.py")
    assert "module-level-knob" in rules
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    import ast

    linter = lint_tpu._Linter(path, source, rules=rules, relpath=path)
    linter.visit(ast.parse(source))
    assert [f for f in linter.findings if f.rule == "module-level-knob"] == []
    # the rule has teeth on this source: a knob literal added is flagged
    bad = source + "\nFETCH_ATTEMPTS = 7\n"
    linter = lint_tpu._Linter(path, bad, rules=rules, relpath=path)
    linter.visit(ast.parse(bad))
    assert [f.rule for f in linter.findings].count("module-level-knob") == 1


# -- tests/test_fte.py's multi-host cases --------------------------------------


def test_heartbeat_detector(pkg):
    F = mod(pkg, "runtime.fte")
    now = [0.0]
    det = F.HeartbeatFailureDetector(timeout_s=5.0, clock=lambda: now[0])
    det.register("w0")
    det.register("w1")
    assert det.failed_workers() == set()
    now[0] = 3.0
    det.heartbeat("w1")
    now[0] = 6.0
    assert det.failed_workers() == {"w0"}
    assert det.active_workers() == ["w1"]
    det.heartbeat("w0")
    assert det.failed_workers() == set()


def test_dead_worker_blocks_query():
    """A stale remote registration blocks the mesh's next query in both
    packages; a fresh heartbeat lets it run, with the JAX mesh's rows."""
    from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
    from trino_tpu_torch.parallel import DistributedQueryRunner

    runners = {
        "trino_tpu": JaxMesh(catalog="tpch", schema="tiny", n_workers=4),
        "trino_tpu_torch": DistributedQueryRunner(
            catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
    }
    rows = {}
    for p, r in runners.items():
        r.failure_detector.register("remote-worker-9")
        r.failure_detector.membership._workers["remote-worker-9"].last_heartbeat = -1e9
        with pytest.raises(RuntimeError, match="heartbeat"):
            r.execute(SQL)
        r.failure_detector.heartbeat("remote-worker-9")
        rows[p] = sorted(r.execute(SQL).rows)
    assert rows["trino_tpu_torch"] == rows["trino_tpu"] and len(rows["trino_tpu"]) == 5


def test_remote_fte_resumes_from_spooled_fragments(monkeypatch):
    from trino_tpu.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.parallel import remote as rmod

    ws = [_worker() for _ in range(3)]
    victim = ws[1]
    try:
        mh = _mh(ws)
        mh.properties.set("fault_tolerant_execution", True)
        q = "select count(*) from nation union all select count(*) from region"
        expected = LocalQueryRunner(catalog="tpch", schema="tiny").execute(q).rows
        orig_fetch = rmod._fetch_ok
        state = {"calls": 0}

        def killing_fetch(task, *a, **kw):
            state["calls"] += 1
            if state["calls"] == 4:
                victim.shutdown()
            return orig_fetch(task, *a, **kw)

        monkeypatch.setattr(rmod, "_fetch_ok", killing_fetch)
        assert sorted(mh.execute(q).rows) == sorted(expected)
        assert mh.last_task_retries >= 1
        assert mh.last_spool_hits >= 1
        assert mh.last_replans == 0
    finally:
        for w in ws:
            try:
                w.shutdown()
            except Exception:
                pass


# -- drain escalation, resize_mesh and the coordinator (tests/test_restart.py) --


def test_drain_force_kill_bounded():
    import time

    from trino_tpu_torch.config import install_config, load_cluster_config
    from trino_tpu_torch.server.worker import TaskDescriptor, _Task
    from trino_tpu_torch.telemetry.metrics import drain_force_kills_counter

    install_config(load_cluster_config(
        {"worker.drain-task-wait": "0.05", "worker.drain-grace": "0.0"}, env={}))
    w = _worker()
    sleeps = []
    w._sleep = sleeps.append
    stuck = _Task(TaskDescriptor("t_stuck", None, []))
    w._tasks["t_stuck"] = stuck
    before = drain_force_kills_counter().value()
    w.begin_drain()
    assert w.drained.wait(timeout=5.0)
    assert stuck.lifecycle.canceled and "drain force-kill" in stuck.lifecycle.kill_detail
    assert drain_force_kills_counter().value() == before + 1
    deadline = time.monotonic() + 5.0
    while w._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not w._thread.is_alive() and sleeps == [0.0]


def test_resize_mesh_validates_and_noop():
    """W < 1 raises as in the JAX mesh; the port's mesh is W logical
    workers on one device, so no device count bounds W from above."""
    from trino_tpu_torch.parallel import DistributedQueryRunner

    r = DistributedQueryRunner(n_workers=2, schema="tiny", device="cpu")
    with pytest.raises(ValueError):
        r.resize_mesh(0)
    wm = r.wm
    r.resize_mesh(2)
    assert r.wm is wm
    r.resize_mesh(12)
    assert r.wm.n == 12 and len(r.failure_detector.active_workers()) == 12


def test_shrink_unregisters_detector_entries():
    from trino_tpu_torch.parallel import DistributedQueryRunner

    r = DistributedQueryRunner(n_workers=4, schema="tiny", device="cpu")
    r.resize_mesh(2)
    assert sorted(r.failure_detector.active_workers()) == ["worker-0", "worker-1"]
    r.failure_detector.clock = lambda base=r.failure_detector.clock: base() + 60.0
    assert r.execute("select count(*) from region").rows == [(5,)]


def test_coordinator_starts_and_stops_detector():
    import time

    from trino_tpu_torch.parallel.remote import MultiHostQueryRunner
    from trino_tpu_torch.runtime.membership import HeartbeatDetector
    from trino_tpu_torch.server.coordinator import CoordinatorServer

    mh = MultiHostQueryRunner(["http://127.0.0.1:1"], schema="tiny", device="cpu")
    mh.failure_detector = HeartbeatDetector(
        mh.membership, prober=lambda w: True, sleep=lambda s: time.sleep(0.001)
    )
    srv = CoordinatorServer(runner=mh, port=0)
    srv.start()
    try:
        assert srv._detector_started
        deadline = time.monotonic() + 5.0
        while mh.failure_detector.rounds == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert mh.failure_detector.rounds > 0
    finally:
        srv.shutdown()
    assert mh.failure_detector._thread is None and not srv._detector_started


def test_coordinator_serves_multihost_runner(cluster3, monkeypatch):
    """A coordinator over the multi-host runner: signed register and drain
    reach its membership (unsigned ones get 401), and statements served
    over /v1/statement give the JAX local rows."""
    import json

    from trino_tpu.connectors.tpch.queries import QUERIES
    from trino_tpu.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.client import Client
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import sign_body

    monkeypatch.setenv("TRINO_TPU_CLUSTER_SECRET", "s3cret")
    mh = _mh(cluster3[:2])
    srv = CoordinatorServer(runner=mh, port=0)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"

        def put(path, body, signed):
            headers = {"X-Cluster-Auth": sign_body(b"s3cret", body)} if signed else {}
            req = urllib.request.Request(url + path, data=body, headers=headers, method="PUT")
            try:
                with urllib.request.urlopen(req, timeout=10.0) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        new = cluster3[2].url.encode()
        assert put("/v1/worker/register", new, False) == (
            401, {"error": {"message": "bad signature"}})
        assert put("/v1/worker/register", new, True) == (200, {"registered": cluster3[2].url})
        cols, rows = Client(url).execute(QUERIES[3])
        want = LocalQueryRunner(catalog="tpch", schema="tiny").execute(QUERIES[3]).rows
        assert len(mh.last_plan_workers) == 3
        assert [tuple(r) for r in rows] == want
        assert put("/v1/worker/drain", new, True) == (200, {"draining": cluster3[2].url})
        Client(url).execute("select count(*) from nation")
        assert len(mh.last_plan_workers) == 2
    finally:
        srv.shutdown()
