"""The port's concurrency analyzer (trino_tpu_torch/verify/concurrency.py)
and lock-order graph (trino_tpu_torch/verify/lockgraph.py) against the
JAX package's.

The snippet cases of tests/test_concurrency.py run through both packages'
modules (`pkg`) and must give the same findings, edges and cycles; the
repository cases run over `trino_tpu_torch/` with the port's own baseline;
the lock-graph cases add the port's RLock wrapper (owner and count, the
Condition protocol) and its process-wide locks, and the dispatcher's
two-lane run over the port's LocalQueryRunner is captured and must be
acyclic.  Everything is deterministic: the lock-order tests prove a
deadlock from ORDER, never from an interleaving."""

from __future__ import annotations

import importlib
import json
import os
import threading

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("trino_tpu", "trino_tpu_torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def conc(pkg: str):
    return importlib.import_module(f"{pkg}.verify.concurrency")


def lg(pkg: str):
    return importlib.import_module(f"{pkg}.verify.lockgraph")


def _findings(pkg: str, src: str):
    C = conc(pkg)
    reports, threads, edges = C.analyze_source("mod.py", src)
    return C.unguarded_findings(reports), threads, edges


GUARDED = """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
        self.sink = None

    def add(self, x):
        with self._lock:
            self._items.append(x)

    def drain(self):
        out = self._items  # unguarded read
        self._items = []   # unguarded write
        return out
"""

SNIPPETS = {
    "guarded": GUARDED,
    "init_exempt": """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.cfg = 1
    def read(self):
        with self._lock:
            a = self.cfg   # guarded read of an attr nobody mutates
        return self.cfg    # unguarded read: still fine (immutable)
""",
    "attribute_calls": """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.clock = None
        self.n = 0
    def tick(self):
        with self._lock:
            self.n += 1
            now = self.clock()
    def outside(self):
        return self.clock()   # calling an attr is not a state access
""",
    "self_alias": """
import threading
class Server:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = "ACTIVE"
        server = self

        class Handler:
            def handle(self):
                return server.state   # cross-thread read via the alias

    def drain(self):
        with self._lock:
            self.state = "DRAINING"
""",
    "nested_def": """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.x = 0
    def spawn(self):
        with self._lock:
            self.x = 1
            def waiter():
                return self.x   # runs later, on another thread: unguarded
            return waiter
""",
    "threads": """
import threading
def go(fn):
    threading.Thread(target=fn).start()
    threading.Thread(target=fn, name="ok").start()
    threading.Thread(target=fn, daemon=True).start()
    threading.Thread(target=fn, name="ok", daemon=True).start()
""",
    "order_cycle": """
import threading
class A:
    def __init__(self, peer_lock):
        self._lock = threading.Lock()
        self._peer_lock = peer_lock  # adopted lock
    def forward(self):
        with self._lock:
            with self._peer_lock:
                pass
    def backward(self):
        with self._peer_lock:
            with self._lock:
                pass
""",
    "rlock_state": """
import threading
class Gate:
    def __init__(self):
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self.depth = 0
    def enter(self):
        with self._lock:
            self.depth += 1
    def peek(self):
        return self.depth
""",
}


def _summary(pkg: str, src: str) -> tuple:
    found, threads, edges = _findings(pkg, src)
    C = conc(pkg)
    return (
        [(f.line, f.rule, f.key, f.message) for f in found],
        # the thread message's reason clause is reworded in the port
        [(f.line, f.rule, f.message.split(" — ")[0]) for f in threads],
        list(edges),
        C.find_cycles(edges),
    )


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_snippet_findings_equal_jax(name):
    """Both analyzers give the same findings, thread findings, edges and
    cycles on every snippet."""
    assert _summary("trino_tpu_torch", SNIPPETS[name]) == _summary("trino_tpu", SNIPPETS[name])


class TestGuardedStateInference:
    def test_flags_unguarded_read_and_write(self, pkg):
        found, _, _ = _findings(pkg, GUARDED)
        kinds = {(f.line, "read" in f.message) for f in found}
        assert len(found) == 2
        assert all(f.rule == "unguarded-state" for f in found)
        assert all(f.key == "mod.py:Box._items" for f in found)
        assert {True, False} == {r for _, r in kinds}

    def test_init_exempt_and_attribute_calls(self, pkg):
        assert _findings(pkg, SNIPPETS["init_exempt"])[0] == []
        assert _findings(pkg, SNIPPETS["attribute_calls"])[0] == []

    def test_self_alias_reaches_nested_class(self, pkg):
        found, _, _ = _findings(pkg, SNIPPETS["self_alias"])
        assert len(found) == 1
        assert found[0].key == "mod.py:Server.state"

    def test_mutator_method_is_a_write(self, pkg):
        found, _, _ = _findings(pkg, GUARDED)
        src = GUARDED.replace("with self._lock:\n            ", "")
        none_found, _, _ = _findings(pkg, src)
        assert found and none_found == []

    def test_line_and_def_level_allow(self, pkg):
        C = conc(pkg)
        src = GUARDED.replace(
            "out = self._items  # unguarded read",
            "out = self._items  # lint: allow(unguarded-state)",
        )
        reports, _, _ = C.analyze_source("mod.py", src)
        raw = C.unguarded_findings(reports)
        assert len(raw) == 2  # suppression applies at the gate, not here
        allow = C._allowances(src)
        scopes = C._scope_index(src)
        live = [f for f in raw if not C._suppressed(f, allow, scopes)]
        assert len(live) == 1

    def test_nested_def_resets_held_locks(self, pkg):
        found, _, _ = _findings(pkg, SNIPPETS["nested_def"])
        assert len(found) == 1
        assert "read" in found[0].message

    def test_rlock_guards_state(self, pkg):
        """An RLock (with a Condition over it) guards state like a Lock."""
        found, _, _ = _findings(pkg, SNIPPETS["rlock_state"])
        assert [f.key for f in found] == ["mod.py:Gate.depth"]

    def test_baseline_split(self, pkg):
        C = conc(pkg)
        found, _, _ = _findings(pkg, GUARDED)
        new, stale = C.apply_baseline(found, {"mod.py:Box._items": "drained by the single owner"})
        assert new == [] and stale == []
        new, stale = C.apply_baseline(found, {"mod.py:Box.other": "gone"})
        assert len(new) == 2 and stale == ["mod.py:Box.other"]


class TestThreadDiscipline:
    def test_flags_missing_name_and_daemon(self, pkg):
        _, threads, _ = _findings(pkg, SNIPPETS["threads"])
        assert len(threads) == 3
        assert any("name and daemon" in t.message for t in threads)


class TestStaticLockOrder:
    def test_nested_with_inconsistent_order_is_a_cycle(self, pkg):
        _, _, edges = _findings(pkg, SNIPPETS["order_cycle"])
        cycles = conc(pkg).find_cycles(edges)
        assert cycles, edges
        flat = {n for cyc in cycles for n in cyc}
        assert "A._lock" in flat and "A._peer_lock" in flat


# -- the port's tree -----------------------------------------------------------


@pytest.fixture(scope="module")
def port_tree():
    """(findings, lock-order edges) of the three passes over the port."""
    from trino_tpu_torch.verify import concurrency as C

    return C.analyze_paths(list(C.PATHS), root=REPO_ROOT)


class TestPortTree:
    def test_port_tree_is_triaged(self, port_tree):
        """No finding over trino_tpu_torch/ outside the port's baseline, and
        every baseline entry carries its one-line reason."""
        from trino_tpu_torch.verify import concurrency as C

        with open(C.BASELINE_PATH) as fh:
            baseline = json.load(fh)["unguarded_state"]
        assert all(isinstance(v, str) and v for v in baseline.values())
        new, stale = C.apply_baseline(port_tree[0], baseline)
        assert new == [], "\n".join(str(f) for f in new)
        assert stale == [], f"stale baseline entries: {stale}"

    def test_port_threads_are_attributable(self, port_tree):
        assert [f for f in port_tree[0] if f.rule == "thread-discipline"] == []

    def test_port_static_order_is_acyclic(self, port_tree):
        """The port's static nesting: the dispatcher's scheduler lock wraps
        the resource group's admission lock, as in the JAX package."""
        findings, edges = port_tree
        assert [f for f in findings if f.rule == "lock-order-cycle"] == []
        assert ("QueryDispatcher._lock", "QueryDispatcher.lock") in {
            (a, b) for a, b, _ in edges
        }

    def test_allow_comments_are_honoured(self):
        """The port's `# lint: allow(unguarded-state)` lines (the
        dispatcher's lane bookkeeping) are findings before suppression and
        none after it."""
        from trino_tpu_torch.verify import concurrency as C

        path = os.path.join(REPO_ROOT, "trino_tpu_torch", "runtime", "dispatcher.py")
        src = open(path).read()
        reports, _, _ = C.analyze_source("dispatcher.py", src)
        raw = C.unguarded_findings(reports)
        allow, scopes = C._allowances(src), C._scope_index(src)
        assert raw
        assert [f for f in raw if not C._suppressed(f, allow, scopes)] == []

    def test_entry_point_exits_zero(self, capsys):
        from trino_tpu_torch.verify import concurrency as C

        assert C.main(["--root", REPO_ROOT, "--check-stale"]) == 0
        assert "concurrency: 0 finding(s)" in capsys.readouterr().out


# -- the lock graph ------------------------------------------------------------


class TestLockGraph:
    def test_seeded_deadlock_fires_the_detector(self, pkg):
        L = lg(pkg)
        g = L.LockGraph()
        a = L.InstrumentedLock("engine", g)
        b = L.InstrumentedLock("state", g)
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert g.cycles() == [["engine", "state", "engine"]]
        with pytest.raises(L.LockOrderViolation) as ei:
            g.assert_acyclic()
        assert "engine -> state" in str(ei.value)
        assert "test_torch_concurrency.py" in str(ei.value)

    def test_consistent_order_across_threads_is_acyclic(self, pkg):
        L = lg(pkg)
        g = L.LockGraph()
        a = L.InstrumentedLock("a", g)
        b = L.InstrumentedLock("b", g)

        def use():
            with a:
                with b:
                    pass

        ts = [threading.Thread(target=use, name=f"t{i}", daemon=True) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        g.assert_acyclic()
        assert g.edges() and all(k == ("a", "b") for k in g.edges())

    def test_reentrant_and_nonblocking_protocol(self, pkg):
        L = lg(pkg)
        g = L.LockGraph()
        a = L.InstrumentedLock("a", g, inner=threading.RLock())
        with a:
            with a:  # reentrant: no self-edge
                pass
        b = L.InstrumentedLock("b", g)
        assert b.acquire(blocking=False)
        assert b.locked()
        b.release()
        assert not b.locked()
        assert g.cycles() == []

    def test_failed_try_acquire_records_no_edge(self, pkg):
        L = lg(pkg)
        g = L.LockGraph()
        a = L.InstrumentedLock("a", g)
        b = L.InstrumentedLock("b", g)
        with a:
            with b:
                pass
        a._inner.acquire()  # someone else holds a
        try:
            with b:
                assert not a.acquire(blocking=False)
        finally:
            a._inner.release()
        assert g.cycles() == []
        with b:
            assert a.acquire(blocking=False)
            a.release()
        assert ("b", "a") in g.edges()
        assert g.cycles()

    def test_capture_instruments_new_locks_and_restores(self, pkg):
        L = lg(pkg)
        real = threading.Lock
        with L.capture(singletons=False) as g:
            l1 = threading.Lock()
            l2 = threading.Lock()
            with l1:
                with l2:
                    pass
        assert threading.Lock is real
        assert len(g.edges()) == 1
        ((outer, inner),) = g.edges()
        assert outer.startswith("lock@") and inner.startswith("lock@")

    def test_instrument_attr_wraps_in_place(self, pkg):
        L = lg(pkg)

        class Obj:
            def __init__(self):
                self._lock = threading.Lock()

        g = L.LockGraph()
        o = Obj()
        restore = L.instrument_attr(o, "_lock", "Obj._lock", g)
        with o._lock:
            pass
        restore()
        assert isinstance(o._lock, type(threading.Lock()))


class TestPortLockGraph:
    def test_rlock_owner_count_and_condition_wait(self):
        """The port's RLock wrapper: re-entry makes no self-edge, another
        thread sees the lock held, and a Condition over it waits (releasing
        every level) and restores the hold; the graph records the order
        the waiter re-acquires in."""
        from trino_tpu_torch.verify.lockgraph import LockGraph, capture

        with capture(LockGraph(), singletons=False) as g:
            gate = threading.RLock()
            cv = threading.Condition(gate)
            other = threading.Lock()
            woke = []
            ready = threading.Event()

            def waiter():
                with other:
                    with cv:
                        with gate:  # depth 2 across the wait
                            ready.set()
                            while not woke:
                                cv.wait(timeout=5)

            t = threading.Thread(target=waiter, name="waiter", daemon=True)
            with gate:
                with gate:
                    pass
                t.start()
                seen = []
                probe = threading.Thread(
                    target=lambda: seen.append(gate.locked()), name="probe", daemon=True
                )
                probe.start()
                probe.join()
                assert seen == [True]
            assert ready.wait(timeout=10)
            with cv:  # the waiter holds the gate until its wait releases it
                woke.append(1)
                cv.notify_all()
            t.join(timeout=10)
            assert not t.is_alive()
        assert threading.RLock is not type(gate)
        names = {n for e in g.edges() for n in e}
        assert any(n.startswith("rlock@") for n in names)
        assert all(a != b for a, b in g.edges())
        g.assert_acyclic()

    def test_instrument_singletons_lists_the_ports_locks(self):
        """Every process-wide lock of the port is wrapped for the scope (an
        RLock by the reentrant wrapper) and restored after it."""
        from trino_tpu_torch.ops import grouped_sums, locate_sorted
        from trino_tpu_torch.runtime import dispatcher
        from trino_tpu_torch.verify import lockgraph as L

        gate, launches = dispatcher._DEVICE_GATE, locate_sorted._LAUNCHES_LOCK
        with L.capture(singletons=True):
            assert isinstance(dispatcher._DEVICE_GATE, L.InstrumentedRLock)
            assert isinstance(dispatcher._WAITERS_LOCK, L.InstrumentedLock)
            assert isinstance(grouped_sums._LAUNCHES_LOCK, L.InstrumentedLock)
            assert isinstance(locate_sorted._LAUNCHES_LOCK, L.InstrumentedLock)
            names = {name for _, _, name in L._singleton_sites()}
        assert dispatcher._DEVICE_GATE is gate and locate_sorted._LAUNCHES_LOCK is launches
        for want in (
            "dispatcher:_DEVICE_GATE", "TRACE_CACHE._lock", "REGISTRY._lock",
            "ir:_KEY_IDS_LOCK", "functions:_HOST_TABLES_LOCK", "kernels.build:_LOCK",
        ):
            assert want in names

    def test_lifecycle_locks_compose_acyclically(self):
        from trino_tpu_torch.runtime.lifecycle import QueryTracker
        from trino_tpu_torch.verify.lockgraph import LockGraph, instrument_attr

        g = LockGraph()
        tracker = QueryTracker()
        instrument_attr(tracker, "_lock", "tracker", g)
        ctx = tracker.create("q1")
        instrument_attr(ctx, "_lock", "query", g)
        ctx.begin()
        ctx.finish()
        tracker.remove(ctx)
        g.assert_acyclic()

    def test_two_lane_dispatcher_run_is_acyclic(self):
        """The dispatcher's two-lane run (tests/test_torch_dispatcher.py:
        twelve statements from six threads, two groups) over the port's
        LocalQueryRunner under `capture()`: every lock the run creates and
        every process-wide lock of the port joins the graph, which must be
        acyclic; the rows equal the JAX local runner's."""
        from test_torch_dispatcher import QUERIES
        from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
        from trino_tpu_torch.verify.lockgraph import capture

        jax = JaxRunner(catalog="tpch", schema="tiny")
        expected = {k: jax.execute(sql).rows for k, sql in QUERIES.items()}
        with capture() as g:
            from trino_tpu_torch.runtime.dispatcher import QueryDispatcher
            from trino_tpu_torch.runtime.resource_groups import (
                ResourceGroupConfig,
                ResourceGroupManager,
            )
            from trino_tpu_torch.runtime.runner import LocalQueryRunner

            runner = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
            mgr = ResourceGroupManager()
            mgr.add(ResourceGroupConfig("etl", hard_concurrency=1, weight=1, max_queued=16))
            mgr.add(ResourceGroupConfig("adhoc", hard_concurrency=2, weight=3, max_queued=16))
            d = QueryDispatcher(runner, mgr, lanes=2)
            runner.dispatcher = d
            names = list(QUERIES)
            jobs = [(("etl", "adhoc")[i % 2], names[i % 3]) for i in range(12)]
            results, errors = [], []
            out = threading.Lock()

            def client(k):
                for group, name in jobs[k::6]:
                    try:
                        t = d.enqueue(group_name=group)
                        t.wait()
                        res = d.run_admitted(t, lambda r, name=name: r.execute(QUERIES[name]))
                        with out:
                            results.append((name, res.rows))
                    except Exception as e:  # noqa: BLE001 - reported below
                        with out:
                            errors.append(e)

            threads = [
                threading.Thread(target=client, args=(k,), name=f"client-{k}", daemon=True)
                for k in range(6)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
        assert not errors, errors
        assert sorted(n for n, _ in results) == sorted(n for _, n in jobs)
        for name, rows in results:
            assert rows == expected[name], name
        edges = g.edges()
        assert edges
        assert any(a == "dispatcher:_DEVICE_GATE" or b == "dispatcher:_DEVICE_GATE" for a, b in edges)
        g.assert_acyclic()
