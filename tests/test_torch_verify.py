"""The port's collective-schedule licenses (trino_tpu_torch/verify/schedule.py),
the executor's eager pre-dispatch and the device-residency verifier
(trino_tpu_torch/verify/residency.py), against the JAX package.

  * the schedule cases of tests/test_capacity.py over the port's 8-worker
    mesh under the lineitem/orders layouts (the license's shape, the
    sync-free rule, the runtime sizing the certificates delete, a stale
    seal, the license knob), each held to the JAX local runner's rows;
  * `license_schedule` equal to the JAX package's (its JSON: the witness
    signature, the async children, the mesh width) for every TPC-H plan
    at W = 4 and W = 8;
  * `collective_async` on the 4-worker mesh Q3 and Q5 equal to the JAX
    mesh's, the rows to the JAX local runner's, and a run without the
    license giving the same rows with no pre-dispatch;
  * the residency cases of tests/test_verify.py: the step-cache key audit
    (a complete key passes, an incomplete one is caught, nested closures
    and tensors are fingerprinted), warm mesh Q3 and Q6 pass
    `device_residency`, a host re-entry is caught.
"""

import numpy as np
import pytest
import torch

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import verify as V
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.planner import plan as P

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

LINEITEM_ORDERS = "tpch.tiny.lineitem:l_orderkey:8,tpch.tiny.orders:o_orderkey:8"
Q3 = QUERIES[3]


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


@pytest.fixture(scope="module")
def jax_local():
    return JaxRunner(catalog="tpch", schema="tiny")


@pytest.fixture(scope="module")
def dist():
    """tests/test_capacity.py's mesh: 8 workers under the layouts."""
    d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=8, device="cpu")
    d.execute(f"set session table_layouts = '{LINEITEM_ORDERS}'")
    return d


def _rows_ok(res, jax_local, sql):
    return sorted(res.rows) == sorted(jax_local.execute(sql).rows)


# -- schedule licenses (tests/test_capacity.py) ------------------------------------


class TestScheduleLicense:
    def test_q3_license_shape(self, dist):
        from trino_tpu_torch.verify.schedule import license_schedule

        sub = dist.create_subplan(dist.create_plan(Q3))
        lic = license_schedule(sub, dist.wm.n)
        assert lic is not None and lic.mesh_w == dist.wm.n
        assert lic.licensed_count() >= 1
        for parent, children in lic.async_children.items():
            assert parent not in children
        assert lic.fragments == dist.last_collective_signature
        assert lic.to_json() == dist.last_schedule_license.to_json()

    def test_sync_free_requires_license_or_no_gather(self, dist):
        from trino_tpu_torch.verify.schedule import _sync_free

        sub = dist.create_subplan(dist.create_plan(Q3))
        frag = next(
            cand for cand in [sub] + list(sub.children)
            if any(isinstance(n, P.JoinNode) for n in _walk(cand.fragment.root))
        )
        assert _sync_free(frag)  # capacity certificates make the gathers elidable
        for n in _walk(frag.fragment.root):
            if isinstance(n, P.JoinNode):
                n.capacity_cert = None
        assert not _sync_free(frag)  # an unlicensed sizing gather is a sync


class TestMeshExecution:
    def test_q3_runs_with_zero_runtime_sizing(self, dist, jax_local):
        dist.execute(Q3)  # settle
        res = dist.execute(Q3)
        prof = dist.last_mesh_profile
        c = dict(prof.counters)
        assert c.get("join_overflow_check", 0) == 0
        assert c.get("join_capacity_sync", 0) == 0
        assert c.get("join_speculative_retry", 0) == 0
        assert c.get("join_capacity_proven", 0) == 2
        assert "gather/capacity_sizing" not in prof.to_json()["collective_bytes_by"]
        assert _rows_ok(res, jax_local, Q3)

    def test_async_predispatch_counts(self, dist):
        dist.execute(Q3)
        assert dist.last_mesh_profile.counters.get("collective_async", 0) >= 1

    def test_build_at_exactly_certified_capacity(self, dist, jax_local):
        sql = ("select count(*) from orders join customer "
               "on o_custkey = c_custkey where o_orderkey <= 1024")
        joins = [n for n in _walk(dist.create_plan(sql)) if isinstance(n, P.JoinNode)]
        assert joins and joins[0].capacity_cert is not None
        assert joins[0].capacity_cert.probe_rows_bound == 1024
        res = dist.execute(sql)
        c = dict(dist.last_mesh_profile.counters)
        assert c.get("join_overflow_check", 0) == 0
        assert c.get("join_capacity_proven", 0) >= 1
        assert res.rows == jax_local.execute(sql).rows == [(1024,)]

    def test_stale_seal_falls_back_to_sizing_path(self, dist, jax_local):
        from trino_tpu_torch.parallel.runner import StageExecutor
        from trino_tpu_torch.verify.capacity import seal_licenses

        sql = "select count(*) from orders join customer on o_custkey = c_custkey"
        sub = dist.create_subplan(dist.create_plan(sql))
        for frag in sub.all_fragments():
            seal_licenses(frag.root, dist.wm.n - 1)  # stale seal
        ex = StageExecutor(dist.catalogs, dist.wm, dist.properties)
        rows = [tuple(r) for b in ex.run(sub).stream for r in b.to_pylist()]
        c = dict(ex.profile.counters)
        assert c.get("join_capacity_proven", 0) == 0
        assert c.get("join_overflow_check", 0) + c.get("join_capacity_sync", 0) >= 1
        assert rows == jax_local.execute(sql).rows

    def test_license_for_another_width_is_ignored(self, dist):
        """The executor honours a schedule license only at its own mesh
        width (the JAX executor's rule)."""
        from trino_tpu_torch.parallel.runner import StageExecutor
        from trino_tpu_torch.verify.schedule import license_schedule

        sub = dist.create_subplan(dist.create_plan(Q3))
        lic = license_schedule(sub, dist.wm.n - 1)
        assert StageExecutor(dist.catalogs, dist.wm, dist.properties, schedule=lic).schedule is None
        lic8 = license_schedule(sub, dist.wm.n)
        assert StageExecutor(dist.catalogs, dist.wm, dist.properties, schedule=lic8).schedule is lic8

    def test_license_knob_off_runs_runtime_path(self, dist, jax_local):
        sql = "select count(*) from orders join customer on o_custkey = c_custkey"
        dist.execute("set session join_capacity_license = false")
        try:
            res = dist.execute(sql)
            assert dist.last_mesh_profile.counters.get("join_capacity_proven", 0) == 0
            assert _rows_ok(res, jax_local, sql)
        finally:
            dist.execute("set session join_capacity_license = true")
        res = dist.execute(sql)
        assert dist.last_mesh_profile.counters.get("join_capacity_proven", 0) >= 1
        assert _rows_ok(res, jax_local, sql)

    def test_warm_q3_residency_with_licenses(self, dist):
        report = V.device_residency(dist, Q3, warmups=1)
        assert report["retraces"] == 0 and report["trace_misses"] == 0
        assert report["counters"].get("join_overflow_check", 0) == 0
        assert report["counters"].get("join_capacity_proven", 0) == 2
        assert report["counters"].get("collective_async", 0) >= 1


# -- the license against the JAX package's, every TPC-H plan -----------------------


@pytest.fixture(scope="module")
def license_runners():
    from trino_tpu.parallel import DistributedQueryRunner as JaxDist

    return {
        w: (DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=w, device="cpu"),
            JaxDist(catalog="tpch", schema="tiny", n_workers=w))
        for w in (4, 8)
    }


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_license_equals_jax_tpch(license_runners, qid, w):
    """`license_schedule` of the port's plan equals the JAX package's on
    the same query: the witness signature, the async children and the mesh
    width (the sweep file covers TPC-DS)."""
    from trino_tpu.verify.schedule import license_schedule as jax_license
    from trino_tpu_torch.verify.schedule import license_schedule

    port, jax = license_runners[w]
    psub = port.create_subplan(port.create_plan(QUERIES[qid]))
    jsub = jax.create_subplan(jax.create_plan(QUERIES[qid]))
    plic, jlic = license_schedule(psub, w), jax_license(jsub, w)
    assert (plic is None) == (jlic is None)
    if jlic is not None:
        assert plic.to_json() == jlic.to_json()
        assert plic.async_children == jlic.async_children and plic.mesh_w == jlic.mesh_w
    assert port.last_schedule_license.to_json() == jax.last_schedule_license.to_json()


# -- pre-dispatch on the 4-worker mesh ---------------------------------------------


@pytest.fixture(scope="module")
def mesh_pair():
    from trino_tpu.parallel import DistributedQueryRunner as JaxDist

    return (DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
            JaxDist(catalog="tpch", schema="tiny", n_workers=4))


@pytest.mark.parametrize("qid", [3, 5])
def test_collective_async_equals_jax_mesh(mesh_pair, jax_local, qid):
    """The 4-worker mesh pre-dispatches as many licensed children as the
    JAX mesh; its rows equal the JAX local runner's."""
    from trino_tpu.telemetry.metrics import collective_async_counter as jax_counter
    from trino_tpu_torch.telemetry.metrics import collective_async_counter

    port, jax = mesh_pair
    before = collective_async_counter().value()
    res = port.execute(QUERIES[qid])
    n = port.last_mesh_profile.counters.get("collective_async", 0)
    assert collective_async_counter().value() - before == n
    jbefore = jax_counter().value()
    jax.execute(QUERIES[qid])
    assert n == jax.last_mesh_profile.counters.get("collective_async", 0)
    assert n == jax_counter().value() - jbefore
    assert n == port.last_schedule_license.licensed_count() > 0
    assert _rows_ok(res, jax_local, QUERIES[qid])


@pytest.mark.parametrize("qid", [3, 5, 18])
def test_unlicensed_run_same_rows(mesh_pair, qid):
    """Pre-dispatch changes no row: the same subplan run with and without
    the license gives the same rows, and only the licensed run counts
    `collective_async`."""
    from trino_tpu_torch.parallel.runner import StageExecutor

    port, _ = mesh_pair
    out = {}
    for licensed in (True, False):
        sub = port.create_subplan(port.create_plan(QUERIES[qid]))
        ex = StageExecutor(port.catalogs, port.wm, port.properties,
                           schedule=port.last_schedule_license if licensed else None)
        out[licensed] = [tuple(r) for b in ex.run(sub).stream for r in b.to_pylist()]
        assert (ex.profile.counters.get("collective_async", 0) > 0) == licensed
    assert sorted(out[True]) == sorted(out[False])


def test_predispatch_keeps_dynamic_filter_pruning(mesh_pair):
    """A licensed child runs before its consumer's body, never before the
    dynamic filters that prune it: the probe scans see the same filter
    ranges with and without the license."""
    from trino_tpu_torch.parallel.runner import StageExecutor

    port, _ = mesh_pair
    ranges = {}
    for licensed in (True, False):
        sub = port.create_subplan(port.create_plan(QUERIES[5]))
        ex = StageExecutor(port.catalogs, port.wm, port.properties,
                           schedule=port.last_schedule_license if licensed else None)
        list(ex.run(sub).stream)
        ranges[licensed] = dict(ex.dynamic_filters)
    assert ranges[True] == ranges[False] and ranges[True]


# -- the step-cache key audit and device residency (tests/test_verify.py) ----------


class TestCacheKeyAudit:
    @staticmethod
    def _make(n):
        def build():
            def step(x):
                return x + n

            return step

        return build

    def test_same_key_same_closure_passes(self):
        from trino_tpu_torch.parallel.spmd import TRACE_CACHE

        key = ("test_audit_ok", id(self))
        with V.cache_key_audit() as auditor:
            TRACE_CACHE.get(key, self._make(1))
            TRACE_CACHE.get(key, self._make(1))
        assert auditor.checked == 2
        assert TRACE_CACHE.audit is None

    def test_incomplete_key_raises(self):
        """Two builders whose steps bake different constants under one
        key: the second arrival raises CacheKeyViolation naming the free
        variable."""
        from trino_tpu_torch.parallel.spmd import TRACE_CACHE

        key = ("test_audit_bad", id(self))
        with V.cache_key_audit():
            TRACE_CACHE.get(key, self._make(1))
            with pytest.raises(V.CacheKeyViolation) as ei:
                TRACE_CACHE.get(key, self._make(2))
        assert "n" in str(ei.value)

    def test_fingerprint_sees_nested_closures_arrays_and_tensors(self):
        def closure_over(table):
            def outer():
                def inner(x):
                    return x + table

                return inner

            return outer()

        a = np.arange(4)
        b = a.copy()
        b[0] = 99
        assert V.closure_fingerprint(closure_over(a)) != V.closure_fingerprint(closure_over(b))
        assert V.closure_fingerprint(closure_over(a)) == V.closure_fingerprint(closure_over(a.copy()))
        t = torch.arange(4)
        u = t.clone()
        u[0] = 99
        assert V.closure_fingerprint(closure_over(t)) != V.closure_fingerprint(closure_over(u))
        assert V.closure_fingerprint(closure_over(t)) == V.closure_fingerprint(closure_over(t.clone()))
        # a large tensor: shape, dtype and device only
        big = torch.zeros(1 << 15, dtype=torch.int64)
        fp = dict(V.closure_fingerprint(closure_over(big)))["table"]
        assert fp == ("tensor", (1 << 15,), "torch.int64", "cpu")

    def test_seeded_incomplete_mesh_key_is_caught(self, monkeypatch):
        """A mesh step key that drops a baked-in constant (the dynamic
        filter range of a scan) is caught on the first run that meets two
        different ranges under it."""
        from trino_tpu_torch.parallel import runner as mesh_runner

        d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        real = mesh_runner._Dist.defer

        def drop_ranges(self, key_part, step, *a, **k):
            if isinstance(key_part, tuple) and key_part and key_part[0] == "dyn_filter":
                key_part = ("dyn_filter", "seeded-incomplete") + key_part[2:]
            return real(self, key_part, step, *a, **k)

        monkeypatch.setattr(mesh_runner._Dist, "defer", drop_ranges)
        sql = ("select count(*) from orders join customer on o_custkey = c_custkey "
               "where c_custkey < {}")
        with V.cache_key_audit():
            d.execute(sql.format(100))
            with pytest.raises(V.CacheKeyViolation):
                d.execute(sql.format(200))


class TestDeviceResidency:
    @pytest.mark.parametrize("qid", [3, 6])
    def test_warm_mesh_query_is_device_resident(self, qid):
        """A warm 8-worker TPC-H Q3 and Q6 build no step, re-enter no host
        batch, and issue the recorded and licensed collective schedule,
        with the key audit live over their step-cache traffic."""
        runner = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=8, device="cpu")
        report = V.device_residency(runner, QUERIES[qid])
        assert report["retraces"] == 0 and report["trace_misses"] == 0
        assert report["trace_hits"] > 0
        assert report["counters"].get("host_restack", 0) == 0
        assert report["cache_keys_checked"] > 0

    def test_residency_violation_detected(self):
        runner = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=8, device="cpu")
        sql = ("select count(*) from lineitem join "
               "(values 1, 2, 3) as t(k) on l_linenumber = k")
        with pytest.raises(V.ResidencyViolation) as ei:
            V.device_residency(runner, sql)
        assert "host_restack" in str(ei.value)

    def test_warm_build_is_a_violation(self, monkeypatch):
        """A warm replay that builds a step (a key that changes on every
        run) fails the warm contract: torch never retraces, so the step
        builds are what the contract counts."""
        from trino_tpu_torch.parallel import spmd

        runner = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        real = spmd.cached_spmd_step
        runs = iter(range(1 << 30))

        def fresh_key(wm, key, build_step, collective=False):
            return real(wm, tuple(key) + (next(runs),), build_step, collective)

        monkeypatch.setattr(spmd, "cached_spmd_step", fresh_key)
        monkeypatch.setattr("trino_tpu_torch.parallel.runner.cached_spmd_step", fresh_key)
        with pytest.raises(V.ResidencyViolation, match="built"):
            V.device_residency(runner, QUERIES[6], audit_cache_keys=False)

    def test_licensed_schedule_is_checked(self, monkeypatch):
        """A warm replay whose collectives differ from the licensed schedule
        is caught, even when the plain signature is not recorded."""
        runner = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        real = DistributedQueryRunner.create_subplan

        def seeded(self, plan):
            sub = real(self, plan)
            self.last_collective_signature = None
            lic = self.last_schedule_license
            fid = next(iter(lic.fragments))
            lic.fragments = dict(lic.fragments)
            lic.fragments[fid] = tuple(lic.fragments[fid]) + (("all_to_all", "seeded", False),)
            return sub

        monkeypatch.setattr(DistributedQueryRunner, "create_subplan", seeded)
        with pytest.raises(V.ResidencyViolation, match="licensed schedule"):
            V.device_residency(runner, QUERIES[3])
