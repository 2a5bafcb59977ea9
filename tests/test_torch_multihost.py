"""The port's multi-host tier (server/worker.py, parallel/remote.py,
parallel/serde.py) and `resize_mesh` against the JAX package.

The cases of tests/test_multihost.py run through the port's
MultiHostQueryRunner over two port WorkerServers on `device="cpu"`
(threads in this process, each an HTTP server on an ephemeral port), and
their rows are held to the JAX LocalQueryRunner's at tpch.tiny: doubles to
relative 1e-9, and to 5e-5 under `pallas_agg`, where Q1-double's
aggregation, which each worker runs over the lineitem rows repartitioned
to it, takes the grouped-sums kernel's plain version (f32 sums; tests/test_torch_e2e.py gives the bound).  The serde
round trip covers a long decimal's [n, 2] limb plane, an array column's
[rows, K] block and lengths, and a timestamp with time zone.  The port's
4-worker mesh goes 4 -> 2 -> 4 through `resize_mesh` beside the JAX mesh
doing the same, and Q3's rows agree at each width.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_e2e import Q1_DOUBLE, assert_same_rows
from trino_tpu.connectors.tpch.queries import QUERIES as TPCH
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.ops import grouped_sums as gs
from trino_tpu_torch.parallel import remote as rmod
from trino_tpu_torch.parallel.remote import MultiHostQueryRunner
from trino_tpu_torch.server.worker import WorkerServer

#: (sql, results-are-ordered): tests/test_multihost.py's QUERIES
QUERIES = [
    ("select count(*) from lineitem", False),
    ("select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
     "from lineitem group by l_returnflag, l_linestatus", False),
    ("select count(*) from lineitem, orders where l_orderkey = o_orderkey "
     "and o_orderstatus = 'F'", False),
    ("select n_name, count(*) from customer, nation "
     "where c_nationkey = n_nationkey group by n_name", False),
    ("select l_orderkey, l_extendedprice from lineitem "
     "where l_orderkey < 50 order by l_extendedprice desc, l_orderkey", True),
    ("select o_orderkey, o_totalprice from orders "
     "order by o_totalprice desc limit 10", False),
    ("select l_orderkey, l_linenumber, "
     "rank() over (partition by l_orderkey order by l_extendedprice desc) r "
     "from lineitem where l_orderkey < 30", False),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer(port=0, device="cpu").start() for _ in range(2)]
    yield ws
    for w in ws:
        w.shutdown()


@pytest.fixture(scope="module")
def mh(workers):
    return MultiHostQueryRunner(
        [w.url for w in workers], catalog="tpch", schema="tiny", device="cpu"
    )


@pytest.fixture(scope="module")
def jax_local():
    return JaxRunner(catalog="tpch", schema="tiny")


@pytest.mark.parametrize("sql,ordered", QUERIES, ids=[f"q{i}" for i in range(len(QUERIES))])
def test_multihost_matches_jax_local(mh, jax_local, sql, ordered):
    assert_same_rows(mh.execute(sql).rows, jax_local.execute(sql).rows, ordered, 1e-9)
    assert len(mh.last_plan_workers) == 2


@pytest.mark.parametrize("pallas", [False, True], ids=["default", "pallas_agg"])
def test_q1_double_worker_aggregation_kernel(mh, jax_local, pallas):
    """Q1-double: under `pallas_agg` the workers' aggregations take the
    grouped-sums kernel (here its plain version, on CPU tensors)."""
    mh.execute(f"set session pallas_agg = {str(pallas).lower()}")
    try:
        before = gs.grouped_sums_reference.launches
        got = mh.execute(Q1_DOUBLE).rows
        launched = gs.grouped_sums_reference.launches - before
    finally:
        mh.execute("set session pallas_agg = false")
    assert_same_rows(got, jax_local.execute(Q1_DOUBLE).rows, True, 5e-5 if pallas else 1e-9)
    assert (launched > 0) == pallas


@pytest.mark.parametrize("q", [3, 18])
def test_tpch_joins_match_jax_local(mh, jax_local, q):
    assert_same_rows(mh.execute(TPCH[q]).rows, jax_local.execute(TPCH[q]).rows, True, 1e-9)


def _batch(cols, mask=None):
    from trino_tpu_torch.columnar import Batch

    return Batch(cols, None if mask is None else torch.as_tensor(mask))


def test_serde_roundtrip_every_plane_kind():
    """Limb planes, array blocks with lengths, packed timestamps with time
    zone, dictionaries and validity survive the wire; the result is CPU."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Column, StringDictionary
    from trino_tpu_torch.parallel.serde import batches_to_bytes, bytes_to_batches

    rng = np.random.default_rng(7)
    n = 6
    d = StringDictionary(["x", "y", "z"])
    limbs = np.stack([rng.integers(-3, 3, n), rng.integers(0, 1 << 62, n)], axis=1)
    block = rng.integers(0, 100, (n, 3))
    lengths = np.array([0, 1, 3, 2, 3, 1], np.int32)
    tz = T.TIMESTAMP_TZ
    b = _batch(
        [
            Column(torch.arange(n, dtype=torch.int64), T.BIGINT,
                   torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.bool)),
            Column(torch.tensor([0, 1, 2, 1, 0, 2], dtype=torch.int32), T.VARCHAR, None, d),
            Column(torch.from_numpy(limbs), T.DecimalType(30, 2)),
            Column(torch.from_numpy(block), T.ArrayType(T.BIGINT), None, None,
                   torch.from_numpy(lengths)),
            Column(torch.tensor([T.pack_tz(int(ms), int(off)) for ms, off in zip(
                rng.integers(0, 1 << 40, n), rng.integers(-600, 600, n))]), tz),
            Column(torch.from_numpy(rng.standard_normal(n)), T.DOUBLE),
        ],
        np.array([1, 1, 1, 0, 1, 1], bool),
    )
    payload = batches_to_bytes([b, b])
    out = bytes_to_batches(payload)
    assert len(out) == 2
    for o in out:
        assert o.device == torch.device("cpu")
        assert o.to_pylist() == b.to_pylist()
        assert tuple(o.columns[2].data.shape) == (n, 2)
        assert torch.equal(o.columns[3].lengths, b.columns[3].lengths)
        assert [c.type for c in o.columns] == [c.type for c in b.columns]
    assert bytes_to_batches(batches_to_bytes([])) == []


def test_serde_matches_jax_rows():
    """The same seeded planes through both packages' serde give the same
    rows (the JAX format, read from numpy planes either way)."""
    from trino_tpu import types as JT
    from trino_tpu.columnar import Batch as JBatch
    from trino_tpu.columnar import Column as JColumn
    from trino_tpu.parallel import serde as jserde
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Column
    from trino_tpu_torch.parallel import serde as pserde

    rng = np.random.default_rng(11)
    data = rng.integers(-1000, 1000, 16)
    valid = rng.random(16) < 0.8
    mask = rng.random(16) < 0.9
    jb = JBatch([JColumn(data, JT.BIGINT, valid)], mask)
    pb = _batch([Column(torch.from_numpy(data), T.BIGINT, torch.from_numpy(valid))], mask)
    want = jserde.bytes_to_batches(jserde.batches_to_bytes([jb]))[0].to_pylist()
    assert pserde.bytes_to_batches(pserde.batches_to_bytes([pb]))[0].to_pylist() == want


def test_worker_failure_surfaces(mh):
    with pytest.raises(Exception, match="no_such_column|failed"):
        mh.execute("select no_such_column from lineitem")


def test_dead_worker_excluded_at_assignment(jax_local):
    live = [WorkerServer(port=0, device="cpu").start() for _ in range(2)]
    try:
        dead = WorkerServer(port=0, device="cpu").start()
        dead.shutdown()  # registered URL, nobody listening
        mh2 = MultiHostQueryRunner(
            [w.url for w in live] + [dead.url], catalog="tpch", schema="tiny", device="cpu"
        )
        q = "select count(*), sum(l_quantity) from lineitem"
        assert mh2.execute(q).rows == jax_local.execute(q).rows
        assert dead.url not in mh2.last_plan_workers
    finally:
        for w in live:
            w.shutdown()


def test_worker_death_mid_query_reassigns(jax_local, monkeypatch):
    ws = [WorkerServer(port=0, device="cpu").start() for _ in range(3)]
    victim = ws[1]
    try:
        mh2 = MultiHostQueryRunner(
            [w.url for w in ws], catalog="tpch", schema="tiny", device="cpu"
        )
        orig_fetch = rmod._fetch_ok
        state = {"killed": False}

        def killing_fetch(task, *a, **kw):
            if not state["killed"]:
                state["killed"] = True
                victim.shutdown()
            return orig_fetch(task, *a, **kw)

        monkeypatch.setattr(rmod, "_fetch_ok", killing_fetch)
        q = (
            "select l_returnflag, count(*) c, sum(l_quantity) q "
            "from lineitem group by l_returnflag order by l_returnflag"
        )
        assert mh2.execute(q).rows == jax_local.execute(q).rows
    finally:
        for w in ws:
            try:
                w.shutdown()
            except Exception:
                pass


def test_cross_fragment_dynamic_filter(mh, jax_local, monkeypatch):
    import trino_tpu_torch.server.worker as wmod

    seen = {}
    orig = wmod.WorkerServer._execute

    def spy(self, desc, **kw):
        if desc.dynamic_ranges:
            seen[desc.task_id] = dict(desc.dynamic_ranges)
        return orig(self, desc, **kw)

    monkeypatch.setattr(wmod.WorkerServer, "_execute", spy)
    mh.properties.set("join_distribution_type", "PARTITIONED")
    try:
        q = (
            "select c_name from customer join orders on c_custkey = o_custkey "
            "where o_orderkey = 7"
        )
        rows = mh.execute(q).rows
        assert rows == jax_local.execute(q).rows and len(rows) == 1
        mh.execute(
            "select count(*) from lineitem join orders "
            "on l_orderkey = o_orderkey where o_orderkey < 100"
        )
    finally:
        mh.properties.set("join_distribution_type", "AUTOMATIC")
    assert seen, "no task descriptor carried dynamic ranges"
    for rng in seen.values():
        # host scalars only: a descriptor is a pickle a CPU-only worker loads
        assert all(len(v) == 2 and all(type(x) in (int, float) for x in v)
                   for v in rng.values())


def test_merged_trace_carries_exchange_bytes(mh):
    """One cross-host timeline: worker task trees graft under the
    coordinator's fragment spans, and carry the output bytes and encode
    seconds; the coordinator's pulls add their bytes to the fragment span."""
    mh.execute("set session query_trace = true")
    try:
        mh.execute(
            "select l_returnflag, sum(l_quantity) from lineitem group by l_returnflag"
        )
        qid, flat = mh.traces[-1]
        mh.execute("set session query_trace = false")
        before = mh.last_trace
        mh.execute("select count(*) from region")
        assert mh.last_trace is before  # trace off: nothing recorded
    finally:
        mh.execute("set session query_trace = false")
    by_id = {s["span_id"]: s for s in flat}
    tasks = [s for s in flat if s["name"] == "task"]
    assert len(tasks) >= 2
    for t in tasks:
        parent = by_id[t["parent_id"]]
        assert parent["name"] == "fragment"
        attrs = json.loads(t["attributes"])
        assert attrs["coordinator_span"] == parent["span_id"]
        assert attrs["output_bytes"] > 0 and attrs["encode_s"] >= 0.0
    execs = [s for s in flat if s["name"] == "execute_fragment"]
    assert execs and all(by_id[s["parent_id"]]["name"] == "task" for s in execs)
    pulled = [json.loads(s["attributes"]).get("pulled_bytes", 0)
              for s in flat if s["name"] == "fragment"]
    assert sum(pulled) > 0
    fetches = [json.loads(s["attributes"]) for s in flat if s["name"] == "input_fetch"]
    assert fetches and all(a["bytes"] > 0 for a in fetches)


def test_worker_metrics_and_info(workers):
    w = workers[0]
    with urllib.request.urlopen(f"{w.url}/v1/info", timeout=5.0) as r:
        assert json.loads(r.read()) == {"state": "ACTIVE"}
    with urllib.request.urlopen(f"{w.url}/v1/metrics", timeout=5.0) as r:
        assert b"trino_tpu_breaker_state" in r.read()


def test_worker_burst_of_pulls_all_served(workers):
    """Twenty-four connections at once to one worker are all answered: the
    worker listens with the port coordinator's backlog (socketserver's 5,
    which the JAX worker keeps, resets some under a burst of pulls)."""
    import threading

    w = workers[1]
    assert w._httpd.request_queue_size >= 24
    n = 24
    got = [None] * n
    barrier = threading.Barrier(n)

    def one(i):
        barrier.wait()
        with urllib.request.urlopen(f"{w.url}/v1/info", timeout=30.0) as r:
            got[i] = json.loads(r.read())

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got == [{"state": "ACTIVE"}] * n


def test_worker_process_resolves_coordinator_dictionary_refs(jax_local):
    """A worker in its own process (`python -m trino_tpu_torch.server.worker
    --device cpu`, its knobs from the environment) decodes a page set whose
    dictionary ref names a key only the coordinator's process holds (an
    equal dictionary registered later under a memory table's key wins the
    reverse lookup), through the coordinator's /v1/dictionary
    (`worker.coordinator-url`); no task fails and the rows hold."""
    import os
    import subprocess
    import sys

    from trino_tpu_torch.connectors.api import TableHandle, default_catalogs
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE as D
    from trino_tpu_torch.server import CoordinatorServer

    saved = dict(D._by_fp)
    cats = default_catalogs()
    for col in ("l_returnflag", "l_linestatus"):
        ent = D.lookup(TableHandle("tpch", "tiny", "lineitem"), col, cats)
        D.register("memory", "default", "copy_lineitem", col, ent.dictionary)
    local = WorkerServer(port=0, device="cpu").start()
    mh = MultiHostQueryRunner([local.url], catalog="tpch", schema="tiny", device="cpu")
    srv = CoordinatorServer(runner=mh, port=0)
    srv.start()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED", "0"),
           "TRINO_TPU_WORKER_COORDINATOR_URL": f"http://127.0.0.1:{srv.port}"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "trino_tpu_torch.server.worker", "--device", "cpu",
         "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("worker listening on "), line
        mh.add_worker(line.split()[-1])
        fetch = rmod._fetch_ok
        failed = []

        def noting(task, *a, **kw):
            try:
                return fetch(task, *a, **kw)
            except Exception as e:
                failed.append(str(e))
                raise

        rmod._fetch_ok = noting
        try:
            sql = QUERIES[1][0]
            assert_same_rows(mh.execute(sql).rows, jax_local.execute(sql).rows, False, 1e-9)
        finally:
            rmod._fetch_ok = fetch
        assert len(mh.last_plan_workers) == 2 and failed == []
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()
        srv.shutdown()
        local.shutdown()
        D._by_fp.clear()
        D._by_fp.update(saved)


# -- resize_mesh (the one-card mesh) ------------------------------------------


def test_resize_mesh_matches_jax_mesh():
    """4 -> 2 -> 4 on both meshes; Q3's rows agree at each width, the old
    signature's scan entries go, and the detector follows the width."""
    from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
    from trino_tpu_torch.parallel import DistributedQueryRunner

    jm = JaxMesh(catalog="tpch", schema="tiny", n_workers=4)
    pm = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    pm.execute("set session pallas_probe = true")
    for w in (4, 2, 4):
        jm.resize_mesh(w)
        pm.resize_mesh(w)
        assert pm.wm.n == jm.wm.n == w
        assert sorted(pm.failure_detector.active_workers()) == sorted(
            jm.failure_detector.active_workers()
        ) == [f"worker-{i}" for i in range(w)]
        assert_same_rows(pm.execute(TPCH[3]).rows, jm.execute(TPCH[3]).rows, True, 1e-9)
        if w == 2:
            assert pm.last_resize_invalidated > 0  # the W=4 scans went
    with pytest.raises(ValueError, match="out of range"):
        pm.resize_mesh(0)
    with pytest.raises(ValueError, match="out of range"):
        jm.resize_mesh(0)
