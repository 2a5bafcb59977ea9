"""The port's fault-tolerant execution on the mesh against the JAX package:
task retries, spooled stage outputs, attempt dedup and the dictionary
snapshots a spooled varchar column needs after a restart.

The cases of tests/test_fte.py (the stage retries, the spool round trips,
the crash-atomic save, duplicate attempts) and the in-mesh FTE case of
tests/test_chaos.py, on the port's DistributedQueryRunner(n_workers=8,
device="cpu") beside the JAX mesh of the same width in the same process.
For each injection both engines run the same statement under the same
armed FAILURE_INJECTOR: the rows, the injector's visits, the discarded
duplicate attempts, the task-retry counter's deltas per outcome and the
StageFailedException text must be equal.  The unit cases of the spool run
once per package (`pkg`).  No spool directory may be left behind.
"""

import glob
import importlib
import os
import tempfile

import numpy as np
import pytest

from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu_torch.parallel import DistributedQueryRunner

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

PKGS = ("trino_tpu", "trino_tpu_torch")

SQL = (
    "select n_regionkey, count(*) c, sum(n_nationkey) s from nation "
    "group by n_regionkey"
)

#: tests/test_chaos.py's in-mesh FTE statement
CHAOS_SQL = (
    "select l_returnflag, count(*) c, sum(l_quantity) q "
    "from lineitem group by l_returnflag order by l_returnflag"
)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def clean_injectors():
    for p in PKGS:
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()
    yield
    for p in PKGS:
        mod(p, "runtime.retry").FAILURE_INJECTOR.clear()


@pytest.fixture(autouse=True)
def no_spool_leaks():
    """Every query-owned spool directory of either engine is gone when the
    query ends (SpoolManager.close)."""
    pats = [
        os.path.join(tempfile.gettempdir(), p)
        for p in ("trino_tpu_spool_*", "trino_tpu_torch_spool_*")
    ]
    before = {p: set(glob.glob(p)) for p in pats}
    yield
    for p in pats:
        leaked = set(glob.glob(p)) - before[p]
        assert not leaked, f"spool directories leaked: {sorted(leaked)}"


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh), 8 workers each, the local expectations."""
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    return (
        JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=8),
        DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=8, device="cpu"),
        {sql: sorted(local.execute(sql).rows) for sql in (SQL, CHAOS_SQL)},
    )


def _retry_counts(pkg: str) -> dict:
    c = mod(pkg, "telemetry.metrics").task_retries_counter()
    return {o: c.labels(o).value() for o in ("retry", "fail")}


def _run(pkg: str, runner, sql: str, settings, arm) -> dict:
    """One statement under `settings` with the injector armed by
    `arm(injector)`: rows (or the error), visits, discards and the
    retry-counter deltas."""
    inj = mod(pkg, "runtime.retry").FAILURE_INJECTOR
    inj.clear()
    for s in settings:
        runner.execute("set session " + s)
    before = _retry_counts(pkg)
    arm(inj)
    out = {}
    try:
        out["rows"] = sorted(runner.execute(sql).rows)
    except Exception as e:  # noqa: BLE001 — the class and text are compared
        out["error"] = (type(e).__name__, str(e))
    visits = dict(inj.visits)
    inj.clear()
    after = _retry_counts(pkg)
    out["visits"] = visits
    out["retries"] = {o: after[o] - before[o] for o in after}
    out["discards"] = runner.last_stage_executor.dedup_discards
    return out


def _reset(runner):
    runner.execute("set session retry_policy = 'NONE'")
    runner.execute("set session fault_tolerant_execution = false")


INJECTIONS = {
    # tests/test_fte.py: the final stage fails once after its body ran
    "final_finish": ("retry_policy = 'TASK'", SQL, [("stage:2:finish", 1)]),
    # a stage fails twice at its start
    "start_twice": ("retry_policy = 'TASK'", SQL, [("stage:1", 2)]),
    # the scan stage's budget runs out: StageFailedException after 4 attempts
    "budget_exhausted": ("retry_policy = 'TASK'", SQL, [("stage:0", 99)]),
    # fault_tolerant_execution alone turns the TASK machinery on
    "fte_property": ("fault_tolerant_execution = true", SQL, [("stage:2:finish", 1)]),
    # after attempt 0 spooled: the retry spools a duplicate the consumer drops
    "duplicate_attempt": ("retry_policy = 'TASK'", SQL, [("stage:0:spooled", 1)]),
    # tests/test_chaos.py: any stage fails twice (the first stages hit)
    "chaos_stages": ("retry_policy = 'TASK'", CHAOS_SQL, [("stage:", 2)]),
    # clean runs under each setting
    "clean_task": ("retry_policy = 'TASK'", SQL, []),
    "clean_fte": ("fault_tolerant_execution = true", SQL, []),
}


@pytest.mark.parametrize("case", list(INJECTIONS))
def test_injected_failures_equal_jax(meshes, case):
    """Rows, visits, discards, retry-counter deltas and the error text of
    each injection equal the JAX mesh's; the rows equal the local run."""
    jax_mesh, port_mesh, expected = meshes
    setting, sql, arms = INJECTIONS[case]

    def arm(inj):
        for point, times in arms:
            inj.inject(point, times=times)

    got = {}
    for p, r in (("trino_tpu", jax_mesh), ("trino_tpu_torch", port_mesh)):
        try:
            got[p] = _run(p, r, sql, [setting], arm)
        finally:
            _reset(r)
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    port = got["trino_tpu_torch"]
    if case == "budget_exhausted":
        assert port["error"][0] == "StageFailedException"
        assert port["visits"]["stage:0"] == 4
        assert port["retries"] == {"retry": 3, "fail": 1}
        return
    assert port["rows"] == expected[sql]
    if case in ("final_finish", "fte_property"):
        # finished stages are never re-run; the failed stage ran twice
        assert port["visits"]["stage:0"] == 1 and port["visits"]["stage:2"] == 2
    if case == "duplicate_attempt":
        assert port["visits"]["stage:0"] == 2
        assert port["discards"] == 1 and port["retries"]["retry"] == 1


def test_chaos_latency_absorbed(meshes):
    """tests/test_chaos.py's latency spikes: two stalled stages (the sleep
    stubbed out) and two failed ones still give the local rows."""
    _, port_mesh, expected = meshes
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR, InjectedFailure

    slept = []
    port_mesh.execute("set session retry_policy = 'TASK'")
    try:
        FAILURE_INJECTOR.sleep = slept.append
        FAILURE_INJECTOR.inject("stage:", times=2, error=InjectedFailure)
        FAILURE_INJECTOR.inject_latency("stage:", delay_s=0.3, times=2)
        assert sorted(port_mesh.execute(CHAOS_SQL).rows) == expected[CHAOS_SQL]
    finally:
        _reset(port_mesh)
    assert slept == [0.3, 0.3]


def test_recovery_decisions_in_ledger(meshes):
    """Each recovery is a `recovery` decision of the statement's ledger,
    the same sequence as the JAX mesh's."""
    jax_mesh, port_mesh, _ = meshes
    from trino_tpu.telemetry.profile_store import ProfileStore as JStore
    from trino_tpu_torch.telemetry.profile_store import ProfileStore

    seqs = {}
    for p, r, store in (
        ("trino_tpu", jax_mesh, JStore()), ("trino_tpu_torch", port_mesh, ProfileStore())
    ):
        r.profile_store = store
        inj = mod(p, "runtime.retry").FAILURE_INJECTOR
        try:
            r.execute("set session retry_policy = 'TASK'")
            inj.inject("stage:1", times=2)
            r.execute(SQL)
            led = store.get(store.refs()[-1]["query_id"])["decisions"]
            seqs[p] = [
                (d["kind"], d["site"], d["choice"], d["alternative"], d["inputs"])
                for d in led["decisions"] if d["kind"] == "recovery"
            ]
        finally:
            r.profile_store = None
            _reset(r)
    assert seqs["trino_tpu_torch"] == seqs["trino_tpu"]
    assert [s[2] for s in seqs["trino_tpu_torch"]] == ["retry", "retry"]


def test_spooled_join_keeps_placements_and_probe_search():
    """Q3 under TASK on the 4-worker mesh: every distributed stage spools
    and rehydrates, the rows equal the local run, and the joins after the
    rehydrated shards still take the sorted-probe search under
    `pallas_probe`."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    m = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    m.execute("set session pallas_probe = true")
    expected = sorted(
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu").execute(QUERIES[3]).rows
    )
    m.execute("set session retry_policy = 'TASK'")
    before = ls.locate_sorted_reference.launches
    assert sorted(m.execute(QUERIES[3]).rows) == expected
    ex = m.last_stage_executor
    assert ls.locate_sorted_reference.launches > before
    assert ex.counters["spool_write"] == 4 and ex.counters["spool_read"] >= 4
    assert ex.spool_stats["bytes_written"] > 0 and ex.spool_stats["bytes_read"] > 0
    assert not os.path.exists(ex.spool.dir)


# -- the spool, unit by unit (tests/test_fte.py) ---------------------------------


def _batch(pkg: str, data, mask, dictionary=None, typ="BIGINT"):
    T = mod(pkg, "types")
    col = mod(pkg, "columnar")
    if pkg == "trino_tpu":
        return col.Batch([col.Column(np.asarray(data), getattr(T, typ), None, dictionary)],
                         np.asarray(mask))
    import torch

    return col.Batch(
        [col.Column(torch.as_tensor(np.asarray(data)), getattr(T, typ), None, dictionary)],
        torch.as_tensor(np.asarray(mask)),
    )


def _symbols(pkg: str, typ="BIGINT"):
    return [mod(pkg, "planner.plan").Symbol("x", getattr(mod(pkg, "types"), typ))]


def test_spool_roundtrip(pkg, tmp_path):
    """Spooled fragment outputs rehydrate exactly, NULLs included."""
    T = mod(pkg, "types")
    col = mod(pkg, "columnar")
    plan = mod(pkg, "planner.plan")
    sp = mod(pkg, "runtime.fte").SpoolManager(str(tmp_path))
    valid = np.arange(8) % 2 == 0
    if pkg == "trino_tpu":
        cols = [col.Column(np.arange(8, dtype=np.int64), T.BIGINT, None),
                col.Column(np.linspace(0, 1, 8), T.DOUBLE, valid)]
        b = col.Batch(cols, np.arange(8) < 5)
    else:
        import torch

        cols = [col.Column(torch.arange(8, dtype=torch.int64), T.BIGINT, None),
                col.Column(torch.linspace(0, 1, 8, dtype=torch.float64), T.DOUBLE,
                           torch.as_tensor(valid))]
        b = col.Batch(cols, torch.arange(8) < 5)
    sp.save("q1", 3, [b], None)
    syms = [plan.Symbol("a", T.BIGINT), plan.Symbol("b", T.DOUBLE)]
    out = sp.load("q1", 3, syms, [None, None])
    assert len(out) == 1 and out[0].to_pylist() == b.to_pylist()
    assert sp.exists("q1", 3) and not sp.exists("q1", 4)


def test_spool_rides_filesystem_spi(pkg, tmp_path):
    """The spool resolves its storage through the filesystem SPI; a remote
    scheme fails loudly at configuration time."""
    fte = mod(pkg, "runtime.fte")
    s = fte.SpoolManager(str(tmp_path / "spool"))
    b = _batch(pkg, np.arange(4), np.ones(4, bool))
    s.save("q1", 0, [b], _symbols(pkg))
    assert s.exists("q1", 0)
    out = s.load("q1", 0, _symbols(pkg), [None])
    assert np.array_equal(np.asarray(out[0].columns[0].data), np.arange(4))
    with pytest.raises(NotImplementedError, match="s3"):
        fte.SpoolManager("s3://bucket/spool")


def test_crash_atomic_save_leaves_no_torn_npz(pkg, tmp_path, monkeypatch):
    """A writer killed mid-save leaves nothing a retrying consumer could
    load; the next writer succeeds on the same key."""
    fmod = mod(pkg, "runtime.fte")
    sp = fmod.SpoolManager(str(tmp_path / "spool"))
    b, syms = _batch(pkg, np.arange(4, dtype=np.int64), np.ones(4, bool)), _symbols(pkg)

    class Killed(RuntimeError):
        pass

    real_savez = fmod.np.savez

    def torn_savez(f, **arrays):
        f.write(b"\x93NUMPY-torn")
        raise Killed("writer killed mid-save")

    monkeypatch.setattr(fmod.np, "savez", torn_savez)
    with pytest.raises(Killed):
        sp.save("q1", 0, [b], syms)
    assert not sp.exists("q1", 0)
    assert os.listdir(sp.dir) == []
    assert sp.load("q1", 0, syms, [None]) is None
    monkeypatch.setattr(fmod.np, "savez", real_savez)
    sp.save("q1", 0, [b], syms)
    assert sp.load("q1", 0, syms, [None])[0].to_pylist() == b.to_pylist()


def test_duplicate_attempts_dedup_and_discard(pkg, tmp_path):
    """The first committed attempt wins for every consumer, a later commit
    is told which attempt won, and the losing attempts are deleted unread;
    the attempt-keyed names are the JAX package's."""
    sp = mod(pkg, "runtime.fte").SpoolManager(str(tmp_path / "spool"))
    syms = _symbols(pkg)
    b0 = _batch(pkg, np.arange(4), np.ones(4, bool))
    b1 = _batch(pkg, np.arange(4) + 100, np.ones(4, bool))
    sp.save("q1", 2, [b0], syms, attempt_id=0)
    sp.save("q1", 2, [b1], syms, attempt_id=1)
    sp.save("q1", 12, [b1], syms, attempt_id=3)  # another fragment
    assert sorted(os.listdir(sp.dir)) == ["q1_f12_a3.npz", "q1_f2.npz", "q1_f2_a1.npz"]
    assert sp.attempts("q1", 2) == [0, 1] and sp.attempts("q1", 12) == [3]
    assert sp.dedup.commit("q1", 2, 0) == 0
    assert sp.dedup.commit("q1", 2, 1) == 0
    assert sp.dedup.committed("q1", 2) == 0
    assert sp.discard_duplicates("q1", 2, 0) == 1
    assert sp.attempts("q1", 2) == [0]
    assert sp.load("q1", 2, syms, [None], attempt_id=0)[0].to_pylist() == b0.to_pylist()
    sp.dedup.clear("q1")
    assert sp.dedup.committed("q1", 2) is None


def test_spill_tier_names_unchanged(tmp_path):
    """The spill tier rides attempt 0: its files keep their names."""
    from trino_tpu_torch.runtime.spill import SpillManager

    sm = SpillManager(str(tmp_path))
    b = _batch("trino_tpu_torch", np.arange(4), np.ones(4, bool))
    sm.save("jb", 0, [b])
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].endswith("_f0.npz") and "_a" not in names[0]
    assert sm.load("jb", 0)[0].to_pylist() == b.to_pylist()
    sm.close()


def test_spooled_dictionary_refs_rehydrate_after_restart(pkg, tmp_path):
    """A spooled varchar column ships dictionary CODES; after a restart the
    (key, version) ref resolves through the dictionary service snapshot,
    and a mismatched dictionary raises instead of mis-decoding."""
    StringDictionary = mod(pkg, "columnar.dictionary").StringDictionary
    svc = mod(pkg, "runtime.dictionary_service").GlobalDictionaryService()
    fte = mod(pkg, "runtime.fte")
    d = StringDictionary(["APAC", "EMEA", "LATAM"])
    key, version = svc.register("tpch", "tiny", "region", "r_name", d).ref
    syms = _symbols(pkg, "VARCHAR")
    b = _batch(pkg, np.array([0, 2, 1, 2], dtype=np.int64), np.ones(4, bool), d, "VARCHAR")
    fte.SpoolManager(str(tmp_path / "spool")).save("q7", 1, [b], syms)
    assert svc.ref_of(d) == (key, version)
    snap = str(tmp_path / "dictionaries.json")
    svc.save_snapshot(snap)
    assert not os.path.exists(snap + ".tmp")  # tmp file, then rename
    svc.reset()
    assert svc.ref_of(d) is None
    assert svc.load_snapshot(snap) >= 1
    d2 = svc.resolve(key, version)
    assert tuple(d2.values) == ("APAC", "EMEA", "LATAM")
    out = fte.SpoolManager(str(tmp_path / "spool")).load("q7", 1, syms, [d2])
    assert out[0].to_pylist() == b.to_pylist()
    with pytest.raises(ValueError, match="dictionary"):
        fte.SpoolManager(str(tmp_path / "spool")).load(
            "q7", 1, syms, [StringDictionary(["A", "B"])]
        )


def test_dictionary_snapshot_degrades_loudly(tmp_path, caplog):
    """A missing or torn snapshot adopts nothing and warns, in both
    packages; the snapshot documents are the same."""
    docs = {}
    for p in PKGS:
        svc = mod(p, "runtime.dictionary_service").GlobalDictionaryService()
        d = mod(p, "columnar.dictionary").StringDictionary(["a", "b"])
        svc.register("tpch", "tiny", "t", "c", d)
        path = tmp_path / f"{p}.json"
        svc.save_snapshot(str(path))
        docs[p] = path.read_text()
        torn = tmp_path / f"{p}_torn.json"
        torn.write_text(docs[p][: len(docs[p]) // 2])
        caplog.clear()
        assert svc.load_snapshot(str(torn)) == 0
        assert "unreadable" in caplog.text
        caplog.clear()
        assert svc.load_snapshot(str(tmp_path / "missing.json")) == 0
        assert "missing" in caplog.text
    assert docs["trino_tpu_torch"] == docs["trino_tpu"]
