"""The port's memory-pressure ladder (budget -> revoke -> wave -> kill) held
against the JAX package, unit by unit, on seeded inputs: the budget
arithmetic, the reservation tree, the host row hash and partitioning, the
spill store, the revocation registry and the low-memory killer, the
external sort, the memory config and the metrics.  Queries under budgets
are in tests/test_torch_spill_e2e.py and tests/test_torch_spill_ops.py
(local) and tests/test_torch_spill_mesh.py (the 4-worker mesh).

Every comparison here is exact: budgets, wave counts, byte counts, hash
words, partition rows and sorted rows.
"""

import os
import threading

import numpy as np
import pytest
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch
from trino_tpu.columnar import Column as JColumn
from trino_tpu.columnar.dictionary import StringDictionary as JDict
from trino_tpu.parallel import serde as jserde
from trino_tpu.runtime import memory as jmem
from trino_tpu.runtime import spill as JS
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.dictionary import StringDictionary
from trino_tpu_torch.parallel import serde
from trino_tpu_torch.runtime import memory as pmem
from trino_tpu_torch.runtime import spill as S
from trino_tpu_torch.telemetry.metrics import (
    REGISTRY,
    memory_kills_counter,
    memory_revocations_counter,
    memory_waves_counter,
)

# -- seeded batches, one per engine --------------------------------------------

WORDS = ["", "a", "bb", "ccc", "delta", "zz", "éclair"]


def _seeded_columns(seed: int, n: int):
    """(type name, data, valid, dictionary values) per column: a bigint, an
    int32 date, a double with -0.0 and NaN, a boolean, a dictionary string,
    a short decimal and a long decimal's [n, 2] limb plane; NULLs in every
    column but the first."""
    rng = np.random.default_rng(seed)
    valid = lambda: rng.random(n) > 0.2  # noqa: E731
    dbl = rng.normal(size=n)
    dbl[::7] = -0.0
    dbl[3::11] = np.nan
    limbs = np.stack(
        [rng.integers(-3, 3, n, dtype=np.int64), rng.integers(-(2**62), 2**62, n, dtype=np.int64)],
        axis=-1,
    )
    return [
        ("bigint", rng.integers(-50, 50, n, dtype=np.int64), None, None),
        ("date", rng.integers(8000, 8100, n, dtype=np.int32), valid(), None),
        ("double", dbl, valid(), None),
        ("boolean", rng.random(n) > 0.5, valid(), None),
        ("varchar", rng.integers(0, len(WORDS), n, dtype=np.int32), valid(), WORDS),
        ("decimal(12,2)", rng.integers(-10**6, 10**6, n, dtype=np.int64), valid(), None),
        ("decimal(38,2)", limbs, valid(), None),
    ]


def _types(mod, name):
    return {
        "bigint": mod.BIGINT,
        "date": mod.DATE,
        "double": mod.DOUBLE,
        "boolean": mod.BOOLEAN,
        "varchar": mod.VARCHAR,
        "decimal(12,2)": mod.DecimalType(12, 2),
        "decimal(38,2)": mod.DecimalType(38, 2),
    }[name]


def make_batches(seed: int, n: int, live_fraction: float = 0.85):
    """The same rows as a JAX batch and as a port batch (CPU tensors)."""
    rng = np.random.default_rng(seed + 1)
    mask = rng.random(n) < live_fraction
    jcols, pcols = [], []
    for name, data, valid, words in _seeded_columns(seed, n):
        jd = JDict(list(words)) if words is not None else None
        pd = StringDictionary(list(words)) if words is not None else None
        jcols.append(JColumn(data, _types(JT, name), valid, jd))
        pcols.append(
            Column(
                torch.from_numpy(data.copy()), _types(T, name),
                None if valid is None else torch.from_numpy(valid.copy()), pd,
            )
        )
    return JBatch(jcols, mask), Batch(pcols, torch.from_numpy(mask.copy()))


#: key channel sets the JAX package can hash (everything but the limb plane)
KEY_SETS = [[0], [1], [2], [3], [4], [5], [0, 4], [4, 2, 1], [0, 1, 2, 3, 4, 5]]


class _Props:
    def __init__(self, **kv):
        self.kv = kv

    def get(self, k):
        return self.kv.get(k, {"spill_enabled": True}.get(k, 0))


# -- budget arithmetic ---------------------------------------------------------


@pytest.mark.parametrize("override", [0, 1, 2, 3, 8, 64, 65, 1000])
def test_wave_count_matches_jax_over_a_grid(override):
    props = _Props(memory_wave_partitions=override)
    for need in (0, 1, 10, 999, 1000, 1001, 4096, 10**6, 1 << 40):
        for budget in (0, 1, 7, 300, 500, 1000, 4096, 10**9):
            assert S.wave_count(need, budget, props) == JS.wave_count(need, budget, props)
            assert S.wave_count(need, budget) == JS.wave_count(need, budget)
    assert S.MAX_WAVES == JS.MAX_WAVES == 64


def test_session_and_effective_budget_match_jax_over_a_grid():
    values = (0, 1, 500, 900, 10**9)
    for a in values:
        for b in values:
            props = _Props(query_max_memory=a, query_max_memory_bytes=b)
            assert S.session_budget(props) == JS.session_budget(props)
            for pool_limit in values:
                for query_limit in values:
                    jp = jmem.MemoryPool(limit_bytes=pool_limit)
                    pp = pmem.MemoryPool(limit_bytes=pool_limit)
                    jq = jp.query_context("q", query_limit).child("op")
                    pq = pp.query_context("q", query_limit).child("op")
                    assert S.effective_budget(props, pq) == JS.effective_budget(props, jq)
    assert S.session_budget(None) == JS.session_budget(None) == 0
    assert S.spill_to_disk(None) and S.spill_to_disk(_Props(spill_enabled=True))
    assert not S.spill_to_disk(_Props(spill_enabled=False))


# -- the reservation tree ------------------------------------------------------


def _deltas(seed: int):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(-300, 700, 60)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memory_tree_raises_at_the_same_delta_as_jax(seed):
    """The same seeded reservations (adds, sets and closes over two query
    contexts under a pool limit and a query limit) raise at the same steps
    and leave the same reserved and peak bytes at every node."""
    trees = []
    for mod in (jmem, pmem):
        pool = mod.MemoryPool(limit_bytes=4000)
        q1 = pool.query_context("q1", 2500)
        q2 = pool.query_context("q2")
        trees.append((pool, q1, q2, [q1.child("a"), q1.child("b"), q2.child("c")]))
    rng = np.random.default_rng(seed + 10)
    for step, d in enumerate(_deltas(seed)):
        i = int(rng.integers(0, 3))
        op = ("add", "set", "close")[int(rng.integers(0, 3))]
        outcomes = []
        for mod, (pool, q1, q2, ops) in zip((jmem, pmem), trees):
            ctx = ops[i]
            try:
                if op == "add":
                    ctx.add_bytes(max(d, -ctx.reserved))
                elif op == "set":
                    ctx.set_bytes(max(d, 0) * 3)
                else:
                    ctx.close()
                outcomes.append("ok")
            except mod.ExceededMemoryLimitException as e:
                outcomes.append(("raised", e.node.name))
            outcomes.append(
                tuple((n.reserved, n.peak) for n in (pool.root, q1, q2, *ops))
            )
        assert outcomes[:2] == outcomes[2:], step


def test_releases_never_fail_after_a_limit_shrink():
    pool = pmem.MemoryPool(limit_bytes=1000)
    ctx = pool.query_context("q").child("op")
    ctx.set_bytes(900)
    pool.root.limit_bytes = 100
    ctx.add_bytes(-100)  # a release over the new limit still goes through
    assert pool.root.reserved == 800
    with pytest.raises(pmem.ExceededMemoryLimitException):
        ctx.add_bytes(1)


def test_concurrent_reservations_never_over_admit():
    """Eight threads race one pool slot under a shortened switch interval:
    the tree lock makes check-and-reserve atomic, so exactly one wins."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            pool = pmem.MemoryPool(limit_bytes=1000)
            wins, errors = [], []
            barrier = threading.Barrier(8)

            def worker(i):
                ctx = pool.query_context(f"q{i}").child("op")
                barrier.wait(timeout=10)
                try:
                    ctx.add_bytes(600)
                    wins.append(i)
                except pmem.ExceededMemoryLimitException:
                    errors.append(i)

            threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
                assert not t.is_alive()
            assert len(wins) == 1 and len(errors) == 7
            assert pool.root.reserved == 600
    finally:
        sys.setswitchinterval(old)


def test_concurrent_reservation_stress_accounting_consistent():
    pool = pmem.MemoryPool()

    def worker(i):
        q = pool.query_context(f"q{i}")
        ctx = q.child("op")
        for j in range(300):
            ctx.add_bytes((j % 7) + 1)
            ctx.add_bytes(-((j % 7) + 1))
        ctx.close()
        q.force_release()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert pool.root.reserved == 0
    assert not pool.root.query_children


@pytest.mark.parametrize("seed", [3, 4])
def test_batch_bytes_match_jax(seed):
    jb, pb = make_batches(seed, 257)
    jb2, pb2 = make_batches(seed + 100, 64)
    assert pmem.batch_bytes(pb) == jmem.batch_bytes(jb)
    assert pmem.batches_bytes([pb, pb2, pb]) == jmem.batches_bytes([jb, jb2, jb])


# -- host row hash and partitioning --------------------------------------------


@pytest.mark.parametrize("keys", KEY_SETS, ids=[str(k) for k in KEY_SETS])
@pytest.mark.parametrize("seed", [5, 6])
def test_stable_row_hash_is_bit_equal_to_jax(seed, keys):
    jb, pb = make_batches(seed, 513)
    np.testing.assert_array_equal(
        serde.stable_row_hash(pb, keys), jserde.stable_row_hash(jb, keys)
    )


def test_long_decimal_key_hashes_its_two_limbs():
    """A long-decimal key (where the JAX package's hash raises a
    broadcasting error) hashes as its high limb, then its low limb."""
    jb, pb = make_batches(7, 100)
    with pytest.raises(ValueError):
        jserde.stable_row_hash(jb, [6])
    c = pb.columns[6]
    split = Batch(
        [
            Column(c.data[:, 0].contiguous(), T.BIGINT, c.valid),
            Column(c.data[:, 1].contiguous(), T.BIGINT, c.valid),
        ],
        pb.row_mask,
    )
    np.testing.assert_array_equal(
        serde.stable_row_hash(pb, [6]), serde.stable_row_hash(split, [0, 1])
    )


def _rows(b) -> list:
    """A host batch's live rows as tuples of numpy scalars (NULL = None)."""
    m = np.asarray(b.mask())
    out = []
    for i in np.nonzero(m)[0]:
        row = []
        for c in b.columns:
            if c.valid is not None and not bool(np.asarray(c.valid)[i]):
                row.append(None)
                continue
            v = np.asarray(c.data)[i]
            if c.dictionary is not None:
                v = c.dictionary.values[int(v)]
            elif np.ndim(v):
                v = tuple(int(x) for x in v)
            elif isinstance(v, np.floating) and np.isnan(v):
                v = "nan"
            else:
                v = v.item()
            row.append(v)
        out.append(tuple(row))
    return out


@pytest.mark.parametrize("n_parts", [2, 3, 8])
@pytest.mark.parametrize("keys", [[0], [4, 2], [1, 3, 5]], ids=str)
def test_partition_batches_match_jax(keys, n_parts):
    """Every bucket holds the JAX package's rows in its order, long-decimal
    payload columns included, and every bucket batch is dense."""
    pairs = [make_batches(s, n) for s, n in ((8, 300), (9, 1), (10, 77))]
    jout = jserde.partition_batches([j for j, _ in pairs], keys, n_parts)
    pout = serde.partition_batches([p for _, p in pairs], keys, n_parts)
    assert len(jout) == len(pout) == n_parts
    for jb_list, pb_list in zip(jout, pout):
        assert len(jb_list) == len(pb_list)
        for jb, pb in zip(jb_list, pb_list):
            assert bool(pb.mask().all()) and pb.capacity == jb.capacity
            assert _rows(pb) == _rows(jb)


def test_host_wave_slice_matches_jax():
    jb, pb = make_batches(11, 400)
    for wave in range(4):
        jp = JS.host_wave_slice(jb, [0, 4], 4, wave)
        pp = S.host_wave_slice(pb, [0, 4], 4, wave)
        assert (jp is None) == (pp is None)
        if pp is not None:
            assert _rows(pp) == _rows(jp)


def test_dictionary_payload_round_trip():
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

    d = StringDictionary(["x", "yy", "zzz"])
    payload = serde._dict_payload(d)
    back = serde._dict_restore(payload)
    assert back == d and back.values == ("x", "yy", "zzz")
    assert serde._dict_payload(None) is None and serde._dict_restore(None) is None
    assert jserde._dict_payload(JDict(["x", "yy", "zzz"])) == payload
    ref = DICTIONARY_SERVICE.ref_of(d)
    if ref is not None:  # a dictionary the service assigned travels as a ref
        assert payload[0] == "ref"


# -- the spill store -----------------------------------------------------------


def test_spill_manager_round_trip(tmp_path):
    """Dictionary, long-decimal and NULL columns survive a save and load
    exactly, batches with different dictionaries are unified on save, an
    empty part loads as [], and close leaves the directory empty."""
    _, b1 = make_batches(12, 50)
    _, b2 = make_batches(13, 20)
    cols = list(b2.columns)
    c = cols[4]
    cols[4] = Column(c.data, c.type, c.valid, StringDictionary(["a", "ccc", "q", "r", "s", "t", "zz"]))
    b2 = Batch(cols, b2.row_mask)
    sp = S.SpillManager(directory=str(tmp_path))
    n = sp.save("t", 0, [b1, b2])
    assert sp.save("t", 1, []) == 0
    out = sp.load("t", 0)
    assert n == pmem.batches_bytes(out) > 0
    assert [_rows(b) for b in out] == [_rows(b1), _rows(b2)]
    assert out[0].columns[4].dictionary is out[1].columns[4].dictionary
    assert out[0].columns[6].data.shape == (50, 2)
    assert sp.load("t", 1) == [] and sp.load("never", 3) == []
    assert sp.bytes_spilled == n
    assert any(p.endswith(".npz") for p in os.listdir(tmp_path))
    sp.close()
    sp.close()  # idempotent
    assert os.listdir(tmp_path) == []


def test_spill_manager_own_directory_is_removed():
    sp = S.SpillManager()
    _, b = make_batches(14, 10)
    sp.save("t", 0, [b])
    d = sp.spool.dir
    assert os.path.isdir(d)
    sp.close()
    assert not os.path.exists(d)


def test_spool_load_validates_dictionaries(tmp_path):
    from trino_tpu_torch.planner import plan as P
    from trino_tpu_torch.runtime.fte import SpoolManager

    spool = SpoolManager(directory=str(tmp_path))
    _, b = make_batches(15, 30)
    symbols = [P.Symbol(f"c{i}", c.type) for i, c in enumerate(b.columns)]
    dicts = [c.dictionary for c in b.columns]
    spool.save("q", 0, [b], symbols)
    with pytest.raises(ValueError, match="dictionaries"):
        spool.load("q", 0, symbols, dicts[:2])
    small = list(dicts)
    small[4] = StringDictionary(["a"])
    with pytest.raises(ValueError, match="out of range"):
        spool.load("q", 0, symbols, small)
    assert _rows(spool.load("q", 0, symbols, dicts)[0]) == _rows(b)
    spool.close()


def test_partition_side_in_ram_and_on_disk(tmp_path):
    _, b = make_batches(16, 200)
    ram = S.partition_side([b], [0], 4, None, "x")
    sp = S.SpillManager(directory=str(tmp_path))
    disk = S.partition_side([b], [0], 4, sp, "x")
    for part in range(4):
        assert [_rows(x) for x in ram.load_part(part)] == [_rows(x) for x in disk.load_part(part)]
    sp.close()
    assert os.listdir(tmp_path) == []


def test_host_boundary_passes_cpu_batches_through():
    _, b = make_batches(17, 8)
    assert S.pull_host(b) is b
    host = S.pull_host([b, b], b)
    assert host[0] == [b, b] and host[1] is b
    assert S.to_device(b, torch.device("cpu")) is b


# -- revocation and the killer -------------------------------------------------


class _Owner:
    def __init__(self):
        self.killed = None

    def kill(self, reason, detail=None):
        self.killed = reason


def _escalated_pool(limit):
    from trino_tpu_torch.runtime.lifecycle import LowMemoryKiller

    pool = pmem.MemoryPool(limit_bytes=limit)
    pool.root.on_exceeded = S.MemoryEscalation(LowMemoryKiller())
    return pool


def _spill_fn(ctx, order=None, name=None):
    def spill():
        if order is not None:
            order.append(name)
        freed = ctx.reserved
        ctx.set_bytes(0)
        return freed

    return spill


def test_registry_revokes_largest_first():
    pool = pmem.MemoryPool()
    q = pool.query_context("q")
    a, b, c = q.child("a"), q.child("b"), q.child("c")
    a.set_bytes(100)
    b.set_bytes(900)
    c.set_bytes(400)
    order = []
    hs = [
        S.REVOCABLES.register(S.RevocableOperator(n, ctx, _spill_fn(ctx, order, n)))
        for n, ctx in (("a", a), ("b", b), ("c", c))
    ]
    try:
        assert S.REVOCABLES.revoke_largest() == 900
        assert S.REVOCABLES.revoke_largest() == 400
        assert S.REVOCABLES.revoke_largest() == 100
        assert S.REVOCABLES.revoke_largest() == 0
        assert order == ["b", "c", "a"]
        assert all(h.revoked for h in hs)
    finally:
        for h in hs:
            h.finish()
    assert not S.REVOCABLES.live()


def test_revoke_runs_before_killer_and_query_survives():
    pool = _escalated_pool(1000)
    owner = _Owner()
    q1 = pool.query_context("q1")
    q1.owner = owner
    held = q1.child("build")
    held.set_bytes(800)
    h = S.REVOCABLES.register(S.RevocableOperator("join", held, _spill_fn(held)))
    rev0 = memory_revocations_counter().value()
    try:
        pool.query_context("q2").child("op").add_bytes(600)
    finally:
        h.finish()
    assert h.revoked and owner.killed is None
    assert memory_revocations_counter().value() == rev0 + 1
    assert pool.root.reserved == 600


def test_killer_picks_the_largest_query():
    pool = _escalated_pool(1000)
    small_owner, big_owner = _Owner(), _Owner()
    q_small = pool.query_context("qs")
    q_small.owner = small_owner
    held = q_small.child("agg")
    held.set_bytes(50)
    q_big = pool.query_context("qb")
    q_big.owner = big_owner
    q_big.child("op").set_bytes(900)
    h = S.REVOCABLES.register(S.RevocableOperator("agg", held, _spill_fn(held)))
    kills0 = memory_kills_counter().value()
    try:
        pool.query_context("q2").child("op").add_bytes(600)
    finally:
        h.finish()
    assert h.revoked
    assert big_owner.killed == "memory" and small_owner.killed is None
    assert q_big.parent is None
    assert memory_kills_counter().value() == kills0 + 1


def test_killer_refuses_when_the_requester_is_largest():
    pool = _escalated_pool(1000)
    other = pool.query_context("q0")
    other.child("op").set_bytes(100)
    q1 = pool.query_context("q1")
    q1.child("op").set_bytes(500)
    with pytest.raises(pmem.ExceededMemoryLimitException):
        q1.child("op2").add_bytes(700)  # nothing to revoke; q1 is largest
    assert pool.root.reserved == 600 and other.parent is pool.root


def test_killed_statement_aborts_at_its_next_check():
    from trino_tpu_torch.runtime.lifecycle import QueryContext, QueryKilledException

    ctx = QueryContext("q")
    ctx.check()
    ctx.kill("memory", "killed by the low-memory killer")
    ctx.kill("canceled")  # the first reason wins
    with pytest.raises(QueryKilledException, match="low-memory killer"):
        ctx.check()


def test_statement_end_closes_registered_spills(tmp_path):
    from trino_tpu_torch.runtime import lifecycle

    ctx = lifecycle.QueryContext("q")
    token = lifecycle.set_current(ctx)
    try:
        sp = S.SpillManager(directory=str(tmp_path))
        _, b = make_batches(18, 10)
        sp.save("t", 0, [b])
        mem = lifecycle.query_memory_context(0)
        mem.child("op").set_bytes(123)
        assert lifecycle.memory_pool().root.query_children.count(mem) == 1
    finally:
        lifecycle.reset_current(token)
    ctx.release_spills()
    ctx.release_memory()
    assert os.listdir(tmp_path) == []
    assert mem.parent is None and mem not in lifecycle.memory_pool().root.query_children


# -- the external sort ---------------------------------------------------------


def _sort_inputs(seed: int):
    rng = np.random.default_rng(seed)
    words = sorted({"".join(rng.choice(list("abcxyz"), 3)) for _ in range(40)})
    out = []
    for i in range(6):
        n = 256
        k1 = rng.integers(0, 5, n, dtype=np.int64)
        k2 = rng.integers(0, len(words), n, dtype=np.int32)
        v = rng.normal(size=n)
        valid = rng.random(n) > 0.1
        mask = rng.random(n) > 0.2
        sub = sorted(set(rng.choice(words, 20).tolist()) | {words[0]})
        codes = np.array([sub.index(w) if w in sub else 0 for w in np.asarray(words)[k2]], np.int32)
        out.append((k1, codes, sub, v, valid, mask))
    return out


@pytest.mark.parametrize("limit", [0, 3000, 9000])
def test_external_sort_matches_jax(limit):
    """ORDER BY k1 DESC NULLS LAST, the string ASC, v ASC NULLS FIRST over
    six seeded batches with batch-local dictionaries: under a tiny limit
    both engines spill runs (the same count) and give the same rows in the
    same order; without one neither spills."""
    from trino_tpu.ops.common import SortKey as JKey
    from trino_tpu.ops.sort import OrderByOperator as JSort
    from trino_tpu_torch.ops.common import SortKey
    from trino_tpu_torch.ops.sort import OrderByOperator

    jb, pb = [], []
    for k1, codes, sub, v, valid, mask in _sort_inputs(19):
        jb.append(JBatch([JColumn(k1, JT.BIGINT), JColumn(codes, JT.VARCHAR, None, JDict(sub)),
                          JColumn(v, JT.DOUBLE, valid)], mask))
        pb.append(Batch([Column(torch.from_numpy(k1), T.BIGINT),
                         Column(torch.from_numpy(codes), T.VARCHAR, None, StringDictionary(sub)),
                         Column(torch.from_numpy(v), T.DOUBLE, torch.from_numpy(valid))],
                        torch.from_numpy(mask)))
    jruns, pruns = [], []

    class _Obs:
        def __init__(self, sink):
            self.sink = sink

        def waves(self, op, k):
            self.sink.append(k)

    jop = JSort([JKey(0, False, False), JKey(1, True, False), JKey(2, True, True)],
                memory_ctx=jmem.MemoryPool().query_context("q", limit).child("sort"),
                observer=_Obs(jruns))
    pop = OrderByOperator([SortKey(0, False, False), SortKey(1, True, False), SortKey(2, True, True)],
                          memory_ctx=pmem.MemoryPool().query_context("q", limit).child("sort"),
                          observer=_Obs(pruns))
    jout = list(jop.process(iter(jb)))
    pout = list(pop.process(iter(pb)))
    assert pruns == jruns
    if limit:
        assert pruns and pruns[0] >= 2
    else:
        assert not pruns
    assert _rows(pout[0]) == _rows(jout[0])


# -- config and metrics --------------------------------------------------------


def test_memory_config_matches_jax(tmp_path):
    from trino_tpu import config as jconfig
    from trino_tpu_torch import config

    props = {"memory.pool-limit-bytes": "12345", "memory.spill-dir": str(tmp_path)}
    env = {"TRINO_TPU_MEMORY_POOL_LIMIT_BYTES": "777"}
    for p, e in ((props, {}), (props, env), ({}, {})):
        assert config.load_cluster_config(p, e).memory.describe() == (
            jconfig.load_cluster_config(p, e).memory.describe()
        )
    with pytest.raises(ValueError, match="memory.pool-limit-bytes"):
        config.MemoryConfig.from_properties({"memory.pool-limit-bytes": "x"}, {})


def test_installed_config_arms_the_pool_and_the_spill_dir(tmp_path):
    from trino_tpu_torch import config
    from trino_tpu_torch.runtime.lifecycle import memory_pool, set_memory_pool_limit

    try:
        config.install_config(
            config.load_cluster_config(
                {"memory.pool-limit-bytes": "5000", "memory.spill-dir": str(tmp_path)}, {}
            )
        )
        assert memory_pool().root.limit_bytes == 5000
        sp = S.SpillManager()
        assert sp.spool.dir == str(tmp_path)
        sp.close()
    finally:
        config.reset_config()
        set_memory_pool_limit(0)
    assert config.get_config().memory.spill_dir == ""


def test_metrics_vocabulary_and_rendering():
    snap = REGISTRY.snapshot()
    for op in ("join", "aggregation", "window", "sort"):
        assert f'trino_tpu_memory_waves_total{{operator="{op}"}}' in snap
    for name in ("memory_kills_total", "spill_bytes_total", "memory_revocations_total"):
        assert "trino_tpu_" + name in snap
    before = memory_waves_counter().value(("window",))
    S.PressureObserver().waves("window", 3)
    assert memory_waves_counter().value(("window",)) == before + 3
    text = REGISTRY.render_prometheus()
    assert "# TYPE trino_tpu_memory_waves_total counter" in text
    assert f'trino_tpu_memory_waves_total{{operator="window"}} {before + 3}' in text
    with pytest.raises(ValueError):
        memory_waves_counter().labels("a", "b")


def test_spill_store_made_in_a_prefetch_thread_registers_with_the_statement(tmp_path):
    """A join's probe feed runs in the eager-prefetch thread, and a wave
    stream upstream of it creates its spill store there: the store must
    still register with the statement, so statement end deletes it."""
    from trino_tpu_torch.runtime import lifecycle
    from trino_tpu_torch.runtime.prefetch import eager_prefetch

    ctx = lifecycle.QueryContext("q")
    token = lifecycle.set_current(ctx)
    try:
        def feed():
            sp = S.SpillManager(directory=str(tmp_path))
            sp.save("t", 0, [make_batches(20, 10)[1]])
            yield sp

        (sp,) = list(eager_prefetch(feed()))
        assert os.listdir(tmp_path)
    finally:
        lifecycle.reset_current(token)
    ctx.release_spills()
    assert os.listdir(tmp_path) == [] and sp._closed
