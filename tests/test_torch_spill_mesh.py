"""Queries under memory budgets on the port's 4-worker mesh on the CPU,
against the JAX package's LocalQueryRunner at tpch.tiny: the join in
partition waves (`_wave_join`: spill to disk and in host RAM, the wave
count pinned and automatic, with the sorted-probe kernel's plain version
under `pallas_probe`), the aggregation's exchange in group-hash waves
(`_wave_agg_exchange`) and TPC-H Q3.

Each case holds the rows to the JAX package's local rows (exact; Q3's
ORDER BY in order), requires every wave's expansion to call the probe
search (`StageExecutor._probe_search`'s closure: on the card it launches
the sorted-probe kernel wherever the key planes allow), requires spill
bytes exactly when spill is on, and leaves the spill directory empty and
no revocable handle live.  Unbudgeted mesh runs record no waves and no
spill.
"""

import os

import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.ops import locate_sorted as ls
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.parallel.runner import StageExecutor
from trino_tpu_torch.runtime.spill import REVOCABLES
from trino_tpu_torch.telemetry import metrics as pmetrics

from test_torch_e2e import assert_same_rows
from test_torch_spill_e2e import AGG_SQL, JOIN_SQL

#: name -> (sql, session properties, ORDER BY rows in order, operator that waves)
CASES = {
    "join_k2_disk": (
        JOIN_SQL, dict(query_max_memory=250_000, memory_wave_partitions=2), False, "join",
    ),
    "join_auto_k_ram": (
        JOIN_SQL, dict(query_max_memory=250_000, spill_enabled=False), False, "join",
    ),
    "join_k4_pallas_probe": (
        JOIN_SQL,
        dict(query_max_memory=250_000, memory_wave_partitions=4, pallas_probe=True),
        False, "join",
    ),
    "agg_exchange_auto_k": (AGG_SQL, dict(query_max_memory=150_000), False, "aggregation"),
    "agg_exchange_k2": (
        AGG_SQL, dict(query_max_memory=150_000, memory_wave_partitions=2), False, "aggregation",
    ),
    "q3": (QUERIES[3], dict(query_max_memory=200_000), True, "join"),
}


@pytest.fixture(scope="module")
def jax_local():
    return JaxRunner(catalog="tpch", schema="tiny")


@pytest.fixture(scope="module")
def spill_dir(tmp_path_factory):
    from trino_tpu_torch import config

    d = tmp_path_factory.mktemp("port_mesh_spill")
    config.install_config(config.load_cluster_config({"memory.spill-dir": str(d)}, {}))
    yield str(d)
    config.reset_config()


@pytest.fixture
def wave_probe_calls(monkeypatch):
    """Per wave expansion of the mesh join: how many probe-search calls it
    made (one per worker shard and launch)."""
    calls = {"search": 0}
    waves: list = []
    orig_search = StageExecutor._probe_search
    orig_sized = StageExecutor._sized_expansion

    def probe_search(self):
        search, use_kernel = orig_search(self)

        def counting(*args, **kw):
            calls["search"] += 1
            return search(*args, **kw)

        return counting, use_kernel

    def sized(self, key, *args, **kw):
        before = calls["search"]
        out = orig_sized(self, key, *args, **kw)
        if key[0] == "join_wave":
            waves.append(calls["search"] - before)
        return out

    monkeypatch.setattr(StageExecutor, "_probe_search", probe_search)
    monkeypatch.setattr(StageExecutor, "_sized_expansion", sized)
    return waves


def _mesh(props):
    d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    for k, v in props.items():
        d.properties.set(k, v)
    return d


def _waves(op):
    return pmetrics.memory_waves_counter().value((op,))


@pytest.mark.parametrize("name", list(CASES))
def test_budgeted_mesh_query_matches_jax(name, jax_local, spill_dir, wave_probe_calls):
    sql, props, ordered, op = CASES[name]
    expected = jax_local.execute(sql)
    waves0 = _waves(op)
    spill0 = pmetrics.spill_bytes_counter().value()
    kernel0 = ls.locate_sorted_reference.launches
    d = _mesh(props)
    actual = d.execute(sql)
    assert_same_rows(actual.rows, expected.rows, ordered, float_rtol=1e-9)
    k = _waves(op) - waves0
    pinned = props.get("memory_wave_partitions")
    assert k == pinned if pinned else k >= 2
    assert d.last_stage_executor.counters.get("memory_wave") == k
    spilled = pmetrics.spill_bytes_counter().value() - spill0
    spill_on = op == "join" and props.get("spill_enabled", True)
    assert (spilled > 0) == bool(spill_on)
    assert d.last_stage_executor.counters.get("spill_bytes", 0) == spilled
    if op == "join":
        # every wave that ran called the probe search on every worker shard
        assert 0 < len(wave_probe_calls) <= k
        assert all(n >= 4 for n in wave_probe_calls), wave_probe_calls
        if props.get("pallas_probe"):
            assert ls.locate_sorted_reference.launches - kernel0 >= 4 * len(wave_probe_calls)
    else:
        assert not wave_probe_calls
    assert os.listdir(spill_dir) == []
    assert not REVOCABLES.live()


#: the registry's memory-pressure series: waves, spill bytes, kills and
#: revocations (every query also bumps the query counters and histograms)
PRESSURE_SERIES = (
    "trino_tpu_memory_waves_total",
    "trino_tpu_spill_bytes_total",
    "trino_tpu_memory_kills_total",
    "trino_tpu_memory_revocations_total",
)


def _pressure_snapshot() -> dict:
    return {
        k: v for k, v in pmetrics.REGISTRY.snapshot().items()
        if k.startswith(PRESSURE_SERIES)
    }


@pytest.mark.parametrize("sql", [JOIN_SQL, AGG_SQL, QUERIES[3]], ids=["join", "agg", "q3"])
def test_unbudgeted_mesh_query_records_no_pressure(sql, jax_local, spill_dir):
    before = _pressure_snapshot()
    assert len(before) >= 4  # the four wave operators are pre-registered
    d = _mesh({})
    actual = d.execute(sql)
    assert sorted(actual.rows) == sorted(jax_local.execute(sql).rows)
    assert _pressure_snapshot() == before
    assert "memory_wave" not in d.last_stage_executor.counters


def test_mesh_profile_is_not_ported():
    """The mesh's per-fragment profile is now ported: `last_mesh_profile`
    is a MeshProfile whose JSON has the JAX package's schema, and the
    executor's counters are a view of the profile's."""
    from trino_tpu.runtime.query_stats import FragmentStats as JaxFragmentStats
    from trino_tpu.runtime.query_stats import MeshProfile as JaxMeshProfile
    from trino_tpu_torch.runtime.query_stats import MeshProfile

    d = _mesh({})
    d.execute(AGG_SQL)
    prof = d.last_mesh_profile
    assert isinstance(prof, MeshProfile)
    assert d.last_stage_executor.counters is prof.counters
    doc = prof.to_json()
    ref = JaxMeshProfile()
    ref.fragment(0).close()
    jdoc = ref.to_json()
    assert set(doc) == set(jdoc)
    assert set(doc["trace_cache"]) == set(jdoc["trace_cache"])
    assert doc["fragments"]
    for frag in doc["fragments"]:
        assert set(frag) == set(JaxFragmentStats(0).to_json())
        assert set(frag["phases_ms"]) == set(jdoc["fragments"][0]["phases_ms"])
