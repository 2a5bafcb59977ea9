"""The port's telemetry against the JAX package's: the metrics registry and
its Prometheus text, the span tracer and its Chrome-trace export, the
runner's traces and completion statistics, EXPLAIN ANALYZE VERBOSE, and
the mesh profile (FragmentStats / MeshProfile) with its JSON schema.

The cases of tests/test_telemetry.py that touch the registry, spans, the
runner's traces, the mesh trace, events and the profile.  The unit cases
run once per package (`pkg`); the runner cases run the same statements
through the JAX LocalQueryRunner and the port's (`device="cpu"`) and hold
the span names, counts and rows equal; the mesh cases run the port's
4-worker mesh and hold its rows to the JAX local runner's.  Times are
never compared.
"""

import importlib
import json
import re
import threading

import pytest

PKGS = ("trino_tpu", "trino_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture(scope="module")
def runners():
    from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    return {
        "trino_tpu": JaxRunner(catalog="tpch", schema="tiny", target_splits=2),
        "trino_tpu_torch": LocalQueryRunner(
            catalog="tpch", schema="tiny", target_splits=2, device="cpu"
        ),
    }


@pytest.fixture(scope="module")
def dist():
    from trino_tpu_torch.parallel import DistributedQueryRunner

    return DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")


# -- metrics registry ---------------------------------------------------------


def test_counter_register_once_bump_everywhere(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    c1 = reg.counter("x_total", "help text")
    c2 = reg.counter("x_total")
    assert c1 is c2
    c1.inc()
    c2.inc(4)
    assert c1.value() == 5


def test_labeled_counter_and_prometheus_text(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    c = reg.counter("events_total", "events", labelnames=("kind",))
    c.labels("a").inc(2)
    c.labels(kind="b").inc()
    text = reg.render_prometheus()
    assert "# TYPE events_total counter" in text
    assert 'events_total{kind="a"} 2' in text
    assert 'events_total{kind="b"} 1' in text


def test_kind_mismatch_rejected(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    reg.counter("m")
    with pytest.raises(TypeError):
        reg.gauge("m")


def test_histogram_buckets_cumulative(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1.0"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    assert h.value() == 3


def test_callback_gauge_and_snapshot(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    reg.gauge_fn("live_things", "pull-style", lambda: 7)
    reg.counter("c_total").inc(3)
    snap = reg.snapshot()
    assert snap["live_things"] == 7
    assert snap["c_total"] == 3
    rows = dict((r[0], r[3]) for r in reg.rows())
    assert rows["live_things"] == 7.0


def test_same_operations_render_the_same_text():
    """One sequence of registrations and bumps renders identical
    Prometheus text in both packages."""
    texts = []
    for p in PKGS:
        reg = mod(p, "telemetry").MetricsRegistry()
        c = reg.counter("q_total", "queries", labelnames=("state", "type"))
        c.labels("FINISHED", "").inc(3)
        c.labels("FAILED", "USER_ERROR").inc()
        g = reg.gauge("queued", "queued", labelnames=("group",))
        g.labels("etl").set(2)
        h = reg.histogram("wall_seconds", "wall")
        for v in (0.002, 0.3, 7.0, 400.0):
            h.observe(v)
        reg.gauge_fn("pull", "pulled", lambda: {("a",): 1, ("b",): 2}, labelnames=("k",))
        texts.append((reg.render_prometheus(), reg.rows(), reg.snapshot()))
    assert texts[0] == texts[1]


def test_concurrent_scrape_vs_bump(pkg):
    reg = mod(pkg, "telemetry").MetricsRegistry()
    h = reg.histogram("x_seconds", "t")
    c = reg.counter("y_total", "t", labelnames=("k",))
    stop = False
    errs = []

    def scrape():
        while not stop:
            try:
                reg.render_prometheus()
                reg.snapshot()
            except Exception as e:  # pragma: no cover - the regression
                errs.append(e)
                break

    t = threading.Thread(target=scrape)
    t.start()
    try:
        for i in range(5000):
            h.observe(i * 0.001)
            c.labels(str(i % 499)).inc()
    finally:
        stop = True
        t.join()
    assert not errs
    assert c.labels("0").value() >= 1


def test_prometheus_text_shape(pkg):
    line_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")
    for line in mod(pkg, "telemetry").REGISTRY.render_prometheus().splitlines():
        if not line or line.startswith("#"):
            continue
        assert line_re.match(line), f"bad exposition line: {line!r}"


def test_engine_vocabulary_preregistered(pkg):
    text = mod(pkg, "telemetry").REGISTRY.render_prometheus()
    for label in ("exchange_elided", "join_capacity_sync", "host_restack"):
        assert f'counter="{label}"' in text
    assert "trino_tpu_trace_cache_hits_total" in text
    assert 'trino_tpu_buffer_pool_bytes{tier="device"}' in text


def test_engine_vocabulary_equals_jax():
    """Every metric of the JAX engine's vocabulary is registered in the
    port under the same name, kind and labels."""
    def vocab(p):
        reg = mod(p, "telemetry.metrics").MetricsRegistry()
        mod(p, "telemetry.metrics")._register_engine_metrics(reg)
        return {
            name: (m.kind, m.labelnames) for name, m in reg._metrics.items()
        }

    assert vocab("trino_tpu_torch") == vocab("trino_tpu")


# -- span tracer --------------------------------------------------------------


def test_span_nesting_and_chrome_export(pkg):
    tr = mod(pkg, "telemetry").SpanTracer(query_id="q_test")
    with tr.span("query", query_id="q_test"):
        with tr.span("analyze"):
            pass
        tr.record("launch", tr.t0, tr.t0 + 0.001, {"phase": "compute"})
    d = tr.root.to_dict()
    assert d["name"] == "query"
    assert [c["name"] for c in d["children"]] == ["analyze", "launch"]
    chrome = tr.to_chrome_trace()
    assert chrome["displayTimeUnit"] == "ms"
    assert [e["name"] for e in chrome["traceEvents"]] == ["query", "analyze", "launch"]
    for e in chrome["traceEvents"]:
        assert e["ph"] == "X" and "ts" in e and "dur" in e
    assert json.loads(json.dumps(chrome))["traceEvents"]


def test_span_error_attribution(pkg):
    tr = mod(pkg, "telemetry").SpanTracer()
    with pytest.raises(RuntimeError):
        with tr.span("query"):
            raise RuntimeError("boom")
    assert tr.root.attrs["error"] == "RuntimeError"
    assert tr.root.end_s is not None


def test_null_tracer_is_inert(pkg):
    NULL_TRACER = mod(pkg, "telemetry").NULL_TRACER
    assert NULL_TRACER.enabled is False
    with NULL_TRACER.span("anything", a=1) as sp:
        assert sp is None
    NULL_TRACER.record("x", 0.0, 1.0)
    assert NULL_TRACER.flat_spans() == []
    assert NULL_TRACER.to_chrome_trace()["traceEvents"] == []


# -- query instrumentation (local) -------------------------------------------


def test_local_query_trace_structure(runners):
    got = {}
    for p, r in runners.items():
        r.execute("select count(*) from nation")
        names = [e["name"] for e in r.last_trace["traceEvents"]]
        assert names[0] == "query"
        got[p] = names
    assert got["trino_tpu_torch"] == got["trino_tpu"]
    assert {"analyze", "optimize", "execute"} <= set(got["trino_tpu"])


def test_query_trace_off_is_zero_overhead(runners):
    for r in runners.values():
        r.execute("set session query_trace = false")
        before = r.last_trace
        try:
            r.execute("select count(*) from region")
            assert r.last_trace is before
        finally:
            r.execute("set session query_trace = true")


def test_completion_metrics_and_statistics(runners):
    spans = {}
    for p, r in runners.items():
        REGISTRY = mod(p, "telemetry").REGISTRY
        listener = mod(p, "runtime.events").CollectingEventListener()
        r.events.add(listener)
        c = REGISTRY.counter("trino_tpu_queries_total")
        before = c.value(("FINISHED", ""))
        r.execute("select count(*) from nation")
        r.events.listeners.remove(listener)
        assert c.value(("FINISHED", "")) == before + 1
        st = listener.completed[-1].statistics
        assert st.wall_s > 0 and st.rows == 1
        assert st.spans >= 4
        spans[p] = st.spans
        assert REGISTRY.histogram("trino_tpu_query_wall_seconds").value() > 0
    assert spans["trino_tpu_torch"] == spans["trino_tpu"]


def test_explain_analyze_verbose_exports_trace(runners):
    trees = {}
    for p, r in runners.items():
        res = r.execute("explain analyze verbose select count(*) from nation")
        text = [row[0] for row in res.rows]
        assert any(line.startswith("Query trace (spans") for line in text)
        json_lines = [line for line in text if line.startswith("Trace JSON: ")]
        assert len(json_lines) == 1
        chrome = json.loads(json_lines[0][len("Trace JSON: "):])
        trees[p] = [e["name"] for e in chrome["traceEvents"]]
    assert trees["trino_tpu_torch"] == trees["trino_tpu"]
    assert trees["trino_tpu"][0] == "query"


def test_explain_analyze_verbose_without_tracing(runners):
    texts = {}
    for p, r in runners.items():
        r.execute("set session query_trace = false")
        try:
            rows = r.execute("explain analyze verbose select count(*) from nation").rows
        finally:
            r.execute("set session query_trace = true")
        texts[p] = [row[0] for row in rows if "Trace" in row[0] or "trac" in row[0]]
    assert texts["trino_tpu_torch"] == texts["trino_tpu"]
    assert not any(t.startswith("Trace JSON") for t in texts["trino_tpu"])


def test_plain_explain_analyze_has_no_trace(runners):
    for r in runners.values():
        res = r.execute("explain analyze select count(*) from nation")
        assert not any("Trace JSON" in row[0] for row in res.rows)


# -- query instrumentation (the port's 4-worker mesh) ---------------------------


def test_mesh_trace_nests_query_fragment_launch(dist, runners):
    from trino_tpu_torch.runtime.query_stats import MESH_PHASES

    sql = "select count(*) from lineitem"
    dist.execute(sql)
    assert dist.execute(sql).rows == runners["trino_tpu"].execute(sql).rows
    trace = dist.last_trace
    assert any(e["name"] == "query" for e in trace["traceEvents"])
    qid = trace["otherData"]["query_id"]
    flat = None
    for q, s in dist.traces:
        if q == qid:
            flat = s
    assert flat
    by_id = {s["span_id"]: s for s in flat}
    roots = [s for s in flat if s["parent_id"] == 0]
    assert len(roots) == 1 and roots[0]["name"] == "query"
    names = {s["name"] for s in flat}
    # the mesh runner's own spans beside the local runner's
    assert {"analyze", "optimize", "fragment", "schedule"} <= names
    assert [s for s in flat if s["name"].startswith("fragment-")]
    launches = [s for s in flat if s["name"] == "launch"]
    assert launches
    for l in launches:
        cur = by_id[l["parent_id"]]
        seen = set()
        while cur["parent_id"] != 0 and cur["span_id"] not in seen:
            seen.add(cur["span_id"])
            cur = by_id[cur["parent_id"]]
        assert cur["name"] == "query" or cur["name"].startswith("fragment-")
        attrs = json.loads(l["attributes"])
        assert attrs["phase"] in MESH_PHASES
        assert "fragment" in attrs


def test_mesh_events_mirrored_to_registry(dist, runners):
    """Every count of the profile lands in trino_tpu_mesh_events_total: the
    registry's deltas over one mesh query equal the profile's counters."""
    from trino_tpu_torch.telemetry import REGISTRY

    c = REGISTRY.counter("trino_tpu_mesh_events_total")

    def series():
        return {lv[0]: v for _, lv, v in
                ((s[1], s[2], s[3]) for s in c.series())}

    before = series()
    sql = "select o_orderpriority, count(*) from orders group by 1"
    rows = dist.execute(sql).rows
    after = series()
    delta = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert delta == dist.last_mesh_profile.counters
    assert delta.get("host_gather", 0) + delta.get("result_gather", 0) > 0
    assert sorted(rows) == sorted(runners["trino_tpu"].execute(sql).rows)


def test_mesh_completed_event_counters(dist):
    """The mesh query's QueryStatistics carries the profile's counters,
    phase totals and step-cache counts."""
    from trino_tpu_torch.runtime.events import CollectingEventListener
    from trino_tpu_torch.runtime.query_stats import MESH_PHASES

    listener = CollectingEventListener()
    dist.events.add(listener)
    try:
        dist.execute("select count(*), sum(l_quantity) from lineitem where l_quantity < 30")
    finally:
        dist.events.listeners.remove(listener)
    st = listener.completed[-1].statistics
    prof = dist.last_mesh_profile
    assert st.counters == prof.counters and st.counters
    assert set(st.phase_totals_s) == set(MESH_PHASES)
    assert st.trace_cache == {
        "hits": prof.trace_hits, "misses": prof.trace_misses, "retraces": 0,
    }
    assert st.spans > 0


# -- MeshProfile / FragmentStats JSON contract --------------------------------------

FRAGMENT_JSON_KEYS = {
    "fragment", "kind", "wall_s", "phases_ms",
    "bytes_to_device", "bytes_to_host", "collective_bytes",
    "collective_bytes_by",
}


def test_fragment_stats_json_schema(pkg):
    QS = mod(pkg, "runtime.query_stats")
    st = QS.FragmentStats(3, kind="SOURCE")
    st.wall_s = 0.01
    st.phases["compute"] = 0.004
    st.close()
    doc = st.to_json()
    assert set(doc) == FRAGMENT_JSON_KEYS
    assert set(doc["phases_ms"]) == set(QS.MESH_PHASES)
    assert doc["fragment"] == 3 and doc["kind"] == "SOURCE"


def test_mesh_profile_json_schema(pkg):
    prof = mod(pkg, "runtime.query_stats").MeshProfile()
    prof.add_phase(0, "compute", 0.002)
    prof.fragment(0).wall_s = 0.003
    prof.bump("scan_cache_hit")
    prof.fragment(0).close()
    doc = prof.to_json()
    assert set(doc) == {"fragments", "trace_cache", "counters", "collective_bytes_by"}
    assert set(doc["trace_cache"]) == {"hits", "misses", "retraces"}
    assert doc["counters"]["scan_cache_hit"] == 1
    assert doc["fragments"][0]["phases_ms"]["compute"] == pytest.approx(2.0)


def test_profile_json_and_render_equal_jax():
    """The same profile operations give the same JSON and the same
    rendered lines in both packages."""
    out = []
    for p in PKGS:
        prof = mod(p, "runtime.query_stats").MeshProfile()
        prof.add_phase(0, "compute", 0.002)
        prof.add_phase(0, "transfer", 0.0005)
        prof.add_phase(1, "collective", 0.001)
        prof.fragment(0).wall_s = 0.004
        prof.fragment(1).wall_s = 0.002
        prof.fragment(1).kind = "FIXED_HASH[k]"
        prof.add_collective(1, 4096, "all_to_all", "repartition")
        prof.add_collective(0, 128, "gather", "host_gather")
        prof.bump("host_gather")
        for st in prof.fragments.values():
            st.close()
        out.append((prof.to_json(), prof.render(), prof.phase_totals()))
    assert out[0] == out[1]
    assert out[1][0]["fragments"][1]["collective_bytes"] == 4096


def test_phases_sum_to_wall_after_close(pkg):
    st = mod(pkg, "runtime.query_stats").FragmentStats(0)
    st.wall_s = 0.010
    st.phases["compute"] = 0.004
    st.phases["transfer"] = 0.001
    st.close()
    assert sum(st.phases.values()) == pytest.approx(st.wall_s, abs=1e-12)
    assert st.phases["other"] == pytest.approx(0.005, abs=1e-12)


def test_phases_sum_to_wall_on_real_mesh_profile(dist, runners):
    sql = "select count(*), sum(l_quantity) from lineitem where l_quantity < 30"
    dist.execute(sql)
    rows = dist.execute(sql).rows
    assert rows == runners["trino_tpu"].execute(sql).rows
    prof = dist.last_mesh_profile
    assert prof.fragments
    for fid, st in prof.fragments.items():
        assert st.phases["other"] >= 0.0
        assert sum(st.phases.values()) == pytest.approx(st.wall_s, abs=1e-4), fid
        assert st.phases["compute"] >= 0.0
    assert sum(st.phases["compute"] for st in prof.fragments.values()) > 0


def test_mesh_fragment_kinds_equal_jax_fragments(dist):
    """The profile's fragment ids and kinds are the JAX mesh's fragments of
    the same statement (fragmenting costs no JAX compile)."""
    from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    jm = JaxMesh(catalog="tpch", schema="tiny", n_workers=4)
    sql = QUERIES[3]
    dist.execute(sql)
    sub = jm.create_subplan(jm.create_plan(sql))
    expected = {f.id: str(f.partitioning) for f in sub.all_fragments()}
    got = {fid: st.kind for fid, st in dist.last_mesh_profile.fragments.items()}
    assert got == expected


def test_phase_totals_rollup(pkg):
    prof = mod(pkg, "runtime.query_stats").MeshProfile()
    prof.add_phase(0, "compute", 0.002)
    prof.add_phase(1, "compute", 0.003)
    prof.add_phase(1, "transfer", 0.001)
    totals = prof.phase_totals()
    assert totals["compute"] == pytest.approx(0.005)
    assert totals["transfer"] == pytest.approx(0.001)
