"""Web UI: cluster overview + query list served by the coordinator.

Reference role: core/trino-main webapp (the /ui React app) + ClusterStatsResource
/ QueryResource JSON endpoints.  A single self-contained HTML page (no build
step, no external assets) polls the JSON endpoints the same way the
reference's UI polls /ui/api/stats and /ui/api/query.

Port of trino_tpu/server/ui.py: a copy; the stats read the port's buffer
pool (runtime/buffer_pool.POOL) and step cache (parallel/spmd.TRACE_CACHE).
"""

from __future__ import annotations

import json
import time


def handle_ui_get(server, path: str):
    """Route /ui requests.  Returns (status, content_type, body-bytes) or
    None when the path is not a UI path."""
    if path in ("/ui", "/ui/"):
        return 200, "text/html; charset=utf-8", _PAGE.encode()
    if path == "/ui/api/stats":
        return 200, "application/json", json.dumps(_stats(server)).encode()
    if path == "/ui/api/query":
        return 200, "application/json", json.dumps(_queries(server)).encode()
    if path.startswith("/ui/api/query/"):
        qid = path.rsplit("/", 1)[-1]
        q = server.query(qid)
        if q is None:
            return 404, "application/json", b'{"error": "no such query"}'
        return 200, "application/json", json.dumps(_query(q, full=True)).encode()
    if path.startswith("/ui"):
        return 404, "text/plain", b"not found"
    return None


def _stats(server) -> dict:
    queries = list(server._queries.values())
    states = {}
    for q in queries:
        states[q.state] = states.get(q.state, 0) + 1
    pool = {}
    try:
        from trino_tpu_torch.runtime.buffer_pool import POOL

        pool = POOL.stats()
    except Exception:
        pass
    trace_cache = {}
    try:
        from trino_tpu_torch.parallel.spmd import TRACE_CACHE

        trace_cache = TRACE_CACHE.stats()
    except Exception:
        pass
    workers = []
    fd = getattr(getattr(server, "runner", None), "failure_detector", None)
    if fd is not None:
        workers = fd.active_workers()
    return {
        "uptime_s": round(time.monotonic() - server.started_at, 1),
        "totalQueries": len(queries),
        "queryStates": states,
        "runningQueries": states.get("RUNNING", 0),
        "queuedQueries": states.get("QUEUED", 0),
        "finishedQueries": states.get("FINISHED", 0),
        "failedQueries": states.get("FAILED", 0),
        "activeWorkers": workers or ["local"],
        "bufferPool": pool,
        # compiled-SPMD-program cache health (retraces must stay 0 warm);
        # the full registry is the Prometheus text at /v1/metrics
        "traceCache": trace_cache,
        "metricsUri": "/v1/metrics",
    }


def _queries(server) -> list:
    return [
        _query(q)
        for q in sorted(
            server._queries.values(), key=lambda q: q.id, reverse=True
        )
    ]


def _query(q, full: bool = False) -> dict:
    doc = {
        "queryId": q.id,
        "state": q.state,
        "query": q.sql if full else q.sql[:200],
    }
    if q.error is not None:
        doc["errorName"] = q.error.get("errorName")
        if full:
            doc["error"] = q.error
    if full and q.result is not None:
        doc["columns"] = q.columns_json()
        doc["rowCount"] = len(q.result.rows)
    return doc


_PAGE = """<!DOCTYPE html>
<html><head><title>trino_tpu</title>
<style>
 body { font-family: monospace; margin: 2em; background: #111; color: #eee; }
 h1 { color: #7fd4ff; } table { border-collapse: collapse; width: 100%; }
 td, th { border: 1px solid #444; padding: 4px 8px; text-align: left; }
 th { background: #222; } .FINISHED { color: #8f8; } .FAILED { color: #f88; }
 .RUNNING { color: #ff8; } .QUEUED { color: #88f; }
 #stats span { margin-right: 2em; }
</style></head>
<body>
<h1>trino_tpu coordinator</h1>
<div id="stats">loading…</div>
<h2>queries</h2>
<table id="queries"><tr><th>id</th><th>state</th><th>sql</th></tr></table>
<script>
async function refresh() {
  const s = await (await fetch('/ui/api/stats')).json();
  document.getElementById('stats').innerHTML =
    `<span>uptime ${s.uptime_s}s</span>` +
    `<span>workers ${s.activeWorkers.length}</span>` +
    `<span>running ${s.runningQueries}</span>` +
    `<span>queued ${s.queuedQueries}</span>` +
    `<span>finished ${s.finishedQueries}</span>` +
    `<span>failed ${s.failedQueries}</span>` +
    `<span>retraces ${(s.traceCache || {}).retraces ?? '-'}</span>` +
    `<span><a href="/v1/metrics" style="color:#7fd4ff">metrics</a></span>`;
  const qs = await (await fetch('/ui/api/query')).json();
  const t = document.getElementById('queries');
  t.innerHTML = '<tr><th>id</th><th>state</th><th>sql</th></tr>' +
    qs.map(q => `<tr><td>${q.queryId}</td>` +
      `<td class="${q.state}">${q.state}</td>` +
      `<td>${q.query.replace(/</g, '&lt;')}</td></tr>`).join('');
}
refresh(); setInterval(refresh, 2000);
</script>
</body></html>
"""
