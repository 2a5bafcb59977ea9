"""Concurrent-serving bench probe (the `serve` section that
tools/compare_bench.py's `check_serve` and `check_chaos` gate).

The serving contract under measurement: K concurrent clients replaying a
TPC-H mix through the dispatcher (runtime/dispatcher) must

  * all answer the serial oracle's rows (or be counted as errors — the
    gate fails on any),
  * record latency percentiles and queries/sec (the `serve` headline),
  * and, on the MESH path, compile NOTHING once warm: the whole mix is
    traced by one serial warm-up pass, and concurrent serving afterwards
    shares that one trace-cache key set — `warm_compile_events == 0` is
    the shared-trace-cache contract (near-zero marginal compile cost per
    added client), asserted through the compile observatory.

A final `chaos` phase (gated by `check_chaos`) turns fault_tolerant
execution on, kills a worker mid-Q18 while the mix serves concurrently,
and asserts the recovery contract: the killed statement completes from
spooled intermediates with only the lost stage re-run, and zero
mesh-shrink re-plans.

In the port a compile event is a step-cache build or a kernel build or
load (telemetry/compile_events), so `warm_compile_events == 0` says that
warm concurrent serving built no step and loaded no kernel.  The
counters, the observatory's watermark and FAILURE_INJECTOR are process
wide: run the probe in a process of its own (chip_smoke.py's phase 5u
runs it in a child process).

Run standalone (prints one JSON line; on the card unless told otherwise):

    python -m trino_tpu_torch.bench_serve [--device cpu]

with BENCH_SERVE_SCHEMA (tiny), BENCH_SERVE_CLIENTS (8) and
BENCH_SERVE_ROUNDS (3) as in the JAX package.
"""

from __future__ import annotations

import threading
import time


#: the TPC-H mix concurrent clients replay (aggregation, scan-filter,
#: join — the three fragment shapes a dashboard workload cycles through)
MIX_QUERIES = (1, 6, 3)


def _percentile(walls: list, p: float):
    if not walls:
        return None
    i = min(len(walls) - 1, int(p * len(walls)))
    return round(walls[i], 4)


def _serve_once(dispatcher, mix: list, oracle: dict,
                clients: int, rounds: int) -> dict:
    """Drive K client threads through the dispatcher; returns the stats
    block (walls, qps, correctness, shed/queue counters)."""
    from trino_tpu_torch.runtime.dispatcher import QueryShedError

    walls: list = []
    errors: list = []
    mismatches = [0]
    shed = [0]
    lock = threading.Lock()

    def client(i: int) -> None:
        for j in range(rounds):
            sql = mix[(i + j) % len(mix)]
            t0 = time.perf_counter()
            try:
                ticket = dispatcher.enqueue()
                ticket.wait()
                res = dispatcher.run_admitted(
                    ticket, lambda r: r.execute(sql)
                )
            except QueryShedError:
                with lock:
                    shed[0] += 1
                continue
            except Exception as e:  # classified failures fail the gate
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])
                continue
            wall = time.perf_counter() - t0
            ok = sorted(map(str, res.rows)) == oracle[sql]
            with lock:
                walls.append(wall)
                if not ok:
                    mismatches[0] += 1

    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(i,), daemon=True,
                         name=f"serve-client-{i}")
        for i in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t_start
    hung = sum(1 for t in threads if t.is_alive())
    walls.sort()
    groups = {s["name"]: s for s in dispatcher.stats()}
    return {
        "clients": clients,
        "rounds": rounds,
        "lanes": dispatcher.lanes,
        "queries_total": len(walls),
        "qps": round(len(walls) / max(elapsed, 1e-9), 3),
        "wall_s": round(elapsed, 4),
        "p50_s": _percentile(walls, 0.50),
        "p95_s": _percentile(walls, 0.95),
        "p99_s": _percentile(walls, 0.99),
        "shed_total": shed[0],
        "queued_total": groups.get("global", {}).get(
            "dispatcher_queued_total", 0
        ),
        "errors": errors[:5],
        "rows_match": (
            hung == 0
            and mismatches[0] == 0
            and not errors
            and len(walls) + shed[0] == clients * rounds
        ),
    }


def _mix_and_oracle(runner) -> tuple:
    from trino_tpu_torch.connectors.tpch.queries import QUERIES

    mix = [QUERIES[q] for q in MIX_QUERIES]
    oracle = {
        sql: sorted(map(str, runner.execute(sql).rows)) for sql in mix
    }
    return mix, oracle


def _recovery_metrics() -> dict:
    """Point-in-time recovery counter values (chaos evidence is the
    before/after delta): task retries by outcome, spooled fragments,
    spool rehydration reads, and mesh-shrink full re-plans."""
    from trino_tpu_torch.telemetry.metrics import (
        TASK_RETRY_OUTCOMES,
        membership_events_counter,
        mesh_events_counter,
        spooled_fragments_counter,
        task_retries_counter,
    )

    retries = task_retries_counter()
    return {
        "task_retries": {
            o: retries.labels(o).value() for o in TASK_RETRY_OUTCOMES
        },
        "spooled_fragments": spooled_fragments_counter().value(),
        "spool_hits": mesh_events_counter().labels("spool_read").value(),
        "full_replans": membership_events_counter().labels(
            "shrink_replan"
        ).value(),
    }


def _run_chaos(dist, dm, mix: list, oracle: dict, clients: int,
               rounds: int, p99_mesh) -> dict:
    """The `serve.chaos` section: kill a worker mid-Q18 while K clients
    serve the mix concurrently, with fault_tolerant_execution on.  The
    recovery contract under measurement: the killed statement completes
    from spooled intermediates (spool_hits delta > 0), only the lost
    stage re-runs (task_retries.retry >= 1), and the mesh is never
    re-planned for a retryable kill (full_replans delta == 0)."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR, InjectedFailure

    q18 = QUERIES[18]
    dist.properties.set("fault_tolerant_execution", True)
    try:
        # serial oracle + warm-up at the spooled-execution keys
        oracle = dict(oracle)
        oracle[q18] = sorted(map(str, dist.execute(q18).rows))
        mix = [q18] + list(mix)  # client 0 opens with Q18
        base = _recovery_metrics()

        fired = [0]
        orig_fail = FAILURE_INJECTOR.maybe_fail

        def chaos_kill(point: str) -> None:
            # one worker "death" mid-Q18: fires in client 0's FIRST
            # statement (Q18), at the finish hook of a stage whose
            # children already completed and spooled — the retry must
            # resume from those spooled outputs, never re-plan
            if (
                not fired[0]
                and point.startswith("stage:")
                and point.endswith(":finish")
                and not point.startswith("stage:0:")
                and threading.current_thread().name == "serve-client-0"
            ):
                fired[0] += 1
                raise InjectedFailure(f"chaos: worker killed at {point}")
            return orig_fail(point)

        FAILURE_INJECTOR.maybe_fail = chaos_kill
        try:
            chaos = _serve_once(dm, mix, oracle, clients, rounds)
        finally:
            FAILURE_INJECTOR.maybe_fail = orig_fail
        after = _recovery_metrics()
    finally:
        dist.properties.set("fault_tolerant_execution", False)
    chaos["query"] = "Q18"
    chaos["injected_kills"] = fired[0]
    chaos["task_retries"] = {
        o: after["task_retries"][o] - base["task_retries"][o]
        for o in after["task_retries"]
    }
    for key in ("spooled_fragments", "spool_hits", "full_replans"):
        chaos[key] = after[key] - base[key]
    chaos["p99_degradation_ratio"] = (
        round(chaos["p99_s"] / p99_mesh, 3)
        if chaos.get("p99_s") and p99_mesh else None
    )
    return chaos


def run_serve(schema: str = "tiny", clients: int = 8, rounds: int = 3,
              lanes: int = 4, device=None) -> dict:
    """The `serve` section: a local concurrent phase (host planning /
    serialization overlap across engine lanes) and a mesh phase (one
    execution lane over the 8-worker mesh on the card, concurrent
    admission, zero-compile warm serving asserted through the
    observatory).  `device` None is the card (raises without CUDA)."""
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.runtime.dispatcher import QueryDispatcher
    from trino_tpu_torch.runtime.resource_groups import (
        ResourceGroupConfig,
        ResourceGroupManager,
    )
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    out: dict = {"schema": schema}

    # -- local lanes phase ----------------------------------------------------
    local = LocalQueryRunner(catalog="tpch", schema=schema, target_splits=8,
                             device=device)
    # profile archive riding the serve bench: every concurrently served
    # statement's artifact lands in the store (lanes share it through
    # clone_for_dispatch), and the section records the artifact refs —
    # serving perf is diffable (tools/profile_diff) run-over-run
    import tempfile

    from trino_tpu_torch.telemetry.profile_store import (
        ProfileStore,
        attach_profile_store,
    )

    import os as _os

    archive_dir = _os.environ.get("BENCH_PROFILE_DIR") or _os.path.join(
        tempfile.gettempdir(), "trino_tpu_torch_profile_archive", "serve"
    )
    store = attach_profile_store(
        local, ProfileStore(archive_dir=archive_dir)
    )
    mix, oracle = _mix_and_oracle(local)  # serial warm-up + oracle
    mgr = ResourceGroupManager(
        ResourceGroupConfig(
            "global", hard_concurrency=lanes,
            max_queued=max(16, 2 * clients),
        )
    )
    d = QueryDispatcher(local, mgr, lanes=lanes)
    out["local"] = _serve_once(d, mix, oracle, clients, rounds)
    out["profile_artifacts"] = {
        "archive_dir": archive_dir,
        # a failed flush is recorded: refs to files that never landed
        # must not read as a usable diff baseline
        "flushed": store.flush(),
        "count": len(store.refs()),
        "recent": [
            {k: r[k] for k in ("key", "query_id", "sql_hash")}
            for r in store.refs()[-len(mix):]
        ],
    }

    # -- mesh phase (shared trace cache => zero warm compile events) -----------
    dist = DistributedQueryRunner(n_workers=8, schema=schema, device=device)
    mix, oracle = _mix_and_oracle(dist)  # traces every key the mix needs
    # settle speculative-join capacity learning before the watermark: a
    # capacity-learning statement legitimately compiles its fused expand
    # once more on its NEXT run (Q3's key set closes on run 2)
    from trino_tpu_torch.runtime.prewarm import replay_statements

    replay_statements(dist, mix)
    watermark = OBSERVATORY.mark()
    mgr_m = ResourceGroupManager(
        ResourceGroupConfig(
            "global", hard_concurrency=1, max_queued=max(16, 2 * clients)
        )
    )
    dm = QueryDispatcher(dist, mgr_m, lanes=1)  # mesh runner: one lane
    mesh = _serve_once(dm, mix, oracle, clients, rounds)
    mesh["warm_compile_events"] = OBSERVATORY.mark() - watermark
    out["mesh"] = mesh

    # -- chaos phase (task-level fault tolerance under serve load) -------------
    out["chaos"] = _run_chaos(
        dist, dm, mix, oracle, clients, rounds, mesh.get("p99_s")
    )
    return out


def main() -> None:
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(prog="python -m trino_tpu_torch.bench_serve")
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the card)")
    args = ap.parse_args()
    schema = os.environ.get("BENCH_SERVE_SCHEMA", "tiny")
    clients = int(os.environ.get("BENCH_SERVE_CLIENTS", 8))
    rounds = int(os.environ.get("BENCH_SERVE_ROUNDS", 3))
    print(json.dumps(run_serve(schema=schema, clients=clients, rounds=rounds,
                               device=args.device)), flush=True)


if __name__ == "__main__":
    main()
