#!/usr/bin/env python3
"""TPC-DS q72 at tpcds.sf1 under a memory budget, on the card and on the CPU.

    python3 tools/q72_budget_probe.py [--budget BYTES] [--waves 64]
                                      [--cpu-timeout SECONDS] [--out PATH]

q72's plan joins catalog_sales to inventory on the item key before any
filter: about 940 M rows at sf1.  This probe runs it through the port's
LocalQueryRunner on the card under `query_max_memory` = BUDGET with
`memory_wave_partitions` = WAVES (the inventory build, ~0.9 GB of reserved
bytes, exceeds the default 256 MiB budget and runs in WAVES hash-partition
waves, spilled to disk), and logs the wall, the waves and spill bytes, the
peak device memory above the starting allocation and the rows.  Then the
port's CPU LocalQueryRunner runs the same query under the same settings in
a child process limited to CPU_TIMEOUT seconds; when it finishes, the two
results are compared (ORDER BY keys in order, ties as a multiset:
trino_tpu_torch/testing.py).  The last line is one JSON object with every
reading; with --out it is also written to PATH.  Needs one card.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def run_q72(device: str, budget: int, waves: int):
    """(rows, wall seconds, pressure counters added, result order)."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.telemetry import metrics
    from trino_tpu_torch.testing import result_order

    def pressure():
        out = {op: metrics.memory_waves_counter().value((op,))
               for op in ("join", "aggregation", "window", "sort")}
        out["spill_bytes"] = metrics.spill_bytes_counter().value()
        return out

    r = LocalQueryRunner(catalog="tpcds", schema="sf1", device=device)
    r.properties.set("query_max_memory", budget)
    r.properties.set("memory_wave_partitions", waves)
    order = result_order(r.create_plan(QUERIES[72]))
    before = pressure()
    t0 = time.perf_counter()
    rows = r.execute(QUERIES[72]).rows
    wall = time.perf_counter() - t0
    return rows, wall, {k: v - before[k] for k, v in pressure().items()}, order


def cpu_child(path: str, budget: int, waves: int) -> int:
    rows, wall, delta, _ = run_q72("cpu", budget, waves)
    with open(path, "wb") as f:
        pickle.dump((rows, wall, delta), f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=256 << 20)
    ap.add_argument("--waves", type=int, default=64)
    ap.add_argument("--cpu-timeout", type=float, default=1800.0)
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    ap.add_argument("--cpu-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_child:
        return cpu_child(args.cpu_child, args.budget, args.waves)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("q72_budget_probe: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    out = {"card": smi, "budget_bytes": args.budget, "waves": args.waves}
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows, wall, delta, order = run_q72("cuda", args.budget, args.waves)
    out.update(card_wall_s=wall, card_pressure=delta, rows=len(rows),
               card_peak_above_start_bytes=torch.cuda.max_memory_allocated() - start)
    print(f"q72 sf1 card: {json.dumps(out)}", flush=True)

    path = os.path.join(tempfile.mkdtemp(prefix="q72_probe_"), "cpu.pkl")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--budget", str(args.budget),
         "--waves", str(args.waves), "--cpu-child", path],
    )
    try:
        rc = child.wait(timeout=args.cpu_timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        rc = None
    out["cpu_elapsed_s"] = time.perf_counter() - t0
    if rc == 0:
        from trino_tpu_torch.testing import assert_rows_match

        with open(path, "rb") as f:
            cpu_rows, cpu_wall, cpu_delta = pickle.load(f)
        out.update(cpu_wall_s=cpu_wall, cpu_pressure=cpu_delta)
        assert_rows_match(rows, cpu_rows, order, float_rtol=1e-9)
        out["matches_cpu"] = True
    else:
        out["cpu_exit"] = "timeout" if rc is None else rc
        out["matches_cpu"] = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
