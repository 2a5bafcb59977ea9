#!/usr/bin/env python3
"""Time the port's warm statements against the same statements of an
earlier tree, on one NVIDIA card, to read what the statement frame costs.

    git archive <commit> | tar -x -C build/parent    # build/ is gitignored
    python3 tools/torch_statement_overhead.py --parent build/parent [--runs N]

Two statements at tpch.sf1, each warm: Q1-double (chip_smoke.py's, with
`pallas_agg` on) through LocalQueryRunner, and TPC-H Q3 (with
`pallas_probe` on) through the 4-worker DistributedQueryRunner.  Each tree
runs in its own process, in turns: parent, this tree, this tree, parent.
This tree also runs once more with `query_trace = false`, the part of the
frame a session can turn off.  Each process builds its tree's kernels,
runs each statement cold once, then `--runs` warm, and reports the median
and the least warm wall (rows come back to the host, so a wall includes
every launch).

Prints the card's name and power limit and, last, one JSON line with
every time.  Needs a card; exits non-zero without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_tree(tree: str, runs: int, trace: bool) -> dict:
    """The child process: time the two statements of `tree`'s package."""
    sys.path.insert(0, tree)
    import torch

    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    sys.path.insert(0, str(ROOT))
    from chip_smoke import MESH_WORKERS, Q1_DOUBLE

    if not torch.cuda.is_available():
        raise SystemExit("torch_statement_overhead: CUDA is not available")
    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    local.execute("set session pallas_agg = true")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    mesh.execute("set session pallas_probe = true")
    if not trace:
        local.execute("set session query_trace = false")
        mesh.execute("set session query_trace = false")
    out = {}
    for name, runner, sql in (("q1_double_local", local, Q1_DOUBLE),
                              ("q3_mesh", mesh, QUERIES[3])):
        t0 = time.perf_counter()
        runner.execute(sql)
        cold = time.perf_counter() - t0
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            runner.execute(sql)
            walls.append(time.perf_counter() - t0)
        out[name] = {"cold_s": cold, "warm_median_s": statistics.median(walls),
                     "warm_min_s": min(walls), "runs": runs}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "TRACE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        tree, trace = args.child
        print(json.dumps(one_tree(tree, args.runs, trace == "on")), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_statement_overhead: CUDA is not available")
    parent = str(Path(args.parent).resolve())
    order = [("parent", parent, "on"), ("change", str(ROOT), "on"),
             ("change", str(ROOT), "on"), ("parent", parent, "on"),
             ("change_trace_off", str(ROOT), "off")]
    results = []
    for label, tree, trace in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", parent,
             "--runs", str(args.runs), "--child", tree, trace],
            capture_output=True, text=True, cwd=tree,
            env={**os.environ, "PYTHONHASHSEED": "0"},
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{label}: exit {proc.returncode}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label}: {json.dumps(times)}", flush=True)
        results.append({"tree": label, **times})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"statement_overhead": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
