#!/usr/bin/env python3
"""Tabulate phases 5d and 5e (TPC-DS without and with windows) of a
`chip_smoke.py` log.

    python3 chip_smoke.py > smoke.log
    python3 tools/chip_log_tpcds.py smoke.log [--per-line 2] [--phase 5d|5e]

Prints a markdown table with, per query: the warm and cold walls of the
local and the 4-worker mesh runs (seconds, as the log has them), the peak
device memory of the warm runs (GB: bytes / 1e9), the sorted-probe
launches of a mesh run and the row count; then the sums of the walls, the
slowest queries and the largest peak memory.
"""

import argparse
import re
from collections import defaultdict

RUN = re.compile(
    r"^tpcds q(\d+)_(local|mesh) (cold|warm) \((\w+)\): wall_s=([\d.e-]+) "
    r"locate_sorted_launches=(\d+) .*?max_memory_allocated=(\d+) .*rows=(\d+)"
)


#: the windowed TPC-DS queries (phase 5e's; q51 raises and has no runs)
WINDOW_QIDS = frozenset({12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98})


def parse(path: str) -> dict:
    runs = defaultdict(dict)
    with open(path) as f:
        for line in f:
            m = RUN.match(line)
            if m:
                q, where, attempt, schema, wall, k2, mem, rows = m.groups()
                runs[int(q)][where, attempt] = (float(wall), int(k2), int(mem), int(rows), schema)
    return runs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--per-line", type=int, default=2)
    ap.add_argument("--phase", choices=("5d", "5e"), help="one phase's queries only")
    args = ap.parse_args()
    runs = parse(args.log)
    if args.phase:
        runs = {q: r for q, r in runs.items() if (q in WINDOW_QIDS) == (args.phase == "5e")}
    cells = []
    for q in sorted(runs):
        r = runs[q]
        lw, lc = r["local", "warm"], r["local", "cold"]
        mw, mc = r["mesh", "warm"], r["mesh", "cold"]
        name = f"q{q}" + ("" if lw[4] == "sf1" else f" ({lw[4]})")
        cells.append(
            f"{name} | {lw[0]!r} / {lc[0]!r} | {mw[0]!r} / {mc[0]!r} | "
            f"{lw[2] / 1e9!r} / {mw[2] / 1e9!r} | {mw[1]} | {lw[3]}"
        )
    head = "Query | Local warm / cold s | Mesh warm / cold s | Peak GB local / mesh | K2 a mesh run | Rows"
    n = args.per_line
    print("| " + " | ".join([head] * n) + " |")
    print("|" + " --- |" * (6 * n))
    for i in range(0, len(cells), n):
        row = cells[i:i + n] + [" | | | | | "] * (n - len(cells[i:i + n]))
        print("| " + " | ".join(row) + " |")
    for where in ("local", "mesh"):
        warm = {q: runs[q][where, "warm"][0] for q in runs}
        slow = sorted(warm, key=warm.get, reverse=True)[:5]
        print(
            f"\n{where}: {len(warm)} queries, warm walls sum {sum(warm.values())!r} s, "
            f"cold walls sum {sum(runs[q][where, 'cold'][0] for q in runs)!r} s; "
            f"slowest warm: " + ", ".join(f"q{q} {warm[q]!r} s" for q in slow)
        )
        peak = max(runs, key=lambda q: runs[q][where, "warm"][2])
        print(f"{where}: largest warm peak memory q{peak} "
              f"{runs[peak][where, 'warm'][2] / 1e9!r} GB")


if __name__ == "__main__":
    main()
