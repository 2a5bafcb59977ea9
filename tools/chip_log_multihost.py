#!/usr/bin/env python3
"""Tabulate phase 5p (the multi-host worker tier) of a saved chip_smoke.py log.

    python3 tools/chip_log_multihost.py saved_chip_smoke.log

One row per P1 run (query, cold or warm): the wall, the bytes the stages'
tasks serialized and the bytes pulled over HTTP (by the consuming tasks and
the coordinator), the host seconds of the outputs' copies off the card, of
bucketing, of encoding and of decoding (each summed over every worker and
the coordinator, so they can exceed the wall), the serde share (encode +
decode over the wall), the tasks per worker, the replacement tasks and the
breaker trips.  Then the P2-P4 lines as they were logged.
"""

import ast
import json
import re
import sys

P1 = re.compile(
    r"^multihost P1 (\w+) (cold|warm): wall_s=([0-9.e-]+) rows=(\d+) grouped_sums=(\d+) "
    r"(?:replaced_tasks=(\d+) )?tasks_per_worker=(\{.*?\}) stages=(\{.*\})$"
)
TRIPS = re.compile(r"^multihost P1_(cold|warm) (\w+): breaker trips (\d+)")


def main(path: str) -> int:
    rows = []
    other = []
    trips: dict = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            t = TRIPS.match(line)
            if t:
                trips[(t.group(2), t.group(1))] = t.group(3)
            m = P1.match(line)
            if m:
                name, attempt, wall, nrows, k1, replaced, tpw, stages = m.groups()
                st = json.loads(stages)
                tot = {k: sum(s[k] for s in st.values())
                       for k in ("serialized_bytes", "pulled_bytes", "d2h_s",
                                 "partition_s", "encode_s", "decode_s")}
                wall = float(wall)
                rows.append((name, attempt, wall, int(k1), replaced or "not logged", tot,
                             sorted(ast.literal_eval(tpw).values()), len(st)))
            elif line.startswith(("multihost P2", "multihost P3", "multihost P4",
                                  "multihost path", "phase seconds")):
                other.append(line[:400])
    print("| Query | Run | Wall s | Stages | Serialized B | Pulled B | Off-card s | "
          "Bucketing s | Encode s | Decode s | Serde share | K1 | Tasks per worker | Replaced | "
          "Breaker trips |")
    print("| --- " * 15 + "|")
    for name, attempt, wall, k1, replaced, tot, tpw, nst in rows:
        share = (tot["encode_s"] + tot["decode_s"]) / wall if wall else 0.0
        print(f"| {name} | {attempt} | {wall!r} | {nst} | {tot['serialized_bytes']} | "
              f"{tot['pulled_bytes']} | {tot['d2h_s']:.4g} | {tot['partition_s']:.4g} | "
              f"{tot['encode_s']:.4g} | {tot['decode_s']:.4g} | {share:.3f} | {k1} | {tpw} | "
              f"{replaced} | {trips.get((name, attempt), 'not logged')} |")
    print()
    for line in other:
        print(line)
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
