"""Interactive SQL terminal (reference: client/trino-cli — cli/Trino.java:40,
Console.java).  Runs in-process by default (LocalQueryRunner), or against a
coordinator with --server (the protocol client).

Usage:
  python -m trino_tpu_torch.cli [--catalog tpch] [--schema tiny] [--device cpu]
  python -m trino_tpu_torch.cli --server http://host:8080
  python -m trino_tpu_torch.cli --execute "select 1"

Port of trino_tpu/cli.py: a copy, with a `--device` option for the
in-process runner.  It defaults to the CUDA card, and the CLI raises where
there is none unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def format_table(names, rows, max_rows: int = 200) -> str:
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in rows[:max_rows]]
    widths = [len(n) for n in names]
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(names, widths)), sep]
    for r in cells:
        out.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    if len(rows) > max_rows:
        out.append(f"... ({len(rows)} rows total)")
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


class _LocalBackend:
    def __init__(self, catalog: str, schema: str, device=None):
        from trino_tpu_torch.runtime.runner import LocalQueryRunner

        self.runner = LocalQueryRunner(catalog=catalog, schema=schema, device=device)

    def execute(self, sql: str):
        res = self.runner.execute(sql)
        return res.column_names, res.rows


class _RemoteBackend:
    def __init__(self, url: str):
        from trino_tpu_torch.client import Client

        self.client = Client(url)

    def execute(self, sql: str):
        return self.client.execute(sql)


def run_statement(backend, sql: str) -> int:
    t0 = time.perf_counter()
    try:
        names, rows = backend.execute(sql)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(format_table(names, rows))
    print(f"[{time.perf_counter() - t0:.2f}s]")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu")
    ap.add_argument("--server", help="coordinator URL (default: in-process)")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--execute", "-e", help="run one statement and exit")
    ap.add_argument(
        "--device", default=None,
        help="device of the in-process runner (default: the CUDA card)",
    )
    args = ap.parse_args(argv)

    backend = (
        _RemoteBackend(args.server)
        if args.server
        else _LocalBackend(args.catalog, args.schema, args.device)
    )
    if args.execute:
        return run_statement(backend, args.execute)

    print("trino-tpu CLI — end with ';', quit/exit to leave")
    buf: list[str] = []
    while True:
        try:
            line = input("tpu:> " if not buf else "  ..> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not buf and line.strip().lower() in ("quit", "exit"):
            return 0
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            if sql.strip():
                run_statement(backend, sql)


if __name__ == "__main__":
    raise SystemExit(main())
