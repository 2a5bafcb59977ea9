#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trino_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (it
catches nothing and never falls back to the CPU):

  1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
  2. build every kernel of the path from trino_tpu_torch/csrc with nvcc
     (one process per source, started together), with the build seconds and
     ptxas's register/shared-memory report, and fail on any register spill;
  3. hold the grouped-sums kernel to its plain PyTorch version on the card,
     at the main path's shape and at the edges (ragged and sub-tile row
     counts, rows whose bytes are not a multiple of 16, unaligned inputs),
     and time kernel (back to back, and per launch with the L2 flushed),
     plain version, a PyTorch library yardstick and the memory bound;
  4. the single-device aggregation path: TPC-H Q1, Q6 and Q1-over-DOUBLE
     (with `pallas_agg` on, the grouped-sums kernel's path) at sf1 through
     LocalQueryRunner on the card, cold and warm, with wall time, lineitem
     rows/s, kernel launches and peak device memory, then one profiled warm
     run each (planning time, device busy share, the top ops by device
     time); every result is checked against the port's own CPU run
     (device="cpu") of the same query;
  5. the join and mesh path: TPC-H Q3 at sf1 on a DistributedQueryRunner of
     4 logical workers on the card with `pallas_probe` on and with default
     knobs (both run the sorted-probe kernel on the card, and each run must
     launch it), and through LocalQueryRunner on the card, each cold and
     warm, with the same readings as phase 4 and the sorted-probe kernel's
     launches; every result is checked against the port's CPU
     LocalQueryRunner at sf1;
 5b. the semi-join, cross-join and conditional-form path: TPC-H Q4, Q11,
     Q12, Q18, Q19 and Q21 at sf1 through LocalQueryRunner on the card, and
     Q4, Q18, Q21 and Q11 (its cross join in the coordinator's local
     engine) on the 4-worker mesh with default knobs, each cold and warm,
     with the readings of phase 5; every mesh run of a semi-join query must
     launch the sorted-probe kernel from a semi join; one profiled warm run
     each of the mesh Q18 and Q21; each launch's P, n_match and window S;
     every result is checked against the port's CPU LocalQueryRunner at sf1
     (the CPU reference's time printed);
  5c. the scalar-function and DISTINCT path: TPC-H Q2, Q7, Q8, Q9, Q10, Q13,
     Q14, Q15, Q16, Q17, Q20 and Q22 at sf1 through LocalQueryRunner on the
     card and on the 4-worker mesh with default knobs, each cold and twice
     warm, with wall time, rows/s, peak device memory and the sorted-probe
     kernel's launches (every mesh run of a query with a sorted-probe join
     must launch it); one profiled warm run each of the local Q13 and the
     mesh Q9 and Q16; then, untimed, each mesh query's largest launch
     (P, cap_b, n_match, S) and the host time of Q13's LIKE table with the
     size of its dictionary; every result is checked against the port's CPU
     LocalQueryRunner at sf1;
  5d. TPC-DS without windows: the 84 TPC-DS queries that have no window
     function at tpcds.sf1 (q72 at sf0_1, see TPCDS_SCHEMA) through
     LocalQueryRunner on the card and on the 4-worker mesh with default
     knobs, each cold and warm, with wall time, peak device memory and the
     sorted-probe kernel's launches (every mesh search whose key planes
     the kernel takes must launch it; the cold mesh run records each
     launch's (P, cap_b, n_match, S) and keeps the largest launch's
     inputs); one profiled warm run each of q78 (local and mesh) and q75
     (mesh); every result is held to the port's CPU run of the same
     query, which a child process of this script computes on its own half
     of the cores while the card phases run, with each query's host
     planning time (ORDER BY keys in order, rows as a multiset where the
     ORDER BY leaves ties, keys only for the tie group a LIMIT cuts
     through: trino_tpu_torch/testing.py);
  6. hold the sorted-probe kernel to its plain version on the card, bit for
     bit, at the inputs of the largest launch of phase 5 and at the edges
     (duplicate runs and misses, runs crossing window edges and runs longer
     than several windows, all rows nomatch, n_match in {0, 1, S - 1,
     S + 1} and not a multiple of S, a plane whose length is not a multiple
     of S, ragged and small probe lengths, keys at INT64_MIN/MAX, an int32
     plane, build planes large enough for S = 16 and S = 512), and time
     kernel (back to back, and per launch with the L2 flushed), plain
     version, the torch.searchsorted yardstick and the bound; also bit-exact
     at the inputs of the largest and of the smallest-n_match semi-join
     launch of phase 5b, and timed at the largest; bit-exact and timed at
     the inputs of the largest launch of phases 5c and 5d;
  7. one JSON line with the kernels;
  8. last line: {"ok": true, "device": {...}}.

Tolerances: integers, decimals, dates and strings exact.  Kernel sums: counts
exact, |kernel - plain| <= 5e-5 * (sum of |values| in the cell), the f32
summation bound of the kernel (~530 sequential additions * 2**-24).  Q1 over
DOUBLE with the f32 kernel against the CPU's f64 path: relative 5e-5 on
doubles (all summed values are non-negative), counts exact; every other
double relative 1e-9.  The sorted-probe kernel: bit-exact.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
LINEITEM_SF1_ROWS = 6_001_215
KERNEL_RTOL = 5e-5
MESH_WORKERS = 4
DOUBLE_RTOL = 1e-9
#: phase 5b: the local queries, and the mesh queries (the first three hold
#: semi joins, Q11 a cross join)
SEMI_LOCAL_QIDS = (4, 11, 12, 18, 19, 21)
SEMI_MESH_QIDS = (4, 18, 21, 11)
SEMI_JOIN_QIDS = (4, 18, 21)
#: phase 5c: the scalar-function and DISTINCT slice's queries, and Q10 and
#: Q15 (ported earlier, first run on the card here), locally and on the mesh
FUNC_QIDS = (2, 7, 8, 9, 10, 13, 14, 15, 16, 17, 20, 22)
#: the phase 5c mesh queries that hold a join the sorted-probe kernel takes
#: (Q22's only join is the cross join with its scalar subquery)
FUNC_PROBE_QIDS = (2, 7, 8, 9, 10, 13, 14, 15, 16, 17, 20)
#: phase 5d: the TPC-DS queries with a window function (not ported yet);
#: the other 84 run
TPCDS_WINDOW_QIDS = frozenset({12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98})
#: the phase 5d queries that run below sf1: q72's plan (the JAX package's
#: join order, which the port keeps) joins catalog_sales to inventory
#: before any filter, ~940 M rows at sf1, beyond the card's memory without
#: the spill and wave machinery, which is not ported yet
TPCDS_SCHEMA = {72: "sf0_1"}
#: phase 5d's profiled warm runs: a star join over the three sales
#: channels and their returns (local and mesh) and a union of the three
#: channels (mesh)
TPCDS_PROFILES = ((78, "local"), (78, "mesh"), (75, "mesh"))

Q1_DOUBLE = """select l_returnflag, l_linestatus,
       sum(cast(l_quantity as double)), sum(cast(l_extendedprice as double)),
       sum(cast(l_extendedprice as double) * (1 - cast(l_discount as double))),
       avg(cast(l_quantity as double)), avg(cast(l_discount as double)), count(*)
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""


def log(*args):
    print(*args, flush=True)


def cuda_ms_l2_flushed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() launch whose inputs start outside the
    L2: before each launch a 128 MB scratch tensor (2.5x the 50 MB L2) is
    written, then CUDA events bracket that launch alone.  The same
    device-side sleep as `cuda_ms` lets the host queue every launch first."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for i, (start, end) in enumerate(events):
        flush.fill_(i & 0xFF)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def time_kernel(name: str, fn, bound_ms: float) -> dict:
    """Both times of one kernel call and their shares of the bound."""
    ms = cuda_ms(fn)
    flushed = cuda_ms_l2_flushed(fn)
    log(
        f"{name}: kernel_ms={ms!r} (bound share {bound_ms / ms:.3f}) "
        f"ms_l2_flushed={flushed!r} (bound share {bound_ms / flushed:.3f}) "
        f"bound_ms={bound_ms!r}"
    )
    return {"ms": ms, "ms_l2_flushed": flushed}


def check_ptxas(names) -> None:
    """ptxas's report of every kernel function: registers, shared memory,
    and no spill stores or loads."""
    from trino_tpu_torch.kernels import build

    for name in names:
        report = build.log_path(name).read_text()
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
        if not spills:
            raise AssertionError(f"{name}: no ptxas report in the build log")
        if any(int(a) or int(b) for a, b in spills):
            raise AssertionError(f"{name}: ptxas reports register spills:\n{report}")
        log(f"ptxas {name}: {len(spills)} functions, no spills")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events.  A
    device-side sleep first holds the stream while the launches queue up
    behind it, so host launch overhead does not open gaps between them
    (a function that synchronizes inside still pays its host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms of device cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 3: the grouped-sums kernel against its plain version ---------------


def grouped_sums_inputs(n, g, k, live_fraction, seed, dev):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    gids = torch.randint(0, g, (n,), generator=gen, dtype=torch.int32)
    mask = torch.rand(n, generator=gen) < live_fraction
    values = torch.rand((n, k), generator=gen, dtype=torch.float32)
    values[:, 0] = 1.0  # a count column
    return gids.to(dev), mask.to(dev), values.to(dev)


def check_grouped_sums(dev) -> dict:
    from trino_tpu_torch.ops import grouped_sums as gs

    shapes = [
        # (name, N, G, K, live fraction, row offset): the main path's
        # per-batch shape (Q1-double: 2**20-row scan batches, 12 group
        # slots, 11 columns), then the edges.  The staged tiles are 512
        # rows; a row offset of 1 makes every input start off a 16-byte
        # boundary (read in place).
        ("main", 1 << 20, 12, 11, 0.78, 0),
        ("g1", 2048, 1, 1, 0.7, 0),
        ("g512", 2048, 512, 11, 0.7, 0),
        ("g512_k32", 8192, 512, 32, 0.7, 0),
        ("k200_tiled", 4096, 512, 200, 0.7, 0),
        ("all_masked", 1 << 20, 12, 11, 0.0, 0),
        ("ragged_n", (1 << 20) + 77, 12, 11, 0.78, 0),
        ("sub_tile_n", 300, 12, 11, 0.78, 0),
        ("one_tile_plus_1", 513, 12, 11, 0.78, 0),
        ("k3_rows_not_16b", 100_003, 12, 3, 0.78, 0),
        ("k5_rows_not_16b", 4099, 7, 5, 0.78, 0),
        ("unaligned", 100_000, 12, 11, 0.78, 1),
    ]
    main = None
    for name, n, g, k, live, offset in shapes:
        gids, mask, values = grouped_sums_inputs(n + offset, g, k, live, seed=n + g + k, dev=dev)
        gids, mask, values = gids[offset:], mask[offset:], values[offset:]
        out = gs.grouped_sums(gids, mask, values, g)
        torch.cuda.synchronize()
        ref = gs.grouped_sums_reference(gids, mask, values, g)
        scale = gs.grouped_sums_reference(gids, mask, values.abs(), g)
        err = (out - ref).abs()
        max_abs_err = float(err.max())
        if not torch.equal(out[:, 0], ref[:, 0]):
            raise AssertionError(f"grouped_sums {name}: counts differ")
        if not bool((err <= KERNEL_RTOL * scale).all()):
            raise AssertionError(
                f"grouped_sums {name}: max |err| {max_abs_err} exceeds "
                f"{KERNEL_RTOL} x the cell's sum of |values|"
            )
        if live == 0.0 and bool(out.any()):
            raise AssertionError("grouped_sums all_masked: nonzero output")
        log(f"grouped_sums check {name}: N={n} G={g} K={k} max_abs_err={max_abs_err!r} ok")
        if name == "main":
            main = (n, g, k, gids, mask, values, max_abs_err)

    n, g, k, gids, mask, values, max_abs_err = main
    plain_ms = cuda_ms(lambda: gs.grouped_sums_reference(gids, mask, values, g))
    onehot = torch.logical_and(
        gids[:, None] == torch.arange(g, device=dev, dtype=gids.dtype)[None, :],
        mask[:, None],
    ).to(torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = cuda_ms(lambda: torch.matmul(onehot.T, values))
    # the bytes this input needs: gid + mask of every row, the values of the
    # live rows only (the kernel skips dead rows), the [G, K] result
    live_rows = int(mask.sum())
    nbytes = n * (4 + 1) + live_rows * 4 * k + 4 * g * k
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live_rows * k / F32_FLOPS * 1e3  # one f32 add per live value
    bound_ms = max(bytes_ms, ops_ms)
    times = time_kernel(
        "grouped_sums main", lambda: gs.grouped_sums(gids, mask, values, g), bound_ms
    )
    log(
        f"grouped_sums main: plain_ms={plain_ms!r} "
        f"library_ms={library_ms!r} (one-hot f32 matmul, TF32 off) "
        f"bound_ms={bound_ms!r} ({nbytes} bytes, {live_rows} live rows)"
    )
    return {
        "name": "grouped_sums",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/grouped_sums.cu",
        "replaces": "trino_tpu/ops/pallas_agg.py:62",
        "max_abs_err": max_abs_err,
        **times,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


# -- phase 4: the main path ----------------------------------------------------


def rows_match(actual, expected, float_rtol: float) -> None:
    if len(actual) != len(expected):
        raise AssertionError(f"row count {len(actual)} != {len(expected)}")
    for ra, re in zip(actual, expected):
        for va, ve in zip(ra, re):
            if isinstance(ve, float):
                if not math.isclose(va, ve, rel_tol=float_rtol, abs_tol=0.0):
                    raise AssertionError(f"{va!r} != {ve!r} (rel {float_rtol})")
            elif type(va) is not type(ve) or va != ve:
                raise AssertionError(f"{va!r} != {ve!r}\n{ra}\n{re}")


def profile_warm(name: str, runner, sql: str) -> None:
    """One more warm run under torch.profiler: host planning time, the
    card's busy time (the sum of kernel and copy times; the path runs on
    one stream) against the wall, and the device ops that take the most
    time."""
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.sql.parser import parse_statement

    t0 = time.perf_counter()
    runner.plan_query(parse_statement(sql).query)
    plan_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(sql)
        wall = time.perf_counter() - t0

    # kernels and copies are the CUDA-typed events; the aten ops that
    # launched them carry the same time again, so they are left out
    events = sorted(
        (e for e in prof.key_averages()
         if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.device_time_total,
        reverse=True,
    )
    busy_s = sum(e.device_time_total for e in events) / 1e6
    log(
        f"profile {name} warm: wall_s={wall!r} plan_s={plan_s!r} "
        f"device_events={len(events)} device_busy_s={busy_s!r} "
        f"device_idle_share={1 - busy_s / wall!r}"
    )
    for e in events[:8]:
        log(
            f"  {name} device op {e.key[:70]!r}: calls={e.count} "
            f"device_ms={e.device_time_total / 1e3!r}"
        )
    for e in events:  # the port's own kernels, wherever they rank
        if "grouped_sums" in e.key or "locate_sorted" in e.key:
            log(
                f"  {name} kernel {e.key[:70]!r}: calls={e.count} "
                f"device_ms={e.device_time_total / 1e3!r}"
            )


def run_main_path() -> dict:
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    queries = [
        ("q1", QUERIES[1], False),
        ("q6", QUERIES[6], False),
        ("q1_double", Q1_DOUBLE, True),
    ]
    runner = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_runner = LocalQueryRunner(catalog="tpch", schema="sf1")
    kernel_runner.execute("set session pallas_agg = true")
    results = {}
    gs.grouped_sums.launches = 0  # every kernel count, just before the main path
    for name, sql, use_kernel in queries:
        r = kernel_runner if use_kernel else runner
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = gs.grouped_sums.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(sql)  # rows come back to the host: synchronized
            wall = time.perf_counter() - t0
            walls.append(wall)
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"grouped_sums_launches={gs.grouped_sums.launches - before} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()}"
            )
        results[name] = (sql, res, min(walls[1:]))
    for name, sql, use_kernel in queries:
        profile_warm(name, kernel_runner if use_kernel else runner, sql)
    launches = gs.grouped_sums.launches  # read just after the main path
    log(f"main path: grouped_sums launches={launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched grouped_sums")
    for name, (sql, res, warm) in results.items():
        log(f"{name} warm: wall_s={warm!r} lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")
    # the port's own CPU run of every query (f64 paths) as the reference
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    for name, (sql, res, _) in results.items():
        t0 = time.perf_counter()
        expected = cpu.execute(sql)
        rtol = KERNEL_RTOL if name == "q1_double" else 0.0
        rows_match(res.rows, expected.rows, float_rtol=rtol)
        log(
            f"{name}: {len(res.rows)} rows match the CPU run "
            f"(cpu wall_s={time.perf_counter() - t0!r}); first row {res.rows[0]}"
        )
    return {"launches": launches}


# -- phase 5: the join and mesh path ------------------------------------------


def recording_probe(capture: dict):
    """A stand-in for the mesh join's call of the sorted-probe wrapper: it
    passes every call through (the wrapper alone counts the launch), notes
    the launch shapes in capture["shapes"] and, while capture["keep"] is
    set, keeps copies of the inputs of the largest launch in
    capture["inputs"]."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel = mesh_runner.locate_sorted

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        capture.setdefault("shapes", set()).add(
            (probe.shape[0], build.shape[0], cap_b)
        )
        size = probe.shape[0] * max(build.shape[0], 1)
        if capture.get("keep") and size > capture.get("size", -1):
            capture.update(
                size=size,
                inputs=(build.clone(), n_match.clone(), probe.clone(),
                        nomatch.clone(), cap_b),
            )
        return out

    return kernel, recording


def capture_probe_inputs(mesh, sql: str, capture: dict) -> None:
    """One untimed run of `sql` on `mesh` that copies the inputs of its
    largest sorted-probe launch into capture["inputs"]."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel, recording = recording_probe(capture)
    capture["keep"] = True
    mesh_runner.locate_sorted = recording
    try:
        mesh.execute(sql)
    finally:
        mesh_runner.locate_sorted = kernel
        capture["keep"] = False


def run_mesh_path(capture: dict) -> dict:
    """TPC-H Q3 at sf1: the 4-worker mesh with `pallas_probe` on and with
    default knobs (on the card both take the sorted-probe kernel), and the
    local runner (the direct-address join).  `capture` receives the inputs
    of the largest sorted-probe launch."""
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    sql = QUERIES[3]
    kernel_mesh = DistributedQueryRunner(
        catalog="tpch", schema="sf1", n_workers=MESH_WORKERS
    )
    kernel_mesh.execute("set session pallas_probe = true")
    plain_mesh = DistributedQueryRunner(
        catalog="tpch", schema="sf1", n_workers=MESH_WORKERS
    )
    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    runs = [
        ("q3_mesh_kernel", kernel_mesh),
        ("q3_mesh", plain_mesh),
        ("q3_local", local),
    ]

    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel, recording = recording_probe(capture)
    results = {}
    mesh_runner.locate_sorted = recording
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for name, r in runs:
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = ls.locate_sorted.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(sql)  # rows come back to the host: synchronized
            wall = time.perf_counter() - t0
            walls.append(wall)
            if name.startswith("q3_mesh") and ls.locate_sorted.launches == before:
                raise AssertionError(f"{name} {attempt}: no locate_sorted launch")
            ex = getattr(r, "last_stage_executor", None)
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"locate_sorted_launches={ls.locate_sorted.launches - before} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"memory_allocated_after={torch.cuda.memory_allocated()}"
                + ("" if ex is None else f" mesh_events={ex.counters}")
            )
        results[name] = (res, min(walls[1:]))
    for name, r in runs:
        profile_warm(name, r, sql)
    launches = ls.locate_sorted.launches  # read just after the path
    mesh_runner.locate_sorted = kernel
    # untimed, and after the count was read: copies phase 6's inputs
    capture_probe_inputs(kernel_mesh, sql, capture)
    log(f"mesh path: locate_sorted launches={launches} "
        f"shapes (P, build rows, cap_b)={sorted(capture.get('shapes', ()))}")
    if launches <= 0:
        raise AssertionError("the mesh path never launched locate_sorted")
    for name, (res, warm) in results.items():
        log(f"{name} warm: wall_s={warm!r} lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    t0 = time.perf_counter()
    expected = cpu.execute(sql)
    log(f"q3 cpu reference: wall_s={time.perf_counter() - t0!r}")
    for name, (res, _) in results.items():
        rows_match(res.rows, expected.rows, float_rtol=0.0)
        log(f"{name}: {len(res.rows)} rows match the CPU run; first row {res.rows[0]}")
    return {"launches": launches}


# -- phase 5b: semi joins, cross joins and the conditional forms ---------------


def _in_semi_join() -> bool:
    """Whether the running sorted-probe call comes from a mesh semi join:
    the frame that called the mesh's probe search (the `search` closure of
    `StageExecutor._probe_search`) is a `_x_SemiJoinNode` closure.  The
    walk up the stack finds the search by its qualified name (Python 3.11
    or later), not by a fixed depth.  Should the port's calls change shape
    so that no semi-join caller is found, phase 5b's check that every mesh
    run of a semi-join query launches the kernel from a semi join fails."""
    frame = sys._getframe(1)
    search = "_probe_search.<locals>"
    while frame is not None and search not in frame.f_code.co_qualname:
        frame = frame.f_back
    while frame is not None and search in frame.f_code.co_qualname:
        frame = frame.f_back
    return frame is not None and "_x_SemiJoinNode.<locals>" in frame.f_code.co_qualname


def semi_recording_probe(record: dict):
    """A stand-in for the mesh's call of the sorted-probe wrapper that
    passes every call through (the wrapper alone counts the launch) and
    counts the launches made from a semi join in record["semi"].  While
    record["keep"] is set it also notes each semi-join launch's P, n_match
    (a host read) and cap_b in record["launches"], and keeps copies of the
    inputs of the largest launch and of the smallest-n_match one."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    kernel = mesh_runner.locate_sorted

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        if not _in_semi_join():
            return out
        record["semi"] = record.get("semi", 0) + 1
        if record.get("keep"):
            nm = int(n_match)
            inputs = (build.clone(), n_match.clone(), probe.clone(), nomatch.clone(), cap_b)
            record.setdefault("launches", []).append(
                (record.get("query"), probe.shape[0], build.shape[0], cap_b, nm)
            )
            size = probe.shape[0] * max(build.shape[0], 1)
            if size > record.get("largest_size", -1):
                record.update(largest_size=size, largest=inputs)
            if nm < record.get("min_n_match", math.inf):
                record.update(min_n_match=nm, smallest=inputs)
        return out

    return kernel, recording


def run_semi_cross_path(record: dict) -> dict:
    """Phase 5b: the six queries through the local runner on the card and
    four of them on the 4-worker mesh, cold and warm, each checked against
    the port's CPU run at sf1.  `record` receives the semi-join launches'
    shapes and the inputs phase 6 checks the kernel on."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    runs = [(f"q{q}_local", q, local) for q in SEMI_LOCAL_QIDS]
    runs += [(f"q{q}_mesh", q, mesh) for q in SEMI_MESH_QIDS]
    kernel, recording = semi_recording_probe(record)
    results = {}
    mesh_runner.locate_sorted = recording
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    try:
        for name, q, r in runs:
            walls = []
            for attempt in ("cold", "warm", "warm"):
                before = ls.locate_sorted.launches
                semi_before = record.get("semi", 0)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = r.execute(QUERIES[q])  # rows come back to the host
                wall = time.perf_counter() - t0
                walls.append(wall)
                semi = record.get("semi", 0) - semi_before
                if r is mesh and q in SEMI_JOIN_QIDS and semi == 0:
                    raise AssertionError(f"{name} {attempt}: no semi-join locate_sorted launch")
                ex = getattr(r, "last_stage_executor", None)
                log(
                    f"{name} {attempt}: wall_s={wall!r} "
                    f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                    f"locate_sorted_launches={ls.locate_sorted.launches - before} "
                    f"semi_join_launches={semi} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"memory_allocated_after={torch.cuda.memory_allocated()} "
                    f"rows={len(res.rows)}"
                    + ("" if ex is None or r is not mesh else f" mesh_events={ex.counters}")
                )
            results[name] = (q, res, walls[0], min(walls[1:]))
        for q in (18, 21):
            profile_warm(f"q{q}_mesh", mesh, QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
    launches = ls.locate_sorted.launches  # read just after the path
    record["semi_path"] = record.get("semi", 0)
    log(f"semi/cross path: locate_sorted launches={launches} "
        f"from semi joins={record['semi_path']}")
    if launches <= 0:
        raise AssertionError("the semi/cross path never launched locate_sorted")
    # untimed, after the count was read: every semi-join launch's shape, and
    # the inputs phase 6 checks the kernel on
    mesh_runner.locate_sorted = recording
    record["keep"] = True
    try:
        for q in SEMI_JOIN_QIDS:
            record["query"] = f"q{q}"
            mesh.execute(QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
        record["keep"] = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for query, p, rows, cap_b, nm in record.get("launches", []):
        log(f"semi-join launch {query}: P={p} build_rows={rows} cap_b={cap_b} "
            f"n_match={nm} S={ls.launch_plan(max(cap_b, rows), p, sms)['s']}")
    for name, (q, res, cold, warm) in results.items():
        log(f"{name}: cold_s={cold!r} warm_s={warm!r} "
            f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    for q in SEMI_LOCAL_QIDS:
        t0 = time.perf_counter()
        expected = cpu.execute(QUERIES[q])
        cpu_s = time.perf_counter() - t0
        if not expected.rows:
            raise AssertionError(f"q{q}: the CPU reference returned no rows")
        for name in (f"q{q}_local", f"q{q}_mesh"):
            if name in results:
                rows_match(results[name][1].rows, expected.rows, float_rtol=DOUBLE_RTOL)
        log(f"q{q}: local{' and mesh' if q in SEMI_MESH_QIDS else ''} match the CPU run "
            f"({len(expected.rows)} rows, cpu wall_s={cpu_s!r}); first row {expected.rows[0]}")
    return {"launches": launches}


# -- phase 5c: the scalar functions and DISTINCT aggregates ---------------------


def shape_recording_probe(record: dict):
    """A stand-in for the mesh's call of the sorted-probe wrapper that passes
    every call through (the wrapper alone counts the launch), notes each
    launch's (P, cap_b, n_match, S) under record["query"] in
    record["shapes"], and keeps copies of the inputs of the largest launch
    in record["largest"].  n_match is a host read, so it runs only in the
    untimed capture runs."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.ops import locate_sorted as ls

    kernel = mesh_runner.locate_sorted
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def recording(build, n_match, probe, nomatch, cap_b):
        out = kernel(build, n_match, probe, nomatch, cap_b=cap_b)
        s = ls.launch_plan(max(cap_b, build.shape[0]), probe.shape[0], sms)["s"]
        record.setdefault("shapes", {}).setdefault(record["query"], []).append(
            (probe.shape[0], cap_b, int(n_match), s)
        )
        size = probe.shape[0] * max(build.shape[0], 1)
        if size > record.get("largest_size", -1):
            record.update(
                largest_size=size, largest_query=record["query"],
                largest=(build.clone(), n_match.clone(), probe.clone(),
                         nomatch.clone(), cap_b),
            )
        return out

    return kernel, recording


def like_table_seconds(runner, sql: str) -> list:
    """One untimed run of `sql` that times every LIKE/regexp table the host
    builds over a dictionary: [(dictionary entries, seconds)]."""
    from trino_tpu_torch.columnar.dictionary import StringDictionary

    original = StringDictionary.predicate_table
    calls = []

    def timed(self, fn):
        t0 = time.perf_counter()
        out = original(self, fn)
        calls.append((len(self), time.perf_counter() - t0))
        return out

    StringDictionary.predicate_table = timed
    try:
        runner.execute(sql)
    finally:
        StringDictionary.predicate_table = original
    return calls


def run_function_path(record: dict) -> dict:
    """Phase 5c: the twelve queries through the local runner on the card and
    on the 4-worker mesh, cold and warm, each checked against the port's
    CPU run at sf1.  Every mesh run of a query with a sorted-probe join
    must launch the kernel.  `record` receives each mesh query's launch
    shapes (an untimed capture run per query, after the count was read)."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="sf1")
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=MESH_WORKERS)
    runs = [(f"q{q}_local", q, local) for q in FUNC_QIDS]
    runs += [(f"q{q}_mesh", q, mesh) for q in FUNC_QIDS]
    results = {}
    per_query = {}
    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for name, q, r in runs:
        walls = []
        for attempt in ("cold", "warm", "warm"):
            before = ls.locate_sorted.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = r.execute(QUERIES[q])  # rows come back to the host
            wall = time.perf_counter() - t0
            walls.append(wall)
            launched = ls.locate_sorted.launches - before
            if r is mesh:
                per_query[q] = launched
                if q in FUNC_PROBE_QIDS and launched == 0:
                    raise AssertionError(f"{name} {attempt}: no locate_sorted launch")
            log(
                f"{name} {attempt}: wall_s={wall!r} "
                f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / wall!r} "
                f"locate_sorted_launches={launched} "
                f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                f"memory_allocated_after={torch.cuda.memory_allocated()} "
                f"rows={len(res.rows)}"
                + ("" if r is not mesh else f" mesh_events={r.last_stage_executor.counters}")
            )
        results[name] = (q, res, walls[0], min(walls[1:]))
    profile_warm("q13_local", local, QUERIES[13])
    for q in (9, 16):
        profile_warm(f"q{q}_mesh", mesh, QUERIES[q])
    launches = ls.locate_sorted.launches  # read just after the path
    log(f"function/distinct path: locate_sorted launches={launches}")
    if launches <= 0:
        raise AssertionError("the function/distinct path never launched locate_sorted")
    # untimed, after the count was read: each mesh query's launch shapes, and
    # the host time of Q13's LIKE table
    kernel, recording = shape_recording_probe(record)
    mesh_runner.locate_sorted = recording
    try:
        for q in FUNC_PROBE_QIDS:
            record["query"] = f"q{q}"
            mesh.execute(QUERIES[q])
    finally:
        mesh_runner.locate_sorted = kernel
    for q in FUNC_PROBE_QIDS:
        shapes = record.get("shapes", {}).get(f"q{q}", [])
        largest = max(shapes, key=lambda t: t[0] * max(t[1], 1), default=None)
        log(f"q{q}_mesh sorted-probe launches={per_query[q]} "
            f"largest (P, cap_b, n_match, S)={largest}")
    for runner_name, r in (("local", local), ("mesh", mesh)):
        calls = like_table_seconds(r, QUERIES[13])
        log(f"q13 {runner_name} LIKE tables on the host: calls={len(calls)} "
            f"dictionary_entries={[n for n, _ in calls]} "
            f"seconds={sum(t for _, t in calls)!r}")
        if not calls:
            raise AssertionError("q13 built no LIKE table")
    for name, (q, res, cold, warm) in results.items():
        log(f"{name}: cold_s={cold!r} warm_s={warm!r} "
            f"lineitem_rows_per_s={LINEITEM_SF1_ROWS / warm!r}")
    cpu = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    for q in FUNC_QIDS:
        t0 = time.perf_counter()
        expected = cpu.execute(QUERIES[q])
        cpu_s = time.perf_counter() - t0
        if not expected.rows:
            raise AssertionError(f"q{q}: the CPU reference returned no rows")
        for name in (f"q{q}_local", f"q{q}_mesh"):
            rows_match(results[name][1].rows, expected.rows, float_rtol=DOUBLE_RTOL)
        log(f"q{q}: local and mesh match the CPU run ({len(expected.rows)} rows, "
            f"cpu wall_s={cpu_s!r}); first row {expected.rows[0]}")
    return {"launches": launches, "per_query": per_query}


# -- phase 5d: TPC-DS without windows -------------------------------------------


def tpcds_qids() -> list:
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES

    return [q for q in sorted(QUERIES) if q not in TPCDS_WINDOW_QIDS]


def _pin_to_cores(upper: bool) -> str:
    """Pin this process to one half of its cores (the CPU reference process
    takes the upper half, the process driving the card the lower), with torch's
    threads to match; on fewer than four cores nothing is pinned."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return f"not pinned ({len(cores)} cores)"
    half = len(cores) // 2
    mine = cores[half:] if upper else cores[:half]
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))
    return f"cores {mine[0]}-{mine[-1]}"


def tpcds_cpu_reference(out_path: str) -> int:
    """The child process: the port's CPU run (device="cpu") of every phase
    5d query, pickled to `out_path` as {qid: (column names, type names,
    rows, seconds, the query's ORDER BY and LIMIT, host planning
    seconds)}.  It runs beside the card phases, on its own cores."""
    import pickle

    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import result_order

    log(f"tpcds cpu reference: {_pin_to_cores(upper=True)}")
    runners = {}
    out = {}
    for q in tpcds_qids():
        schema = TPCDS_SCHEMA.get(q, "sf1")
        if schema not in runners:
            runners[schema] = LocalQueryRunner(catalog="tpcds", schema=schema, device="cpu")
        t0 = time.perf_counter()
        order = result_order(runners[schema].create_plan(QUERIES[q]))
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = runners[schema].execute(QUERIES[q])
        out[q] = (res.column_names, [t.name for t in res.types], res.rows,
                  time.perf_counter() - t0, order, plan_s)
    with open(out_path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".part", out_path)
    return 0


def start_tpcds_reference(here: str):
    """Start the CPU reference process; returns (process, result path)."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "tpcds_reference.pkl")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--tpcds-cpu-reference", path],
        cwd=here,
    )
    return proc, path


def wait_tpcds_reference(proc, path: str) -> dict:
    import pickle
    import shutil

    t0 = time.perf_counter()
    rc = proc.wait()
    log(f"tpcds cpu reference: exit {rc}, waited {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"the TPC-DS CPU reference process failed with exit code {rc}")
    with open(path, "rb") as f:
        out = pickle.load(f)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return out


def eligibility_recording_search(record: dict):
    """(original, stand-in) for StageExecutor._probe_search: the stand-in's
    search counts, in record["eligible"], every call whose key planes the
    sorted-probe kernel takes (`probe_kernel_eligible`, the routing's own
    predicate), then searches as before.  On the card every such call must
    launch the kernel."""
    from trino_tpu_torch.ops.locate_sorted import probe_kernel_eligible
    from trino_tpu_torch.parallel.runner import StageExecutor

    original = StageExecutor._probe_search

    def probe_search(self):
        search, use_kernel = original(self)

        def counted(canon, n_match, pc, pn, cap_b: int):
            if probe_kernel_eligible(canon, pc):
                record["eligible"] = record.get("eligible", 0) + 1
            return search(canon, n_match, pc, pn, cap_b)

        return counted, use_kernel

    return original, probe_search


def run_tpcds_path(record: dict, reference) -> dict:
    """Phase 5d: the 84 TPC-DS queries without a window function through the
    local runner on the card and on the 4-worker mesh (default knobs), cold
    and warm, each held to the port's CPU run (the reference process).  The
    cold mesh run of each query records its sorted-probe launches' shapes
    and keeps the inputs of the largest (one host read per launch).  Every
    mesh search whose key planes the kernel takes must launch it: each mesh
    run launches at least as many times as it made such searches, and a
    query with one launches at least once."""
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner, StageExecutor
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.testing import assert_rows_match

    qids = tpcds_qids()
    runners = {}

    def runner(where: str, schema: str):
        if (where, schema) not in runners:
            runners[where, schema] = (
                LocalQueryRunner(catalog="tpcds", schema=schema) if where == "local"
                else DistributedQueryRunner(
                    catalog="tpcds", schema=schema, n_workers=MESH_WORKERS
                )
            )
        return runners[where, schema]

    kernel, recording = shape_recording_probe(record)
    original_search, eligible_search = eligibility_recording_search(record)
    results = {}
    per_query = {}
    log(f"tpcds: {len(qids)} queries, local and mesh; at sf0_1 only: "
        f"{sorted(TPCDS_SCHEMA)} (see TPCDS_SCHEMA)")
    StageExecutor._probe_search = eligible_search
    try:
        _tpcds_runs(qids, runner, record, results, per_query, kernel, recording)
    finally:
        StageExecutor._probe_search = original_search
    launches = ls.locate_sorted.launches  # read just after the path
    log(f"tpcds path: locate_sorted launches={launches}")
    if launches <= 0:
        raise AssertionError("the TPC-DS path never launched locate_sorted")
    for q in qids:
        shapes = record.get("shapes", {}).get(f"q{q}", [])
        largest = max(shapes, key=lambda t: t[0] * max(t[1], 1), default=None)
        log(f"tpcds q{q}_mesh sorted-probe launches={per_query[q]} "
            f"largest (P, cap_b, n_match, S)={largest}")
    for (q, where), (res, cold, warm) in results.items():
        log(f"tpcds q{q}_{where}: cold_s={cold!r} warm_s={warm!r} rows={len(res.rows)}")
    expected_all = reference()
    empty = []
    for q in qids:
        names, types, rows, cpu_s, order, plan_s = expected_all[q]
        for where in ("local", "mesh"):
            actual = results[q, where][0]
            if actual.column_names != names or [t.name for t in actual.types] != types:
                raise AssertionError(f"tpcds q{q}_{where}: columns differ from the CPU run")
            try:
                assert_rows_match(actual.rows, rows, order, float_rtol=DOUBLE_RTOL)
            except AssertionError as e:
                raise AssertionError(f"tpcds q{q}_{where}: {e}") from None
        if not rows:
            empty.append(q)
        log(f"tpcds q{q}: local and mesh match the CPU run ({len(rows)} rows, "
            f"cpu wall_s={cpu_s!r}, cpu plan_s={plan_s!r})")
    log(f"tpcds: all {len(qids)} queries match the CPU run, local and mesh; "
        f"empty results: {empty}")
    return {"launches": launches, "per_query": per_query}


def _tpcds_runs(qids, runner, record, results, per_query, kernel, recording) -> None:
    """Phase 5d's timed runs: each query local, then mesh, cold and warm,
    then the profiled warm runs."""
    import trino_tpu_torch.parallel.runner as mesh_runner
    from trino_tpu_torch.connectors.tpcds.queries import QUERIES
    from trino_tpu_torch.ops import locate_sorted as ls

    ls.locate_sorted.launches = 0  # every kernel count, just before the path
    for where in ("local", "mesh"):
        for q in qids:
            schema = TPCDS_SCHEMA.get(q, "sf1")
            r = runner(where, schema)
            walls = []
            for attempt in ("cold", "warm"):
                capture = where == "mesh" and attempt == "cold"
                if capture:
                    record["query"] = f"q{q}"
                    mesh_runner.locate_sorted = recording
                before = ls.locate_sorted.launches
                eligible_before = record.get("eligible", 0)
                torch.cuda.reset_peak_memory_stats()
                try:
                    t0 = time.perf_counter()
                    res = r.execute(QUERIES[q])  # rows come back to the host
                    wall = time.perf_counter() - t0
                finally:
                    mesh_runner.locate_sorted = kernel
                walls.append(wall)
                launched = ls.locate_sorted.launches - before
                eligible = record.get("eligible", 0) - eligible_before
                if where == "mesh":
                    per_query[q] = launched
                    if launched < eligible or (eligible and not launched):
                        raise AssertionError(
                            f"q{q} mesh {attempt}: {eligible} searches the sorted-probe "
                            f"kernel takes, {launched} launches"
                        )
                log(
                    f"tpcds q{q}_{where} {attempt} ({schema}): wall_s={wall!r} "
                    f"locate_sorted_launches={launched} kernel_eligible_searches={eligible} "
                    f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
                    f"memory_allocated_after={torch.cuda.memory_allocated()} "
                    f"rows={len(res.rows)}"
                )
            results[q, where] = (res, walls[0], walls[1])
    for q, where in TPCDS_PROFILES:
        profile_warm(f"tpcds_q{q}_{where}", runner(where, TPCDS_SCHEMA.get(q, "sf1")), QUERIES[q])


# -- phase 6: the sorted-probe kernel against its plain version ----------------


def probe_edge_inputs(dev):
    """(name, build, n_match, probe, nomatch, cap_b) at the edges."""
    rng = np.random.default_rng(7)
    i64 = np.iinfo(np.int64)

    def sorted_build(cap_b, n_match, lo, hi, dtype=np.int64):
        keys = np.sort(rng.integers(lo, hi, n_match)).astype(dtype)
        pad = np.full(cap_b - n_match, np.iinfo(dtype).max, dtype=dtype)
        return np.concatenate([keys, pad])

    cases = []
    b = sorted_build(512, 389, 0, 64)
    cases.append(("dups_misses", b, 389, rng.integers(-4, 72, 2048), rng.random(2048) < 0.15, 512))
    cases.append(("all_nomatch", b, 389, rng.integers(0, 64, 4096), np.ones(4096, bool), 512))
    cases.append(("n_match_0", np.full(16, i64.max), 0, np.arange(64), np.zeros(64, bool), 16))
    b = sorted_build(4096, 3000, -1000, 1000)
    cases.append(("ragged_p", b, 3000, rng.integers(-1100, 1100, 1500), rng.random(1500) < 0.1, 4096))
    cases.append(("small_p", b, 3000, rng.integers(-1100, 1100, 100), np.zeros(100, bool), 4096))
    edge = np.array([i64.min, i64.min, -1, 0, 5, i64.max - 1, i64.max, i64.max])
    cases.append(("int64_extremes", edge, 8, np.array([i64.min, i64.max, 0, -1, 7, i64.max - 1, 3]), np.zeros(7, bool), 8))
    b = sorted_build(1024, 900, -50, 50, np.int32)
    cases.append(("int32_planes", b, 900, rng.integers(-60, 60, 3000).astype(np.int32), rng.random(3000) < 0.05, 1024))
    # the splitter tier (S = 8 at these planes): runs of ~10 equal keys
    # that cross window edges, a run of 100 equal keys (12 windows), and
    # n_match at 1, S - 1, S + 1 and not a multiple of S
    b = sorted_build(4096, 3000, 0, 300)
    cases.append(("runs_cross_windows", b, 3000, rng.integers(-5, 305, 8192), rng.random(8192) < 0.1, 4096))
    keys = np.sort(np.concatenate([np.full(100, 7), rng.integers(-40, 40, 900)]))
    b = np.concatenate([keys, np.full(24, i64.max)])
    cases.append(("run_of_100", b, 1000, rng.integers(-45, 45, 4096), np.zeros(4096, bool), 1024))
    for n_match in (1, 7, 9, 1003):
        b = sorted_build(1024, n_match, -20, 20)
        cases.append((f"n_match_{n_match}", b, n_match, rng.integers(-25, 25, 2048), rng.random(2048) < 0.1, 1024))
    b = sorted_build(1003, 1003, -400, 400)  # the last window is ragged
    cases.append(("plane_not_multiple_of_s", b, 1003, rng.integers(-410, 410, 2048), np.zeros(2048, bool), 1003))
    # larger planes: S = 16 (vector windows of 16 keys, two rows a thread)
    # and S = 512 (windows searched in device memory)
    b = sorted_build(1 << 17, 100_001, 0, 20_000)
    cases.append(("s16_cap_2e17", b, 100_001, rng.integers(-10, 20_010, 1 << 16), rng.random(1 << 16) < 0.2, 1 << 17))
    b = sorted_build(1 << 22, 3_000_001, 0, 1_000_000)
    cases.append(("s512_cap_2e22", b, 3_000_001, rng.integers(-10, 1_000_010, 1 << 16), rng.random(1 << 16) < 0.2, 1 << 22))
    out = []
    for name, build, n_match, probe, nomatch, cap_b in cases:
        out.append((
            name,
            torch.from_numpy(np.ascontiguousarray(build)).to(dev),
            torch.tensor(n_match, dtype=torch.int64, device=dev),
            torch.from_numpy(np.ascontiguousarray(probe)).to(dev),
            torch.from_numpy(np.ascontiguousarray(nomatch)).to(dev),
            cap_b,
        ))
    return out


def locate_sorted_bound(build, n_match, probe, nomatch) -> tuple:
    """(bound_ms, bound_by, bytes) of one sorted-probe call: every nomatch
    flag read and start/count written once, the probe key of live rows only
    (a nomatch row's key is never read), and min(n_match, live) keys of the
    sorted prefix (each live row needs a build key at its bound, and no key
    is needed twice: a prefix longer than the live rows is not read whole);
    against two binary searches of ceil(log2(n_match + 1)) compares per
    live row."""
    n = int(n_match)
    live = int((~nomatch).sum())
    nbytes = probe.shape[0] * (1 + 16) + live * 8 + min(n, live) * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = live * 2 * max(1, (n + 1).bit_length()) / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes


def check_locate_sorted(dev, capture: dict, semi: dict, func: dict, tds: dict) -> dict:
    from trino_tpu_torch.ops import locate_sorted as ls

    if "inputs" not in capture:
        raise AssertionError("no sorted-probe launch was captured on the mesh path")
    if "largest" not in semi or "smallest" not in semi:
        raise AssertionError("no semi-join sorted-probe launch was captured")
    if "largest" not in func:
        raise AssertionError("no sorted-probe launch was captured in phase 5c")
    if "largest" not in tds:
        raise AssertionError("no sorted-probe launch was captured in phase 5d")
    build, n_match, probe, nomatch, cap_b = capture["inputs"]
    cases = [("main", build, n_match, probe, nomatch, cap_b)]
    cases += [("semi_largest",) + semi["largest"], ("semi_min_n_match",) + semi["smallest"]]
    cases += [(f"function_largest_{func['largest_query']}",) + func["largest"]]
    cases += [(f"tpcds_largest_{tds['largest_query']}",) + tds["largest"]]
    cases += probe_edge_inputs(dev)
    for name, b, nm, p, no, cb in cases:
        start, count = ls.locate_sorted(b, nm, p, no, cap_b=cb)
        torch.cuda.synchronize()
        rs, rc = ls.locate_sorted_reference(b, nm, p, no, cap_b=cb)
        if not (torch.equal(start, rs) and torch.equal(count, rc)):
            bad = int(((start != rs) | (count != rc)).sum())
            raise AssertionError(f"locate_sorted {name}: {bad} rows differ from the plain version")
        log(f"locate_sorted check {name}: P={p.shape[0]} build={b.shape[0]} "
            f"n_match={int(nm)} S={ls.launch_plan(max(cb, b.shape[0]), p.shape[0], 132)['s']} "
            f"matched_rows={int((count > 0).sum())} max_run={int(count.max())} bit-exact ok")

    main = time_probe_inputs("main", dev, capture["inputs"])
    semi_largest = time_probe_inputs("semi_largest", dev, semi["largest"])
    func_largest = time_probe_inputs("function_largest", dev, func["largest"])
    func_largest["query"] = func["largest_query"]
    tds_largest = time_probe_inputs("tpcds_largest", dev, tds["largest"])
    tds_largest["query"] = tds["largest_query"]
    keys = ("ms", "ms_l2_flushed", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": "locate_sorted",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/locate_sorted.cu",
        "replaces": "trino_tpu/ops/pallas_probe.py:66",
        "max_abs_err": 0,
        **{k: main[k] for k in keys},
        "semi_join_inputs": semi_largest,
        "function_path_inputs": func_largest,
        "tpcds_inputs": tds_largest,
    }


def time_probe_inputs(name: str, dev, inputs) -> dict:
    """The kernel (back to back and L2-flushed), its plain version, the
    torch.searchsorted yardstick (first checked against the plain version)
    and the bound at one launch's inputs."""
    from trino_tpu_torch.ops import locate_sorted as ls

    build, n_match, probe, nomatch, cap_b = inputs
    prefix = build[: int(n_match)]
    probe64 = probe.to(torch.int64)

    def library():
        lo = torch.searchsorted(prefix, probe64, right=False)
        hi = torch.searchsorted(prefix, probe64, right=True)
        return torch.where(nomatch, 0, lo), torch.where(nomatch, 0, hi - lo)

    lib_start, lib_count = library()
    rs, rc = ls.locate_sorted_reference(build, n_match, probe, nomatch, cap_b=cap_b)
    if not (torch.equal(lib_start, rs) and torch.equal(lib_count, rc)):
        raise AssertionError(f"{name}: the searchsorted yardstick disagrees with the plain version")
    bound_ms, bound_by, nbytes = locate_sorted_bound(build, n_match, probe, nomatch)
    times = time_kernel(
        f"locate_sorted {name}",
        lambda: ls.locate_sorted(build, n_match, probe, nomatch, cap_b=cap_b),
        bound_ms,
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ls.launch_plan(max(cap_b, build.shape[0]), probe.shape[0], sms)
    out = {
        **times,
        "plain_ms": cuda_ms(
            lambda: ls.locate_sorted_reference(build, n_match, probe, nomatch, cap_b=cap_b)
        ),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(library),
        "bytes": nbytes,
        "p": probe.shape[0],
        "live": int((~nomatch).sum()),
        "build": build.shape[0],
        "n_match": int(n_match),
        "s": plan["s"],
    }
    log(f"locate_sorted {name}: {out} plan={plan} "
        f"(library: torch.searchsorted lower+upper, masked)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not os.path.isdir(os.path.join(here, "trino_tpu_torch")):
        raise SystemExit("chip_smoke: the trino_tpu_torch package is not beside the script")
    # phase 5d's CPU reference runs beside every card phase, on its own cores
    reference, reference_path = start_tpcds_reference(here)
    try:
        return drive(here, lambda: wait_tpcds_reference(reference, reference_path))
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()


def drive(here: str, tpcds_reference) -> int:
    from trino_tpu_torch.device import resolve_device
    from trino_tpu_torch.kernels import build

    dev = resolve_device()
    log(f"card process: {_pin_to_cores(upper=False)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    kernels = ["grouped_sums", "locate_sorted"]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"build: {', '.join(kernels)} in {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        log(build.log_path(name).read_text().strip())
    check_ptxas(kernels)

    seconds = {"build": time.perf_counter() - t0}

    def timed(phase: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t
        return out

    k1 = timed("3", check_grouped_sums, dev)
    main_path = timed("4", run_main_path)
    k1["launches"] = main_path["launches"]
    capture: dict = {}
    mesh_path = timed("5", run_mesh_path, capture)
    semi: dict = {}
    semi_path = timed("5b", run_semi_cross_path, semi)
    func: dict = {}
    func_path = timed("5c", run_function_path, func)
    tds: dict = {}
    tds_path = timed("5d", run_tpcds_path, tds, tpcds_reference)
    k2 = timed("6", check_locate_sorted, dev, capture, semi, func, tds)
    log(f"phase seconds: {json.dumps(seconds)}")
    k2["launches"] = (
        mesh_path["launches"] + semi_path["launches"] + func_path["launches"]
        + tds_path["launches"]
    )
    k2["launches_by_path"] = {
        "q3_mesh": mesh_path["launches"], "semi_cross": semi_path["launches"],
        "semi_cross_from_semi_joins": semi["semi_path"],
        "functions_distinct": func_path["launches"],
        "functions_distinct_per_mesh_query": func_path["per_query"],
        "tpcds": tds_path["launches"],
        "tpcds_per_mesh_query": tds_path["per_query"],
    }
    log(json.dumps({"kernels": [k1, k2], "not_ported": []}))
    log(smi)
    log(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tpcds-cpu-reference"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(tpcds_cpu_reference(sys.argv[2]))
    sys.exit(main())
