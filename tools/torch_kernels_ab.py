#!/usr/bin/env python3
"""Time the port's two hand-written CUDA kernels against the same kernels of
an earlier tree, on one NVIDIA card, at the main path's shapes.

    git archive <commit> trino_tpu_torch/csrc trino_tpu_torch/ops \\
        | tar -x -C build/parent              # build/ is gitignored
    python3 tools/torch_kernels_ab.py --parent build/parent [DIR ...] [--tune]

The earlier tree's `trino_tpu_torch/csrc/{grouped_sums,locate_sorted}.cu`
are compiled with the same nvcc flags into build/trino_tpu_torch/<dir name>/,
and its `ops/{grouped_sums,locate_sorted}.py` wrappers drive them with that
tree's launch plans.  The inputs are chip_smoke.py's: the grouped sums at
Q1-double's batch (N = 2^20, G = 12, K = 11, 78% of rows live), the sorted
probe at the largest launch of TPC-H Q3 at sf1 on the 4-worker mesh.  Each
old kernel is held to the new one's plain version (the sorted probe bit
for bit, the grouped sums to chip_smoke's tolerance), then both are timed
in turns, old, new, new, old, with chip_smoke's two timers: back to back,
and per launch with the L2 flushed.  `--tune` also times the new kernels
under other launch plans (each checked first).

Prints the card's name and power limit and, last, one JSON line with
every time.  Needs a card; exits non-zero without one.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import KERNEL_RTOL, cuda_ms, cuda_ms_l2_flushed, log  # noqa: E402

KERNELS = ("grouped_sums", "locate_sorted")


def build_parent(parent: Path) -> dict:
    """Compile the earlier tree's kernels, one nvcc per source, together."""
    from trino_tpu_torch.kernels import build

    out = build.BUILD_DIR / parent.name
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        src = parent / "trino_tpu_torch" / "csrc" / f"{name}.cu"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{report}")
        log(f"earlier {name}: {report.strip()}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def parent_module(parent: Path, name: str, lib):
    """The earlier tree's wrapper module, bound to its own library: its
    `_library` sets the argument types of its C interface once (with
    `kernels.build.load` answering with that library), then always
    returns it."""
    import trino_tpu_torch.kernels.build as kb

    path = parent / "trino_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{parent.name}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    load = kb.load
    kb.load = lambda _name: lib
    try:
        mod._library()
    finally:
        kb.load = load
    mod._library = lambda: lib
    return mod


def in_turns(label: str, fns: dict) -> dict:
    """old, new, new, old: both timers for each call."""
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ms = cuda_ms(fns[which])
        flushed = cuda_ms_l2_flushed(fns[which])
        times[which].append({"ms": ms, "ms_l2_flushed": flushed})
        log(f"{label} {which}: ms={ms!r} ms_l2_flushed={flushed!r}")
    return times


def kernel_breakdown(label: str, fn, reps: int = 20) -> list:
    """Device time per call of every kernel fn launches, by torch.profiler
    (the gaps between them are the rest of `cuda_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": e.key[:80], "calls": e.count,
                         "device_ms_per_call": e.device_time_total / 1e3 / reps})
            log(f"{label}: {rows[-1]}")
    return rows


def check_sums(out, ref, scale, what: str) -> None:
    if not torch.equal(out[:, 0], ref[:, 0]):
        raise AssertionError(f"{what}: counts differ")
    if not bool(((out - ref).abs() <= KERNEL_RTOL * scale).all()):
        raise AssertionError(f"{what}: sums outside {KERNEL_RTOL} x the sum of |values|")


def matches(check, *args) -> bool:
    """An earlier tree's kernel is timed whether or not it matches (a
    stripped-down variant may compute less); the result says which."""
    try:
        check(*args)
    except AssertionError as e:
        log(f"does not match: {e}")
        return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path, nargs="+")
    ap.add_argument("--tune", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernels_ab: CUDA is not available")
    from trino_tpu_torch.connectors.tpch.queries import QUERIES
    from trino_tpu_torch.kernels import build
    from trino_tpu_torch.ops import grouped_sums as gs
    from trino_tpu_torch.ops import locate_sorted as ls
    from trino_tpu_torch.parallel.runner import DistributedQueryRunner

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    build.build_all(KERNELS)
    for name in KERNELS:
        log(build.log_path(name).read_text().strip())
    earlier = {}
    for parent in args.parent:
        libs = build_parent(parent)
        earlier[parent.name] = (
            parent_module(parent, "grouped_sums", libs["grouped_sums"]),
            parent_module(parent, "locate_sorted", libs["locate_sorted"]),
        )
    result = {"device": smi}

    # the grouped sums at Q1-double's batch
    n, g, k = 1 << 20, 12, 11
    gids, mask, values = chip_smoke.grouped_sums_inputs(n, g, k, 0.78, seed=n + g + k, dev=dev)
    ref = gs.grouped_sums_reference(gids, mask, values, g)
    scale = gs.grouped_sums_reference(gids, mask, values.abs(), g)
    check_sums(gs.grouped_sums(gids, mask, values, g), ref, scale, "grouped_sums")
    for name, (old_gs, _) in earlier.items():
        result[f"{name} grouped_sums matches"] = matches(
            check_sums, old_gs.grouped_sums(gids, mask, values, g), ref, scale,
            f"{name} grouped_sums")
        result[f"grouped_sums vs {name}"] = in_turns(f"grouped_sums vs {name}", {
            "old": lambda old_gs=old_gs: old_gs.grouped_sums(gids, mask, values, g),
            "new": lambda: gs.grouped_sums(gids, mask, values, g),
        })

    # the sorted probe at the mesh Q3's largest launch
    capture: dict = {}
    mesh = DistributedQueryRunner(catalog="tpch", schema="sf1", n_workers=chip_smoke.MESH_WORKERS)
    chip_smoke.capture_probe_inputs(mesh, QUERIES[3], capture)
    b, nm, p, no, cap_b = capture["inputs"]
    rs, rc = ls.locate_sorted_reference(b, nm, p, no, cap_b=cap_b)
    def check_probe(fn, label):
        s, c = fn(b, nm, p, no, cap_b=cap_b)
        if not (torch.equal(s, rs) and torch.equal(c, rc)):
            raise AssertionError(f"{label} differs from the plain version")

    check_probe(ls.locate_sorted, "locate_sorted")
    for name, (_, old_ls) in earlier.items():
        result[f"{name} locate_sorted matches"] = matches(
            check_probe, old_ls.locate_sorted, f"{name} locate_sorted")
    log(f"locate_sorted inputs: P={p.shape[0]} build={b.shape[0]} n_match={int(nm)} "
        f"live={int((~no).sum())} cap_b={cap_b}")
    for name, (_, old_ls) in earlier.items():
        result[f"locate_sorted vs {name}"] = in_turns(f"locate_sorted vs {name}", {
            "old": lambda old_ls=old_ls: old_ls.locate_sorted(b, nm, p, no, cap_b=cap_b),
            "new": lambda: ls.locate_sorted(b, nm, p, no, cap_b=cap_b),
        })
    old_gs, old_ls = next(iter(earlier.values()))

    if args.tune:
        tune = []
        result["breakdown"] = {
            "grouped_sums new": kernel_breakdown(
                "grouped_sums new", lambda: gs.grouped_sums(gids, mask, values, g)),
            "grouped_sums old": kernel_breakdown(
                "grouped_sums old", lambda: old_gs.grouped_sums(gids, mask, values, g)),
            "locate_sorted new": kernel_breakdown(
                "locate_sorted new", lambda: ls.locate_sorted(b, nm, p, no, cap_b=cap_b)),
            "locate_sorted old": kernel_breakdown(
                "locate_sorted old", lambda: old_ls.locate_sorted(b, nm, p, no, cap_b=cap_b)),
        }
        # what plain PyTorch reads and copies at this card's memory rate:
        # one pass over the grouped sums' values (46 MB), and a copy of them
        for label, fn in (("torch.sum(values)", lambda: values.sum()),
                          ("values.clone()", lambda: values.clone())):
            row = {"kernel": label, "bytes": values.numel() * 4, "ms": cuda_ms(fn),
                   "ms_l2_flushed": cuda_ms_l2_flushed(fn)}
            log(f"tune {row}")
            tune.append(row)
        # the same probe rows in a random order: neighbouring lanes no
        # longer search neighbouring keys
        perm = torch.randperm(p.shape[0], generator=torch.Generator().manual_seed(3)).to(dev)
        p_r, no_r = p[perm].contiguous(), no[perm].contiguous()
        for label, fn in (("new", ls.locate_sorted), ("old", old_ls.locate_sorted)):
            run = lambda fn=fn: fn(b, nm, p_r, no_r, cap_b=cap_b)  # noqa: E731
            row = {"kernel": f"locate_sorted {label} shuffled probe", "ms": cuda_ms(run),
                   "ms_l2_flushed": cuda_ms_l2_flushed(run)}
            log(f"tune {row}")
            tune.append(row)
        nm1 = nm.reshape(1)
        for budget in (96 * 1024, 48 * 1024):
            for per_sm in (2, 3, 4):
                plan = ls.launch_plan(cap_b, p.shape[0], sms, splitter_budget=budget,
                                      blocks_per_sm=per_sm)
                s, c = ls._launch(b, nm1, p, no, plan)
                if not (torch.equal(s, rs) and torch.equal(c, rc)):
                    raise AssertionError(f"locate_sorted plan {plan} differs")
                fn = lambda plan=plan: ls._launch(b, nm1, p, no, plan)  # noqa: E731
                row = {"kernel": "locate_sorted", "plan": plan, "ms": cuda_ms(fn),
                       "ms_l2_flushed": cuda_ms_l2_flushed(fn)}
                log(f"tune {row}")
                tune.append(row)
        for rows in (256, 512):
            for stages in (2, 3, 4):
                for per_sm in (2, 3):
                    plan = gs.launch_plan(n, g, k, sms, tile_rows=rows, stages=stages,
                                          blocks_per_sm=per_sm)
                    check_sums(gs._launch(gids, mask, values, g, plan), ref, scale,
                               f"grouped_sums plan {plan}")
                    fn = lambda plan=plan: gs._launch(gids, mask, values, g, plan)  # noqa: E731
                    row = {"kernel": "grouped_sums", "plan": plan, "ms": cuda_ms(fn),
                           "ms_l2_flushed": cuda_ms_l2_flushed(fn)}
                    log(f"tune {row}")
                    tune.append(row)
        result["tune"] = tune

    log(smi)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
