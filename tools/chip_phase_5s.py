"""Phase 5s of chip_smoke.py alone on the card: build the kernels, run the
phase at tpch.sf1, hold K1 and K2 to their plain versions at the phase's
largest launches and time them there.

    PYTHONHASHSEED=0 python3 tools/chip_phase_5s.py

Its last lines are the kernels' JSON and "RUN_5S OK"."""
import json, os, sys, time
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
import subprocess
import torch
import chip_smoke as cs
from trino_tpu_torch.kernels import build
from trino_tpu_torch.ops import locate_sorted as ls

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
build.build_all(["grouped_sums", "locate_sorted"])
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
k1c, k2c = {}, {}
t0 = time.perf_counter()
out = cs.run_orc_path(k1c, k2c)
print(f"phase 5s: {time.perf_counter() - t0!r} s", flush=True)
dev = torch.device("cuda")
k1 = cs.check_grouped_sums_captured(dev, k1c, "orc")
b, nm, p, no, cb = k2c["largest"]
start, count = ls.locate_sorted(b, nm, p, no, cap_b=cb)
torch.cuda.synchronize()
rs, rc = ls.locate_sorted_reference(b, nm, p, no, cap_b=cb)
assert torch.equal(start, rs) and torch.equal(count, rc), "K2 differs from its plain version"
k2 = cs.time_probe_inputs("orc_largest", dev, k2c["largest"])
print(json.dumps({"k1": k1, "k2": k2, "k1_launches": out["k1_launches"],
                  "k2_launches": out["k2_launches"]}, default=str), flush=True)
print("RUN_5S OK", flush=True)
