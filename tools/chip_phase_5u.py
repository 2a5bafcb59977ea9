"""Phase 5u of chip_smoke.py alone on the card: build the kernels, run the
serving probe, the memory-pressure probe and the numpy oracle's Q1 and Q6
at tpch.sf1 in this process (nothing else on the card, so its walls are
unshared), then hold K2 to its plain version at the phase's largest launch
and time it there as phase 6 does.

    PYTHONHASHSEED=0 python3 tools/chip_phase_5u.py

Its last lines are the phase's JSON (sections, sub-phase walls and
launches, K2's times) and "RUN_5U OK"."""
import json, os, shutil, subprocess, sys, tempfile, time
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
import torch
import chip_smoke as cs
from trino_tpu_torch.kernels import build

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
build.build_all(["grouped_sums", "locate_sorted"])
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
tmp = tempfile.mkdtemp(prefix="chip_phase_5u_")
t0 = time.perf_counter()
cs.probes_card_process(os.path.join(tmp, "probes.pkl"), "-")
print(f"phase 5u: {time.perf_counter() - t0!r} s", flush=True)
dev = torch.device("cuda:0")
out = cs.read_probes(os.path.join(tmp, "probes.pkl"), dev, "the card alone")
shutil.rmtree(tmp)
from trino_tpu_torch.ops import locate_sorted as ls

b, nm, p, no, cb = out["largest"]
start, count = ls.locate_sorted(b, nm, p, no, cap_b=cb)
rs, rc = ls.locate_sorted_reference(b, nm, p, no, cap_b=cb)
if not (torch.equal(start, rs) and torch.equal(count, rc)):
    raise AssertionError("locate_sorted at 5u's largest launch differs from the plain version")
k2 = cs.time_probe_inputs("probes_largest", dev, out["largest"])
k2["query"] = out["largest_query"]
print(json.dumps({"k2": k2, "phases": out["phases"], "serve": out["serve"],
                  "pressure": out["pressure"], "oracle": out["oracle"],
                  "k1_launches": out["k1_launches"], "k2_launches": out["k2_launches"]},
                 default=str), flush=True)
print("RUN_5U OK", flush=True)
