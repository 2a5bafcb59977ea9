"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` compiles at first use with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface, loaded with ctypes.  Libraries land in
`build/trino_tpu_torch/` at the repository root (listed in .gitignore),
named by a hash of their source so an edited kernel never loads a stale
build.  `build_all` starts one nvcc per source at once and waits for all.
Each nvcc run and each library load is a compile event
(telemetry/compile_events, step `kernel:<name>`) with its seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "trino_tpu_torch"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas register/shared-memory report) of the
    last build of `name`."""
    return library_path(name).with_suffix(".log")


def build_all(names) -> None:
    """Compile every listed kernel that has no current build, one nvcc
    process per source, all started together."""
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        # each process writes its own log, renamed into place with the
        # library: processes building at once never share a log file
        tmp_log = tmp.with_suffix(f".log{os.getpid()}")
        log = open(tmp_log, "wb")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append(
            (name, lib, tmp, tmp_log, log,
             subprocess.Popen(cmd, stdout=log, stderr=log))
        )
    failed = []
    for name, lib, tmp, tmp_log, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{tmp_log.read_text()}")
            continue
        os.replace(tmp_log, log_path(name))
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
        # the seconds from the common start to this build's end
        OBSERVATORY.record_kernel(name, time.perf_counter() - t0, "nvcc")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built on first use."""
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
            OBSERVATORY.record_kernel(name, time.perf_counter() - t0, "load")
        return lib


def unload_all() -> list:
    """Forget every loaded library, so each kernel's next launch loads it
    again (and books a load event); returns the names forgotten.  A cold
    start inside a running process: the library stays mapped, and the
    reload is the `dlopen` of an already-open file."""
    with _LOCK:
        names = sorted(_LOADED)
        _LOADED.clear()
    return names
