"""The port stands alone: no module of trino_tpu_torch, and not chip_smoke.py,
imports jax or anything of the JAX package (importing any trino_tpu module
imports jax), and its entry points never fall back to the CPU silently."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "trino_tpu")


def _sources():
    files = sorted((ROOT / "trino_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_sources_exist():
    files = _sources()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 40
    tpcds = ROOT / "trino_tpu_torch" / "connectors" / "tpcds"
    for name in ("__init__", "schema", "generator", "connector", "queries"):
        assert tpcds / f"{name}.py" in files


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_runner_without_device_needs_cuda():
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    if torch.cuda.is_available():
        assert LocalQueryRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalQueryRunner()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalQueryRunner(device="cuda")
    assert LocalQueryRunner(device="cpu").device == torch.device("cpu")


def test_tpcds_runners_without_device_need_cuda():
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    if torch.cuda.is_available():
        assert LocalQueryRunner(catalog="tpcds", schema="tiny").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalQueryRunner(catalog="tpcds", schema="tiny")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistributedQueryRunner(catalog="tpcds", schema="tiny", n_workers=4)
    r = LocalQueryRunner(catalog="tpcds", schema="tiny", device="cpu")
    assert r.execute("select count(*) from store").rows == [(2,)]


def test_mesh_runner_without_device_needs_cuda():
    from trino_tpu_torch.parallel import DistributedQueryRunner
    from trino_tpu_torch.parallel.spmd import WorkerMesh

    if torch.cuda.is_available():
        assert DistributedQueryRunner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistributedQueryRunner()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WorkerMesh(4)
    r = DistributedQueryRunner(n_workers=4, device="cpu")
    assert r.wm.device == torch.device("cpu") and r.wm.n == 4
    with pytest.raises(NotImplementedError, match="multi-card mesh"):
        WorkerMesh(2, ["cuda:0", "cuda:1"])


def test_resolve_device_rejects_other_devices():
    from trino_tpu_torch.device import resolve_device

    with pytest.raises(ValueError):
        resolve_device("meta")
