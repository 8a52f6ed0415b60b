"""The port stands alone: no module of tuplewise_tpu_torch, no driver in
scripts_torch/ and nothing in chip_smoke.py imports jax or the JAX
package, and the entry points do not fall back to the CPU where there is
no card."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tuplewise_tpu")


def _sources():
    files = sorted((ROOT / "tuplewise_tpu_torch").rglob("*.py"))
    drivers = sorted((ROOT / "scripts_torch").glob("*.py"))
    return files + drivers + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    files = _sources()
    assert len(files) > 15 and all(f.exists() for f in files)
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_estimator_without_device_raises_where_cuda_is_absent(monkeypatch):
    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, run_variance_experiment,
    )

    from tuplewise_tpu_torch import (
        ExactAucIndex, MicroBatchEngine, MultiTenantEngine, TenantFleetIndex,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator("auc", backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_variance_experiment(VarianceConfig(n_pos=10, n_neg=10,
                                               n_reps=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        ExactAucIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        MicroBatchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantFleetIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiTenantEngine()
    assert Estimator("auc", device="cpu").backend.device.type == "cpu"
    assert ExactAucIndex(device="cpu").device.type == "cpu"
    assert TenantFleetIndex(device="cpu").device.type == "cpu"
