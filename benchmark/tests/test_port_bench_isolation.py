"""The benchmark measures the port alone: nothing under ``benchmark/``
imports JAX or the JAX package, the references import nothing of the
port, and ``run.py`` prints no result without a card, without the port,
or with JAX loaded."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tuplewise_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "tuplewise_tpu_torch" not in tops


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m "
                          "in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_jobs_load_no_jax():
    tops = _loaded("import benchmark.run, benchmark.control, "
                   "benchmark.jobs.mesh_mc, benchmark.jobs.pairwise_sgd\n"
                   "benchmark.run.import_port()\n"
                   "import tuplewise_tpu_torch.harness.mesh_mc, "
                   "tuplewise_tpu_torch.models.pairwise_sgd")
    assert "tuplewise_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_references_load_nothing_of_the_port():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (BENCH / "reference").rglob("*.py")
                  if p.name != "__init__.py")
    tops = _loaded("import " + ", ".join(mods))
    assert not tops & (FORBIDDEN | {"tuplewise_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tuplewise_tpu_torch_extra", None)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert run.forbidden_modules() == ["jax"]


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "auc_gauss_1e7_w8.complete", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result_and_a_nonzero_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_port_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import run\n"
            "run.run_cell('auc_gauss_1e7_w8.complete', 1, 0.1, False, "
            "device='cpu', overrides={'n_pos': 800, 'n_neg': 800})\n"
            "print('{}')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "tuplewise_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = _cli(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"reps_per_s", "setup_s"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
