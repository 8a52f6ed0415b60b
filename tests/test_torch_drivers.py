"""The port's experiment drivers (scripts_torch/) as a set: they stay out
of the JAX package's static-analysis gate, write nowhere but the results
directory they are given, and refuse to run without a card unless
--device names another device."""

import contextlib
import fnmatch
import importlib.util
import io
import os

import pytest
import torch

from tuplewise_tpu.analysis.core import DEFAULT_GLOBS, ModuleSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("config_suite", "learning_suite", "northstar", "stat_check")
# the acceptance smokes and mesh8_cpu follow the drivers' rules; perf_gate
# touches no device, so it only shares the default results directory
SMOKES = ("chaos_smoke", "controller_smoke", "mesh8_cpu", "multitenant_smoke",
          "obs_smoke", "preemption_smoke", "streaming_smoke")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"drivers_{name}", os.path.join(ROOT, "scripts_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_gate_never_scans_the_drivers():
    ms = ModuleSet.from_repo(ROOT)
    assert ms.modules, "the gate scanned nothing"
    assert not [p for p in ms.modules if p.startswith("scripts_torch/")]
    assert any(p.startswith("scripts/") for p in ms.modules)
    # why the drivers are not under scripts/: fnmatch's * crosses "/"
    assert fnmatch.fnmatch("scripts/torch/northstar.py", "scripts/*.py")
    assert not any(fnmatch.fnmatch("scripts_torch/northstar.py", g)
                   for g in DEFAULT_GLOBS)


@pytest.mark.parametrize("name", DRIVERS + SMOKES)
def test_without_a_card_each_driver_exits_2(name, tmp_path, monkeypatch):
    mod = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        with pytest.raises(SystemExit) as e:
            mod.main([], results=str(tmp_path))
    assert e.value.code == 2 and "--device cpu" in err.getvalue()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", DRIVERS + SMOKES + ("perf_gate",))
def test_default_results_directory_is_results_torch(name):
    assert _load(name).RESULTS == os.path.join(ROOT, "results", "torch")


def test_trace_summary_cli(tmp_path, capsys):
    ts = _load("trace_summary")
    assert ts.main([]) == 2
    spans = os.path.join(ROOT, "tests", "data", "trace_summary_spans.jsonl")
    assert ts.main([spans, "3"]) == 0
    assert capsys.readouterr().out.startswith(f"trace: {spans}")


def test_device_memory_stats_without_a_card(monkeypatch):
    from tuplewise_tpu_torch.utils.profiling import device_memory_stats

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}


def test_card_stamp_only_on_the_card():
    from tuplewise_tpu_torch.harness.drivers import card_of, platform_of

    assert card_of(torch.device("cpu")) is None
    assert platform_of("cpu") == "cpu" and platform_of("cuda:0") == "cuda"


@pytest.mark.parametrize("masked", [False, True])
def test_batches_past_the_grid_split_into_counted_launches(masked,
                                                           monkeypatch):
    """The trade-off stage's local rounds (N = 12500 workers, 8 reps a
    chunk: 100000 problems of 40 x 40) pass the 65535 problems the grid's
    problem axis holds: the wrapper launches runs of at most that many,
    in order, each counted. Launchers stubbed so that it runs here; the
    limit lowered to 3."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops import rank_count
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    shapes = []

    def auc(a, b):
        shapes.append(tuple(a.shape))
        return a[:, 0].to(torch.int64) * 2

    def masked_sums(a, b, ma, mb, hinge):
        shapes.append(tuple(a.shape))
        return (a[:, 0] * ma[:, 0]).to(torch.float64)

    monkeypatch.setattr(rank_count, "auc_twice_counts", auc)
    monkeypatch.setattr(rank_count, "masked_pair_sums", masked_sums)
    monkeypatch.setattr(pk, "_MAX_GRID_YZ", 3)
    a = torch.arange(8, dtype=torch.float32)[:, None].expand(8, 5).contiguous()
    b = torch.zeros(8, 4)
    masks = (torch.ones_like(a), torch.ones_like(b)) if masked else (None,
                                                                     None)
    name = "masked_pair_sum" if masked else "pair_sum"
    pk.reset_launch_counts()
    out = pk._launch(name, a, b, *masks, get_kernel("auc"))
    assert out.tolist() == list(map(float, range(8)))
    assert shapes == [(3, 5), (3, 5), (2, 5)]
    assert pk.LAUNCHES[f"{name}[auc]"] == 3
    pk.reset_launch_counts()
