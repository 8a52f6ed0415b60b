"""The port's figures (``harness/figures.py``): every plotting function
writes a PNG from rows, the harness's own where a harness makes them
(the port's variance records on the CPU, a JSONL path as well as a list)
and suite-shaped rows otherwise. Importing the module needs no
matplotlib; these tests do."""

import dataclasses
import inspect
import json
import os

import pytest

pytest.importorskip("matplotlib")

from tuplewise_tpu_torch.harness import figures  # noqa: E402
from tuplewise_tpu_torch.harness.variance import (  # noqa: E402
    VarianceConfig, run_variance_experiment, tradeoff_vs_pairs,
    tradeoff_vs_rounds, write_jsonl,
)

CFG = VarianceConfig(n_pos=128, n_neg=128, n_reps=16, n_workers=4)


@pytest.fixture(scope="module")
def variance_rows():
    return {
        "base": run_variance_experiment(CFG, device="cpu"),
        "rounds": tradeoff_vs_rounds(
            dataclasses.replace(CFG, scheme="repartitioned"),
            rounds=(1, 4), device="cpu"),
        "pairs": tradeoff_vs_pairs(CFG, pairs=(100, 1000), device="cpu"),
        "workers": [run_variance_experiment(
            dataclasses.replace(CFG, scheme="local", n_workers=n),
            device="cpu") for n in (2, 8)],
    }


def _png(path):
    assert os.path.getsize(path) > 1000
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    return path


def _learning_row(nr, N=32, B=None, sd=1e-3, design="swr"):
    re_ = nr if nr is not None else 1 << 30
    return {"n_r": nr, "n_workers": N, "pairs_per_worker": B,
            "pair_design": design, "m_per_worker": [4, 4],
            "comm_events": 1 + 99 // re_, "eval_steps": [0, 50, 100],
            "auc_mean": [0.5, 0.7, 0.71], "auc_se": [0.0, 1e-3, 1e-3],
            "final_auc_mean": 0.71, "final_auc_se": sd / 2,
            "final_auc_sd": sd}


def test_every_plotting_function_is_covered():
    public = {n for n, f in inspect.getmembers(figures, inspect.isfunction)
              if n.startswith("plot_") and f.__module__ == figures.__name__}
    assert public == {
        "plot_variance_vs_rounds", "plot_variance_vs_workers",
        "plot_variance_vs_wallclock", "plot_variance_vs_pairs",
        "plot_learning_curve", "plot_frontier", "plot_learning_curves",
        "plot_auc_vs_comm", "plot_auc_vs_budget", "plot_sd_vs_comm",
        "plot_design_budget", "plot_triplet_curves"}


def test_variance_figures_from_harness_rows(variance_rows, tmp_path):
    rs, base = variance_rows["rounds"], variance_rows["base"]
    path = str(tmp_path / "rounds.jsonl")
    write_jsonl(rs, path)     # a JSONL path reads as the list does
    _png(figures.plot_variance_vs_rounds(
        path, str(tmp_path / "t.png"), base,
        theory=[(1, 1e-4), (4, 5e-5)]))
    _png(figures.plot_variance_vs_wallclock(rs, str(tmp_path / "w.png")))
    _png(figures.plot_variance_vs_pairs(variance_rows["pairs"],
                                        str(tmp_path / "b.png")))
    _png(figures.plot_variance_vs_workers(
        variance_rows["workers"], str(tmp_path / "n.png"), baseline=base,
        theory=[(2, 1e-4), (8, 2e-4)]))
    _png(figures.plot_frontier(
        {"complete": [base], "incomplete": variance_rows["pairs"],
         "empty": []}, str(tmp_path / "f.png")))


def test_learning_curve_of_a_history(tmp_path):
    hist = {"loss": [0.9 - 0.01 * t for t in range(40)]}
    _png(figures.plot_learning_curve(hist, str(tmp_path / "l.png"),
                                     auc_before=0.52, auc_after=0.75))


def test_learning_figures_from_suite_rows(tmp_path):
    null_se = _learning_row(5)   # one seed: no spread anywhere
    null_se.update(auc_se=[None, None, None], final_auc_se=None,
                   final_auc_sd=None)
    rows = [_learning_row(1), _learning_row(25),
            _learning_row(None, sd=3e-3), null_se]
    budget = [_learning_row(1, B=4), _learning_row(None, B=4),
              _learning_row(1), _learning_row(None)]
    designs = [_learning_row(nr, B=b, design=d)
               for nr in (1, None) for b in (4, 16)
               for d in ("swr", "swor", "bernoulli")]
    path = str(tmp_path / "rows.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    _png(figures.plot_learning_curves(path, str(tmp_path / "c.png"),
                                      title="gaussians"))
    _png(figures.plot_auc_vs_comm(rows, str(tmp_path / "a.png")))
    _png(figures.plot_sd_vs_comm(rows, str(tmp_path / "s.png")))
    _png(figures.plot_auc_vs_budget(budget, str(tmp_path / "bb.png")))
    _png(figures.plot_design_budget(designs, str(tmp_path / "d.png"),
                                    title="designs"))


def test_triplet_curves(tmp_path):
    rows = [{"task": task, "n_r": nr, "steps": 200,
             "acc_init_mean": 0.5, "acc_curve_mean": [0.55, 0.6, 0.62]}
            for task in ("gauss-overlap", "mnist") for nr in (1, None)]
    _png(figures.plot_triplet_curves(rows, str(tmp_path / "tr.png"),
                                     title="config 4"))
