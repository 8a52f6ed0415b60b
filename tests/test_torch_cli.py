"""The port's CLI (``harness/cli.py``, ``tuplewise-torch``) against the
JAX package's, every subcommand in-process on ``--device cpu``.

Results on data made with numpy (the host oracles' estimates, the
replays, the serve loop's answers, a scorer's AUC before training) are
held exactly; results drawn by torch's generators are held statistically,
as tests/test_torch_harness.py does: means within 4 standard errors of
their difference, variance ratios in the two-sided 1e-4 band of the F
distribution. The three SIGKILL-and-resume scenarios of
tests/test_preemption.py run through ``python -m
tuplewise_tpu_torch.harness.cli`` (the killed run is the one subprocess;
the resumed run must equal the uninterrupted one bit for bit). Without a
card and without ``--device`` the CLI exits non-zero."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
from scipy import stats

from tuplewise_tpu.harness.cli import main as jax_cli
from tuplewise_tpu_torch.harness.cli import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(main, argv, stdin=None):
    buf = io.StringIO()
    old = sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        sys.stdin = old
    assert rc == 0
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def run(argv, stdin=None):
    """The port's CLI on the CPU: its JSON lines."""
    return _lines(cli, argv + ["--device", "cpu"], stdin)


def run_jax(argv, stdin=None):
    return _lines(jax_cli, argv, stdin)


def _f_band(m1, m2, p=1e-4):
    return (stats.f.ppf(p / 2, m1 - 1, m2 - 1),
            stats.f.ppf(1 - p / 2, m1 - 1, m2 - 1))


def _same_statistic(r, j):
    gap = abs(r["mean"] - j["mean"])
    assert gap < 4 * np.hypot(r["std_error"], j["std_error"]), gap
    lo, hi = _f_band(r["n_reps"], j["n_reps"])
    assert lo < r["variance"] / j["variance"] < hi


class TestEstimatorCommands:
    @pytest.mark.parametrize("scheme", ["complete", "local",
                                        "repartitioned", "incomplete"])
    def test_variance_statistically_equals_the_reference(self, scheme):
        argv = ["variance", "--scheme", scheme, "--n-pos", "300",
                "--n-neg", "300", "--n-workers", "4", "--n-rounds", "3",
                "--n-pairs", "2000", "--n-reps", "64", "--seed", "5"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert r["config"] == dict(j["config"], backend="torch")
        assert r["device"] == "cpu" and r["batched"]
        _same_statistic(r, j)
        assert r["population_value"] == j["population_value"]

    @pytest.mark.parametrize("backend", ["numpy", "cpp"])
    def test_host_oracle_variance_equals_the_reference(self, backend):
        argv = ["variance", "--backend", backend, "--scheme", "local",
                "--n-pos", "80", "--n-neg", "60", "--n-workers", "4",
                "--n-reps", "6", "--seed", "2"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert (r["mean"], r["variance"]) == (j["mean"], j["variance"])
        assert r["config"] == j["config"] and not r["batched"]

    def test_tradeoff_commands_equal_the_reference_on_numpy(self):
        base = ["--backend", "numpy", "--n-pos", "60", "--n-neg", "50",
                "--n-reps", "4", "--seed", "1"]
        for argv in (["tradeoff-rounds", "--scheme", "repartitioned",
                      "--n-workers", "2", "--rounds", "1", "3"],
                     ["tradeoff-pairs", "--scheme", "incomplete",
                      "--pairs", "50", "400"],
                     ["tradeoff-workers", "--scheme", "local",
                      "--workers", "2", "5"]):
            rows, jrows = run(argv + base), run_jax(argv + base)
            assert len(rows) == len(jrows) == 2
            for r, j in zip(rows, jrows):
                assert r["config"] == j["config"]
                assert (r["mean"], r["variance"]) == (j["mean"],
                                                      j["variance"])

    def test_tradeoff_rounds_on_torch(self):
        argv = ["tradeoff-rounds", "--scheme", "repartitioned", "--n-pos",
                "200", "--n-neg", "200", "--n-workers", "4", "--n-reps",
                "32", "--rounds", "1", "4"]
        rows, jrows = run(argv), run_jax(argv)
        assert [r["config"]["n_rounds"] for r in rows] == [1, 4]
        for r, j in zip(rows, jrows):
            _same_statistic(r, j)
        # repartitioning buys variance
        assert rows[1]["closed_form_variance"] < rows[0][
            "closed_form_variance"]

    def test_triplet_numpy_equals_and_torch_agrees(self):
        argv = ["triplet", "--n", "120", "--n-pairs", "3000",
                "--seed", "4"]
        (r,), (j,) = (run(argv + ["--backend", "numpy"]),
                      run_jax(argv + ["--backend", "numpy"]))
        assert r["per_class"] == j["per_class"]
        assert r["mean"] == j["mean"]
        (t,) = run(argv)
        assert t["backend"] == "torch"
        assert abs(t["mean"] - j["mean"]) < 0.05

    def test_triplet_n_pairs_zero_is_the_complete_statistic(self):
        from tuplewise_tpu.harness.triplet_experiment import (
            triplet_mnist_statistic as jax_triplet,
        )

        (r,) = run(["triplet", "--n", "120", "--n-pairs", "0",
                    "--backend", "numpy"])
        want = jax_triplet(n=120, n_pairs=None, backend="numpy")
        assert r["n_pairs"] is None
        assert r["per_class"] == {str(k): v
                                  for k, v in want["per_class"].items()}
        (t,) = run(["triplet", "--n", "120", "--n-pairs", "0"])
        for k, v in r["per_class"].items():
            assert t["per_class"][k] == pytest.approx(v, rel=1e-6)


class TestLearnerCommands:
    def test_train_equals_the_reference_where_numpy_made_it(self):
        argv = ["train", "--dataset", "gaussians", "--n", "512",
                "--steps", "30", "--n-workers", "2"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert r["config"] == j["config"] and r["data_meta"] == \
            j["data_meta"]
        # the data and the initial scorer are numpy's: the AUCs before
        # training are the same float32 rank AUCs
        assert r["auc_train_before"] == j["auc_train_before"]
        assert r["auc_test_before"] == j["auc_test_before"]
        # the sampled steps differ; the learned scorer agrees
        assert abs(r["auc_test"] - j["auc_test"]) < 0.03
        assert r["auc_test"] > r["auc_test_before"] + 0.1
        assert r["recovery"]["resumed_from"] == 0
        assert len(r["params_sha256"]) == 64

    def test_train_adult_surrogate_and_obs_flags(self, tmp_path):
        trace, metrics = tmp_path / "t.jsonl", tmp_path / "m.jsonl"
        (r,) = run(["train", "--n", "600", "--steps", "6",
                    "--loss-every", "0", "--pairs-per-worker", "512",
                    "--pair-design", "swor", "--trace-out", str(trace),
                    "--metrics-out", str(metrics)])
        assert r["data_meta"]["source"].startswith("surrogate")
        assert r["loss_last"] is None or np.isfinite(r["loss_last"])
        assert trace.exists() and metrics.exists()
        spans = [json.loads(x) for x in trace.read_text().splitlines()]
        assert any(s.get("name") == "train.chunk" for s in spans)

    def test_learning_statistically_equals_the_reference(self):
        argv = ["learning", "--n", "256", "--n-test", "512", "--steps",
                "20", "--n-workers", "4", "--n-seeds", "4",
                "--eval-every", "10", "--repartition-every", "0"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert r["eval_steps"] == j["eval_steps"]
        assert r["n_r"] is None and r["comm_events"] == j["comm_events"]
        gap = abs(r["final_auc_mean"] - j["final_auc_mean"])
        assert gap < 4 * np.hypot(r["final_auc_se"], j["final_auc_se"]), gap

    def test_train_triplet_agrees_with_the_reference(self):
        argv = ["train-triplet", "--n", "128", "--dim", "4",
                "--embed-dim", "3", "--steps", "20", "--n-workers", "2",
                "--triplets-per-worker", "256"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert r["config"] == j["config"]
        assert abs(r["triplet_acc"] - j["triplet_acc"]) < 0.06
        assert r["loss_last"] < r["loss_first"]


SERVE_LINES = "\n".join(json.dumps(x) for x in [
    {"op": "insert", "score": 1.2, "label": 1},
    {"op": "insert", "score": [0.3, -0.5, 0.9], "label": [0, 0, 1]},
    {"op": "score", "score": [0.0, 1.0]},
    {"op": "query"},
    {"op": "bogus"},
    {"op": "insert", "score": float("nan"), "label": 1},
    {"op": "insert", "score": 0.1},
]) + "\nnot json\n"

FLEET_LINES = "\n".join(json.dumps(x) for x in [
    {"op": "insert", "tenant": "a", "score": [1.0, 0.2], "label": [1, 0]},
    {"op": "insert", "tenant": "b", "score": [0.4, 0.5, 0.1],
     "label": [1, 0, 0]},
    {"op": "score", "tenant": "a", "score": [0.5]},
    {"op": "query", "tenant": "b"},
    {"op": "insert", "tenant": "c", "score": 0.0, "label": 1},
]) + "\n"


def _answers(lines, keys=("ok", "inserted", "rank", "auc_exact",
                          "tenant", "retry_after_s")):
    return [{k: x[k] for k in keys if k in x} for x in lines]


class TestServingCommands:
    def test_replay_equals_the_reference(self):
        argv = ["replay", "--n-events", "1500", "--chunk", "8",
                "--compact-every", "128", "--policy", "block",
                "--window", "900"]
        (r,), (j,) = run(argv), run_jax(argv)
        assert set(j) <= set(r)
        assert r["events_applied"] == j["events_applied"] == 1500
        assert r["auc_exact"] == j["auc_exact"]
        assert r["auc_abs_err"] == 0.0

    def test_replay_fleet_with_controller_equals_the_reference(self):
        argv = ["replay", "--tenants", "6", "--n-events", "1200",
                "--policy", "block", "--tenant-quota", "4096",
                "--slo-spec", json.dumps({"objectives": [
                    {"name": "sat", "type": "saturation",
                     "metric": "queue_depth_live",
                     "capacity": "queue_size", "max_fraction": 0.8}]}),
                "--controller-spec", json.dumps({"knobs": ["flush"]})]
        (r,), (j,) = run(argv), run_jax(argv)
        assert set(j) <= set(r)
        assert r["events_applied"] == j["events_applied"] == 1200
        assert r["tenant_auc_max_abs_err"] == 0.0
        assert r["controller"]["knobs"].keys() == \
            j["controller"]["knobs"].keys() == {"flush"}

    @pytest.mark.parametrize("fleet", [False, True])
    def test_serve_answers_equal_the_reference(self, fleet, capsys):
        argv = ["serve", "--max-batch", "4", "--flush-timeout-ms", "0.5"]
        if fleet:
            argv += ["--max-tenants", "2", "--slo-spec", json.dumps(
                {"objectives": [{"name": "c", "type": "counter_max",
                                 "metric": "rejected_total", "max": 0}]}),
                "--controller-spec", "{}"]
        stdin = FLEET_LINES if fleet else SERVE_LINES
        got, want = run(argv, stdin), run_jax(argv, stdin)
        assert _answers(got) == _answers(want)
        assert [("error" in x) for x in got] == [("error" in x)
                                                 for x in want]
        err = capsys.readouterr().err.strip().splitlines()
        summary = json.loads(err[-2])["exit_summary"]
        assert "rejected_total" in summary
        assert ("tenancy" in summary) == fleet
        assert ("controller" in summary) == fleet
        assert ("slo" in summary) == fleet


class TestDeviceAndEntry:
    def test_no_card_and_no_device_exits_nonzero(self, capsys):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        for argv in (["variance", "--n-reps", "2"], ["doctor", "--dir", "."],
                     ["replay", "--n-events", "10"]):
            assert cli(argv) == 2
            assert "--device cpu" in capsys.readouterr().err

    def test_module_entry_point_and_script(self):
        import torch

        p = subprocess.run(
            [sys.executable, "-m", "tuplewise_tpu_torch.harness.cli",
             "variance", "--n-reps", "2"], cwd=REPO, capture_output=True,
            text=True, timeout=120)
        if torch.cuda.is_available():
            assert p.returncode == 0
        else:
            assert p.returncode == 2 and p.stdout == ""
            assert "no CUDA device" in p.stderr
        with open(os.path.join(REPO, "pyproject.toml")) as f:
            assert ('tuplewise-torch = "tuplewise_tpu_torch.harness.cli:'
                    'main"') in f.read()


# --------------------------------------------------------------------- #
# SIGKILL mid-run, then --resume                                         #
# --------------------------------------------------------------------- #

_KILL_AFTER_2ND_CHECKPOINT = json.dumps({"faults": [
    {"point": "checkpoint", "on_call": 2, "action": "sigkill"}]})

_SCENARIOS = [
    pytest.param(
        ["train", "--dataset", "gaussians", "--n", "256", "--steps",
         "8", "--n-workers", "2"],
        ["params_sha256", "auc_test", "loss_last"], id="pairwise-sgd"),
    pytest.param(
        ["train-triplet", "--n", "128", "--dim", "4", "--embed-dim",
         "3", "--steps", "8", "--n-workers", "2",
         "--triplets-per-worker", "128"],
        ["params_sha256", "triplet_acc", "loss_last"],
        id="triplet-sgd"),
    pytest.param(
        ["variance", "--backend", "mesh", "--scheme", "local",
         "--n-pos", "128", "--n-neg", "128", "--n-workers", "2",
         "--n-reps", "6", "--seed", "3"],
        ["mean", "variance"], id="mesh-mc"),
]


class TestSigkillResume:
    @pytest.mark.parametrize("args,fields", _SCENARIOS)
    def test_sigkill_mid_run_resume_bit_identical(self, args, fields,
                                                  tmp_path):
        """A chaos schedule SIGKILLs the CLI process right after its 2nd
        checkpoint lands (more work remained); rerunning with --resume
        completes the job, bit for bit the uninterrupted run."""
        ck = str(tmp_path / "ck.npz")
        (ref,) = run(list(args))
        p = subprocess.run(
            [sys.executable, "-m", "tuplewise_tpu_torch.harness.cli"]
            + args + ["--device", "cpu", "--checkpoint", ck,
                      "--checkpoint-every", "2", "--chaos-spec",
                      _KILL_AFTER_2ND_CHECKPOINT],
            capture_output=True, text=True, cwd=REPO, timeout=240)
        assert p.returncode == -signal.SIGKILL, (p.returncode,
                                                 p.stderr[-2000:])
        assert p.stdout == "" and os.path.exists(ck)
        (res,) = run(args + ["--checkpoint", ck, "--checkpoint-every",
                             "2", "--resume"])
        for f in fields:
            assert res[f] == ref[f], (f, res[f], ref[f])
        assert res["recovery"]["resumed_from"] > 0

    def test_without_resume_flag_starts_fresh(self, tmp_path):
        ck = str(tmp_path / "ck.npz")
        args = ["train", "--dataset", "gaussians", "--n", "256",
                "--steps", "6", "--n-workers", "2", "--checkpoint", ck,
                "--checkpoint-every", "2"]
        run(list(args))                                  # leaves ck
        (res,) = run(list(args))                         # no --resume
        assert res["recovery"]["resumed_from"] == 0
        (res,) = run(list(args) + ["--resume"])
        assert res["recovery"]["resumed_from"] == 6
