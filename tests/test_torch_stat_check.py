"""scripts_torch/stat_check.py against the JAX package's
scripts/stat_check.py.

Both make their Gaussians with numpy and take the zetas in float64, so
over the committed results/ the port's audit must reproduce the
reference's report: the same rows, each z within 1e-9, the same worst
|z| and verdict. Neither writes into results/: the reports go to
tmp_path.
"""

import contextlib
import importlib.util
import io
import json
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "results")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def modules():
    return (_load("scripts/stat_check.py", "ref_stat_check"),
            _load("scripts_torch/stat_check.py", "port_stat_check"))


@pytest.fixture(scope="module")
def reports(modules, tmp_path_factory):
    ref, port = modules
    d = tmp_path_factory.mktemp("stat_check")
    with contextlib.redirect_stdout(io.StringIO()):
        rc_ref = ref.main(out=str(d / "ref.txt"))
        rc_port = port.main(["--device", "cpu"], results=COMMITTED,
                            out=str(d / "port.txt"))
    return ((d / "ref.txt").read_text(), rc_ref,
            (d / "port.txt").read_text(), rc_port)


def test_report_over_committed_results_equals_the_reference(reports):
    ref_text, rc_ref, port_text, rc_port = reports
    assert port_text == ref_text
    assert rc_port == rc_ref == 0
    assert port_text.splitlines()[0].endswith("PASS")


def _ref_z(ref, r):
    """The reference's (z_mean, z_var) of a committed row, from its own
    target functions; None for a row outside its audit."""
    cfg, M = r.get("config"), r.get("n_reps")
    if (not isinstance(cfg, dict) or not M or M < 8
            or "scheme" not in cfg or "separation" not in cfg):
        return None
    pair = cfg.get("kernel") == "auc" and cfg.get("dim") == 1
    tri = cfg.get("kernel") == "triplet_indicator" and cfg.get("fix_data")
    if not (pair or tri):
        return None
    if cfg.get("fix_data"):
        targets = ref.fixed_row_targets(cfg, r)
        if targets is None:
            return None
        pop, pred, _ = targets
    else:
        pop = ref.true_gaussian_auc(cfg["separation"])
        try:
            pred = ref.predicted_variance(cfg)
        except (ValueError, ZeroDivisionError):
            pred = None
    z_mean = ((r["mean"] - pop) / math.sqrt(r["variance"] / M)
              if pop is not None else math.nan)
    z_var = ((r["variance"] - pred) / (pred * math.sqrt(2.0 / (M - 1)))
             if pred is not None and pred > 0 else math.nan)
    return z_mean, z_var


def test_each_z_within_1e_9_of_the_reference(modules, reports):
    ref, port = modules
    n = 0
    for name in sorted(os.listdir(COMMITTED)):
        if not name.endswith(".jsonl") or port.is_quick(name):
            continue
        with open(os.path.join(COMMITTED, name)) as f:
            for line in f:
                r = json.loads(line)
                want = _ref_z(ref, r)
                got = port.audit_row(name, r, torch.device("cpu"))
                assert (want is None) == (got is None), (name, r)
                if want is None:
                    continue
                n += 1
                for w, g in zip(want, got[1:]):
                    assert math.isnan(w) == math.isnan(g)
                    if not math.isnan(w):
                        assert abs(w - g) <= 1e-9, (name, w, g)
    assert n == 82


def _harness_row(tmp_path, platform, **kw):
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, run_variance_experiment,
    )

    cfg = VarianceConfig(scheme="incomplete", n_pos=40, n_neg=40,
                         n_pairs=800, n_workers=2, n_reps=64,
                         fix_data=True, seed=4, **kw)
    r = run_variance_experiment(cfg, device="cpu")
    return {"config": r["config"], "platform": platform, "mean": r["mean"],
            "variance": r["variance"], "n_reps": r["n_reps"]}


def test_port_fix_data_rows_regenerate_on_their_platform(modules, tmp_path):
    """A port row stamped with this audit's device is regenerated and held
    to its exact conditional form ([cond], with a mean target); a row of
    another platform is audited as it is."""
    _, port = modules
    rows = [_harness_row(tmp_path, p) for p in ("cpu", "cuda")]
    with open(tmp_path / "designs_conditional.jsonl", "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    with open(tmp_path / "junk_quick.jsonl", "w") as f:
        f.write(json.dumps(dict(rows[0], variance=1.0)) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = port.main(["--device", "cpu"], results=str(tmp_path))
    lines = (tmp_path / "stat_check.txt").read_text().splitlines()
    assert rc == 0 and lines[0].endswith("PASS") and "(2 rows)" in lines[0]
    assert "[cond] " in lines[2] and "z_mean=" in lines[2]
    assert "[as-is]" in lines[3] and "(no mean target)" in lines[3]


def test_a_row_past_the_limit_fails(modules, tmp_path):
    _, port = modules
    row = _harness_row(tmp_path, "cpu")
    row["variance"] *= 50
    with open(tmp_path / "designs_conditional.jsonl", "w") as f:
        f.write(json.dumps(row) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = port.main(["--device", "cpu"], results=str(tmp_path))
    assert rc == 1
    assert (tmp_path / "stat_check.txt").read_text().splitlines()[
        0].endswith("FAIL")
