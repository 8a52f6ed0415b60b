"""Statistical audit of the port's result rows (the counterpart of the
JAX package's ``scripts/stat_check.py``).

Reads every ``<results>/*.jsonl`` variance-harness row and checks, per
row:

  * mean vs the population AUC (z = (mean - pop) / SE(mean)), and
  * variance vs its Hoeffding closed form
    (z = (var - pred) / SE(var), SE(var) ~ var * sqrt(2/(M-1)) for
    near-Gaussian estimator distributions),

with plug-in zetas from a 20k-per-class sample (the port's
``estimators/variance``; float64 on the CPU). ``*_quick.jsonl`` siblings
are left out. Writes ``<results>/stat_check.txt`` and exits nonzero if
any |z| > 4.

fix_data incomplete rows of the port (``"backend": "torch"``) whose
``platform`` stamp is the device this audit runs on are regenerated
(``harness.variance.fixed_dataset``) and held against their EXACT
conditional forms; rows of another platform, and the JAX package's rows,
are audited as they are (the design form from the row's own mean, no
mean target).

Usage: python scripts_torch/stat_check.py [--device cpu]
(``--device``: the device whose fix_data rows are regenerated; default
the card). ``main(argv, results=..., out=...)`` runs it in-process.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.data import (  # noqa: E402
    make_gaussians, true_gaussian_auc,
)
from tuplewise_tpu_torch.estimators.variance import (  # noqa: E402
    conditional_incomplete_variance,
    incomplete_variance_from_zetas,
    local_variance_from_zetas,
    repartitioned_variance_from_zetas,
    two_sample_variance_from_zetas,
    two_sample_zetas,
)
from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    driver_device, platform_of,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402
from tuplewise_tpu_torch.utils.results_io import is_quick  # noqa: E402

Z_LIMIT = 4.0
_ZETAS = {}
_FIXED = {}


def fixed_row_targets(cfg: dict, row: dict, device):
    """(population mean or None, conditional variance, regenerated?) for
    a fix_data=True incomplete row, or None when the row is outside the
    audit.

    A port row (backend "torch") stamped with this audit's platform is
    regenerated on ``device`` bit for bit, its complete U computed
    exactly (the O(n log n) midrank AUC; the numpy oracle's full triplet
    reduction for degree 3), and the conditional design form follows from
    s^2 = U(1-U) with no plug-in. Any other row (another platform, the
    JAX package's rows) is audited as it is: the design form from the
    row's own mean, and no mean target. Grid size G is n1*n2 for pairs
    and n1(n1-1)n2 for triplets."""
    if cfg.get("scheme") != "incomplete" or cfg.get("backend") not in (
            "jax", "torch"):
        return None
    is_pair = cfg.get("kernel") == "auc" and cfg.get("dim") == 1
    is_triplet = cfg.get("kernel") == "triplet_indicator"
    if not (is_pair or is_triplet):
        return None
    n1, n2 = cfg["n_pos"], cfg["n_neg"]
    grid = n1 * (n1 - 1) * n2 if is_triplet else n1 * n2
    regen = (cfg["backend"] == "torch"
             and row.get("platform") == platform_of(device))
    if regen:
        key = (cfg["kernel"], cfg["seed"], n1, n2, cfg.get("dim"),
               cfg["separation"])
        if key not in _FIXED:
            from tuplewise_tpu_torch.harness.variance import (
                VarianceConfig, fixed_dataset,
            )

            A, B = fixed_dataset(VarianceConfig(**cfg), device)
            if is_pair:
                from tuplewise_tpu_torch.models.metrics import auc_score

                _FIXED[key] = auc_score(A, B)
            else:
                from tuplewise_tpu_torch.estimators.estimator import (
                    Estimator,
                )

                _FIXED[key] = Estimator(
                    cfg["kernel"], backend="numpy"
                ).complete(A, B)
        u = _FIXED[key]
    else:
        u = row["mean"]
    pred = conditional_incomplete_variance(
        u * (1.0 - u), grid,
        n_pairs=cfg["n_pairs"], design=cfg.get("design", "swr"),
    )
    return (u if regen else None), pred, regen


def zetas(kernel: str, separation: float):
    key = (kernel, separation)
    if key not in _ZETAS:
        X, Y = make_gaussians(20_000, 20_000, 1, separation, seed=7)
        _ZETAS[key] = two_sample_zetas(kernel, X[:, 0], Y[:, 0])
    return _ZETAS[key]


def predicted_variance(cfg: dict) -> float | None:
    """Closed-form Var for a harness row, or None if no formula applies
    (feature kernels, non-Gaussian data paths)."""
    if cfg["kernel"] != "auc" or cfg["dim"] != 1:
        return None
    z = zetas(cfg["kernel"], cfg["separation"])
    n1, n2, N = cfg["n_pos"], cfg["n_neg"], cfg["n_workers"]
    if cfg["scheme"] == "complete":
        return two_sample_variance_from_zetas(z, n1, n2)
    if cfg["scheme"] == "local":
        return local_variance_from_zetas(z, n1, n2, n_workers=N)
    if cfg["scheme"] == "repartitioned":
        return repartitioned_variance_from_zetas(
            z, n1, n2, n_workers=N, n_rounds=cfg["n_rounds"]
        )
    if cfg["scheme"] == "incomplete":
        return incomplete_variance_from_zetas(
            z, n1, n2, n_pairs=cfg["n_pairs"],
            design=cfg.get("design", "swr"),
        )
    return None


def audit_row(name: str, r: dict, device):
    """(report line, z_mean, z_var) of a row (NaN where a z has no
    target), or None for a row outside the audit."""
    cfg, M = r.get("config"), r.get("n_reps")
    # only harness rows qualify: a dict config with the
    # variance-experiment schema (summary files like configs.jsonl
    # carry scalar 'config' ids)
    if (not isinstance(cfg, dict) or not M or M < 8
            or "scheme" not in cfg or "separation" not in cfg):
        return None
    aud_pair = cfg.get("kernel") == "auc" and cfg.get("dim") == 1
    # fix_data triplet rows audit against their own exact conditional
    # forms (fixed_row_targets)
    aud_tri = (cfg.get("kernel") == "triplet_indicator"
               and cfg.get("fix_data"))
    if not (aud_pair or aud_tri):
        # only the 1-D AUC family has the Phi(sep/sqrt 2) population
        # mean and zeta closed forms
        return None
    as_is = False
    if cfg.get("fix_data"):
        targets = fixed_row_targets(cfg, r, device)
        if targets is None:
            return None  # conditional rows outside the exact audit
        pop, pred, regen = targets
        as_is = not regen
    else:
        pop = true_gaussian_auc(cfg["separation"])
        try:
            pred = predicted_variance(cfg)
        except (ValueError, ZeroDivisionError):
            # legal harness rows the closed forms reject (a per-worker
            # class size < 2 for the zeta formulas): audit the mean,
            # skip the variance z-score
            pred = None
    z_mean = (
        (r["mean"] - pop) / math.sqrt(r["variance"] / M)
        if pop is not None else float("nan")
    )
    # `is not None`, never truthiness: a pred of exactly 0.0 is a real
    # closed form (the zero-variance limit); only its z is undefined
    has_pred = pred is not None
    z_var = (
        (r["variance"] - pred) / (pred * math.sqrt(2.0 / (M - 1)))
        if has_pred and pred > 0.0 else float("nan")
    )
    line = (
        f"{name:<28} {cfg['scheme']:>13} N={cfg['n_workers']:<7}"
        f"T={cfg['n_rounds']:<3} B={cfg['n_pairs']:<9}"
        f"d={cfg.get('design', 'swr'):<9}"
        + ("[as-is]" if as_is
           else "[cond] " if cfg.get("fix_data") else "       ")
        + f"n={cfg['n_pos']:<8} M={M:<4}"
        + (f" mean={r['mean']:.6f} z_mean={z_mean:+5.2f}"
           if math.isfinite(z_mean)
           else f" mean={r['mean']:.6f} (no mean target)")
        + (f" var={r['variance']:.3e} pred={pred:.3e}"
           f" z_var={z_var:+5.2f}" if has_pred
           else " (no closed form)")
    )
    return line, z_mean, z_var


def main(argv=None, *, results: str | None = None,
         out: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    results = results or RESULTS
    rows, worst = [], 0.0
    # *_quick.jsonl smoke-run siblings never enter the audit
    paths = sorted(
        p for p in glob.glob(os.path.join(results, "*.jsonl"))
        if not is_quick(os.path.basename(p))
    )
    for path in paths:
        name = os.path.basename(path)
        with open(path) as fh:
            lines = fh.readlines()
        for line in lines:
            audited = audit_row(name, json.loads(line), device)
            if audited is not None:
                rows.append(audited[0])
                worst = max([worst] + [abs(z) for z in audited[1:]
                                       if math.isfinite(z)])
    ok = worst <= Z_LIMIT
    header = (
        f"Statistical audit of committed results ({len(rows)} rows): "
        f"worst |z| = {worst:.2f} (limit {Z_LIMIT}) -> "
        f"{'PASS' if ok else 'FAIL'}\n"
        "z_mean: estimator mean vs population AUC; z_var: Monte-Carlo "
        "variance vs Hoeffding closed form (plug-in zetas, 20k sample).\n"
    )
    report = header + "\n".join(rows) + "\n"
    out = out or os.path.join(results, "stat_check.txt")
    with open(out, "w") as f:
        f.write(report)
    print(report)
    print(f"# wrote {out}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
