"""Figures: the paper-shaped trade-off plots.

A copy of ``tuplewise_tpu.harness.figures``. The harness emits JSONL
records; these functions read them (a path or a list of rows) and write
PNGs. matplotlib is imported inside each function, so importing this
module needs none.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def _results(path_or_list):
    if isinstance(path_or_list, (list, tuple)):
        return list(path_or_list)
    with open(path_or_list) as f:
        return [json.loads(line) for line in f if line.strip()]


def _plot_variance_loglog(results, out_png, x_key, xlabel, series_label,
                          baseline=None, theory=None) -> str:
    """Shared log-log variance plot: measured series, optional
    closed-form Hoeffding overlay, optional complete-U floor."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rs = _results(results)
    x = [r["config"][x_key] for r in rs]
    var = [r["variance"] for r in rs]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.loglog(x, var, "o-", label=series_label)
    if theory:
        ax.loglog(*zip(*theory), ":", c="C1",
                  label="Hoeffding closed form")
    if baseline is not None:
        ax.axhline(baseline["variance"], ls="--", c="gray",
                   label="complete $U_n$")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("estimator variance")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_variance_vs_rounds(results, out_png: str,
                            baseline: Optional[dict] = None,
                            theory: Optional[list] = None) -> str:
    """Variance vs T (repartitions) — the communication trade-off curve
   ; optionally overlays the complete-U variance
    and the closed-form Hoeffding prediction (list of (T, var))."""
    return _plot_variance_loglog(
        results, out_png, "n_rounds",
        "repartition rounds T (communication)",
        "repartitioned $U_{N,T}$", baseline, theory,
    )


def plot_variance_vs_workers(results, out_png: str,
                             baseline: Optional[dict] = None,
                             theory: Optional[list] = None) -> str:
    """Variance of the local-average estimator vs worker count N — the
    paper's 'what local averaging costs' figure.
    The gap off the complete-U floor scales as ~1/m with m = n/N
    per-worker rows, so it only opens up once blocks get small."""
    return _plot_variance_loglog(
        results, out_png, "n_workers", "workers N",
        "local average $U^{loc}_N$", baseline, theory,
    )


def _wc_var(rs):
    """(wall-clock per estimate, variance) series for a result list —
    the one place the per-estimate normalization lives."""
    return ([r["wallclock_s"] / r["n_reps"] for r in rs],
            [r["variance"] for r in rs])


def plot_variance_vs_wallclock(results, out_png: str) -> str:
    """Variance vs wall-clock — the headline trade-off axis
    (BASELINE.json:2)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rs = _results(results)
    wc, var = _wc_var(rs)
    labels = [str(r["config"].get("n_rounds", "")) for r in rs]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.loglog(wc, var, "o-")
    for x, y, l in zip(wc, var, labels):
        ax.annotate(f"T={l}", (x, y), fontsize=7,
                    textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel("wall-clock per estimate [s]")
    ax.set_ylabel("estimator variance")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_variance_vs_pairs(results, out_png: str) -> str:
    """Variance vs sampled-pair budget B (incomplete U)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rs = _results(results)
    B = [r["config"]["n_pairs"] for r in rs]
    var = [r["variance"] for r in rs]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.loglog(B, var, "o-", label=r"incomplete $\tilde{U}_B$")
    ax.set_xlabel("sampled pairs B")
    ax.set_ylabel("estimator variance")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_learning_curve(history, out_png: str,
                        auc_before: Optional[float] = None,
                        auc_after: Optional[float] = None) -> str:
    """Pairwise-SGD training curve: per-step surrogate
    loss, with before/after test AUC annotated when provided."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    loss = np.asarray(history["loss"])
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(np.arange(len(loss)), loss, lw=1.2)
    ax.set_xlabel("SGD step")
    ax.set_ylabel("pairwise surrogate loss")
    if auc_before is not None and auc_after is not None:
        ax.set_title(
            f"test AUC {auc_before:.3f} -> {auc_after:.3f}", fontsize=9
        )
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_frontier(groups, out_png: str) -> str:
    """The headline axis in one picture [BASELINE.json:2]: estimator
    variance vs wall-clock per estimate for every scheme family.
    ``groups`` maps a series label to a list of harness result dicts;
    each point is one committed experiment."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 4))
    markers = {"complete": "*", "incomplete": "o", "repartitioned": "s",
               "local": "D"}
    for label, rs in groups.items():
        rs = _results(rs)
        if not rs:  # tolerate not-yet-populated series
            continue
        wc, var = _wc_var(rs)
        scheme = rs[0]["config"]["scheme"]
        ax.loglog(wc, var, markers.get(scheme, "o"),
                  ls="-" if len(rs) > 1 else "",
                  ms=9 if scheme == "complete" else 5, label=label)
    ax.set_xlabel("wall-clock per estimate [s]")
    ax.set_ylabel("estimator variance")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def _nr_label(row) -> str:
    nr = row.get("n_r")
    return "never" if nr is None else f"$n_r$={nr}"


def plot_learning_curves(rows, out_png: str, title: str = "") -> str:
    """Learning-side trade-off curves: mean held-out
    AUC vs SGD steps, one line per repartition period n_r, +-2 SE band
    over the Monte-Carlo seeds. ``rows`` are learning-suite records
    (same dataset/N/B) with eval_steps / auc_mean / auc_se arrays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _results(rows)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    lo, hi = np.inf, -np.inf
    # frequent repartition first so legend order mirrors the physics
    for row in sorted(rows, key=lambda r: (r.get("n_r") is None,
                                           r.get("n_r") or 0)):
        s = np.asarray(row["eval_steps"])
        mu = np.asarray(row["auc_mean"])
        # n_seeds=1 rows carry null SEs (no spread estimate): plot the
        # mean with a zero-width band rather than crashing
        se = np.asarray(
            [0.0 if v is None else v for v in row["auc_se"]], float
        )
        (ln,) = ax.plot(s, mu, lw=1.4, label=_nr_label(row))
        ax.fill_between(s, mu - 2 * se, mu + 2 * se,
                        color=ln.get_color(), alpha=0.18, lw=0)
        tail = s >= 0.2 * s[-1]
        lo = min(lo, (mu - 3 * se)[tail].min())
        hi = max(hi, (mu + 3 * se)[tail].max())
    if np.isfinite(lo) and hi > lo:
        # zoom past the shared initial ramp: the per-n_r separation is
        # millis of AUC and invisible on the full [init, converged] range
        pad = 0.15 * (hi - lo)
        ax.set_ylim(lo - pad, hi + pad)
    ax.set_xlabel("SGD step")
    ax.set_ylabel("held-out AUC (zoomed to converged range)")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8, title="repartition every", title_fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_auc_vs_comm(rows, out_png: str, title: str = "") -> str:
    """The learning analogue of variance-vs-T:
    final held-out AUC (+-2 SE) against the number of communication
    (repartition) events the schedule paid, one line per worker count.
    Frequent repartition buys gradient quality with communication —
    the paper's learning trade-off in one picture."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _results(rows)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    by_n = {}
    for r in rows:
        by_n.setdefault(r["n_workers"], []).append(r)
    for N, rs in sorted(by_n.items()):
        rs = sorted(rs, key=lambda r: r["comm_events"])
        x = [r["comm_events"] for r in rs]
        y = [r["final_auc_mean"] for r in rs]
        e = [2 * (r["final_auc_se"] or 0.0) for r in rs]
        ax.errorbar(x, y, yerr=e, marker="o", ms=4, lw=1.2, capsize=2,
                    label=f"N={N}")
    ax.set_xscale("log")
    ax.set_xlabel("communication events (repartitions)")
    ax.set_ylabel("final held-out AUC")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8, title="workers", title_fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_auc_vs_budget(rows, out_png: str, title: str = "") -> str:
    """Final held-out AUC vs per-worker pair budget B at fixed N, one
    line per repartition period — the learning analogue of the
    incomplete-U budget curve. B=None rows
    (all local pairs) plot at x = m1*m2, the full local grid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _results(rows)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    by_nr = {}
    for r in rows:
        by_nr.setdefault(r.get("n_r"), []).append(r)
    for nr in sorted(by_nr, key=lambda v: (v is None, v or 0)):
        rs = by_nr[nr]
        # sampled-B rows form the line; the all-local-pairs row plots
        # as a separate STAR at x = m1*m2 — same x when B happens to
        # equal the full grid, but distinguishable (swr sampling of the
        # grid is not the same estimator as the full grid)
        sampled = sorted(
            (r for r in rs if r["pairs_per_worker"] is not None),
            key=lambda r: r["pairs_per_worker"],
        )
        full = [r for r in rs if r["pairs_per_worker"] is None]
        color = None
        if sampled:
            x = [r["pairs_per_worker"] for r in sampled]
            y = [r["final_auc_mean"] for r in sampled]
            e = [2 * (r["final_auc_se"] or 0.0) for r in sampled]
            eb = ax.errorbar(x, y, yerr=e, marker="o", ms=4, lw=1.2,
                             capsize=2, label=_nr_label(rs[0]))
            color = eb.lines[0].get_color()
        for r in full:
            ax.errorbar(
                [r["m_per_worker"][0] * r["m_per_worker"][1]],
                [r["final_auc_mean"]],
                yerr=[2 * (r["final_auc_se"] or 0.0)],
                marker="*", ms=11, capsize=2, color=color,
                label=None if sampled else _nr_label(r),
            )
    ax.set_xscale("log")
    ax.set_xlabel("pairs per worker per step B (star = all local pairs)")
    ax.set_ylabel("final held-out AUC")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8, title="repartition every", title_fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_sd_vs_comm(rows, out_png: str,
                    title: str = "") -> Optional[str]:
    """Across-seed SD of the final model vs communication events — the
    learning analogue of the estimator's variance-vs-T decay (RESULTS
    §6.1 finding 2). No closed-form guide is drawn: unlike the
    repartitioned ESTIMATOR (which averages all T rounds equally), a
    constant-lr SGD iterate only averages partitions inside its
    O(1/lr)-step memory, so the decay starts slower than T^(-1/2) and
    steepens once repartitions outpace that window — exactly what the
    measured curves show."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [r for r in _results(rows) if r.get("final_auc_sd")]
    if not rows:   # all-n_seeds=1 suites have no spread to plot: skip
        return None   # (no file written — callers must null-check)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    by_n = {}
    for r in rows:
        by_n.setdefault(r["n_workers"], []).append(r)
    for N, rs in sorted(by_n.items()):
        rs = sorted(rs, key=lambda r: r["comm_events"])
        x = [r["comm_events"] for r in rs]
        y = [r["final_auc_sd"] for r in rs]
        ax.loglog(x, y, "o-", ms=4, lw=1.2, label=f"N={N}")
    ax.set_xlabel("communication events (repartitions)")
    ax.set_ylabel("SD of final held-out AUC across partitions")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8, title="workers", title_fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_design_budget(rows, out_png: str, title: str = "") -> str:
    """Final held-out AUC vs per-worker budget B, one line per pair
    DESIGN (swr/swor/bernoulli) at each repartition period — does the
    finite-population design reach a better budget-noise floor?
   ."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _results(rows)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    markers = {"swr": "o", "swor": "s", "bernoulli": "^"}
    for nr in sorted({r.get("n_r") for r in rows},
                     key=lambda v: (v is None, v or 0)):
        for design in ("swr", "swor", "bernoulli"):
            rs = sorted(
                (r for r in rows
                 if r.get("n_r") == nr
                 and r.get("pair_design", "swr") == design),
                key=lambda r: r["pairs_per_worker"],
            )
            if not rs:
                continue
            x = [r["pairs_per_worker"] for r in rs]
            y = [r["final_auc_mean"] for r in rs]
            e = [2 * (r["final_auc_se"] or 0.0) for r in rs]
            ax.errorbar(
                x, y, yerr=e, marker=markers[design], ms=4, lw=1.2,
                capsize=2,
                label=f"{design}, {_nr_label(rs[0])}",
            )
    ax.set_xlabel("pairs per worker per step B")
    ax.set_ylabel("final held-out AUC")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_triplet_curves(rows, out_png: str, title: str = "") -> str:
    """Held-out triplet-accuracy curves of the degree-3 metric learner
    (models.triplet_sgd), one line per repartition period, one panel
    per task."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _results(rows)
    tasks = sorted({r["task"] for r in rows})
    fig, axes = plt.subplots(
        1, len(tasks), figsize=(5.0 * len(tasks), 4), squeeze=False
    )
    for ax, task in zip(axes[0], tasks):
        for r in sorted(
            (r for r in rows if r["task"] == task),
            key=lambda r: (r["n_r"] is None, r["n_r"] or 0),
        ):
            curve = r["acc_curve_mean"]
            steps = r["steps"]
            x = [steps * (i + 1) / len(curve)
                 for i in range(len(curve))]
            ax.plot([0] + x, [r["acc_init_mean"]] + list(curve),
                    marker="o", ms=3, lw=1.2, label=_nr_label(r))
        ax.set_xlabel("step")
        ax.set_ylabel("held-out triplet accuracy")
        ax.set_title(task, fontsize=9)
        ax.legend(fontsize=8)
    if title:
        fig.suptitle(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
