"""Learning-side trade-off suite of the port (the counterpart of the JAX
package's ``scripts/learning_suite.py``).

The paper's second half: distributed pairwise SGD where repartitioning
every n_r steps trades communication for gradient quality. Two
instruments:

* the SIMULATED-N trainer (``models.sim_learner``: replicas batched over
  workers AND Monte-Carlo seeds) sweeps repartition period x worker count
  x pair budget in the small-block regime where the trade-off is
  visible, with held-out evaluation (fresh-draw Gaussian test sets, the
  stratified Adult split);
* the MESH trainer (``models.pairwise_sgd``, its workers on
  ``parallel.mesh``) gives the throughput rows: steps/s at production
  sizes on the card, and the 8-worker mesh.

Stages: gauss, adult, designs, prod, triplet, mesh8, chip, gauss-chip,
trace, figs. Every stage runs on ``--device`` (default the card) in one
invocation: torch has no process-global platform, so the JAX script's
split into CPU and chip invocations has no counterpart. ``gauss-chip``
runs the gauss cells on the card and again on the CPU, and fails unless
their final AUCs agree within 4 standard errors. ``trace`` traces a
warm 20-step loss-free run with torch.profiler and digests it with
``trace_summary.py``; it fails unless the digest names the gradient
kernel it ran. Each row's ``platform`` is the torch device type and its
``card`` the card's name and power limit.

Outputs (into ``<results>``, default ``results/torch/``):
learning_gauss.jsonl, learning_adult.jsonl, learning_designs.jsonl,
learning_prod.jsonl, learning_triplet.jsonl, learning_mesh_overlap.jsonl,
learning_throughput{,_chip}.jsonl, learning_gauss_chip.jsonl,
trace_train_chip_summary.txt, figures/learning_*.png.

Usage: python scripts_torch/learning_suite.py [--quick] [--stages ...]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device, n_devices, platform_of, read_jsonl, sync,
    utc_stamp,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402
# repartition_every sentinel for "never", shared with curve_record
from tuplewise_tpu_torch.models.sim_learner import NEVER  # noqa: E402
from tuplewise_tpu_torch.utils.results_io import quick_sibling  # noqa: E402

T0 = time.perf_counter()
QUICK = False     # set by main(); quick output never touches full files
DEVICE = torch.device("cpu")   # set by main()
STAGES = ("gauss", "adult", "designs", "prod", "triplet", "mesh8", "chip",
          "gauss-chip", "trace", "figs")
DEFAULT_STAGES = "gauss,adult,designs,prod,triplet,mesh8,figs"
# the hinge gradient's search kernel (csrc/rank_count.cu): the trace
# stage's loss-free steps launch it through pair_grad_sums
TRACE_KERNEL = "grad_count_kernel"
# sim replica s against the mesh trainer's seed cfg.seed + s: the final
# held-out AUCs agree within the mesh-trainer tests' tolerance
OVERLAP_RTOL, OVERLAP_ATOL = 1e-4, 1e-6
# gauss-chip: the card's and the CPU's mean final AUCs of a cell differ
# by at most this many standard errors
TWIN_Z = 4.0


def log(msg):
    print(f"[learning +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


_touched = set()


def _quick_name(name: str) -> str:
    return quick_sibling(name, QUICK)


def _out_path(name: str) -> str:
    return os.path.join(RESULTS, _quick_name(name))


def stamp() -> dict:
    return {"platform": platform_of(DEVICE), "card": card_of(DEVICE)}


def emit(rec, out_name):
    """Rows accumulate in a .partial sibling; finalize_outputs() renames
    it onto the real file only when the data stages complete, so a crash
    mid-stage leaves the earlier file untouched."""
    path = _out_path(out_name)
    partial = path + ".partial"
    if path not in _touched:
        _touched.add(path)
        if os.path.exists(partial):
            os.remove(partial)
    if QUICK:
        rec["quick"] = True
    rec["ts"] = utc_stamp()
    with open(partial, "a") as f:
        f.write(json.dumps(rec) + "\n")


def finalize_outputs():
    for path in sorted(_touched):
        partial = path + ".partial"
        if os.path.exists(partial):
            os.replace(partial, path)
            log(f"finalized {os.path.basename(path)}")


def curve_cell(scorer, p0, data, cfg, *, n_seeds, eval_every, device):
    """S replicas of one cell on ``device``: (the curve row of
    ``sim_learner.curve_record``, seconds)."""
    from tuplewise_tpu_torch.models.sim_learner import (
        curve_record, train_curves,
    )

    Xp, Xn, Xp_te, Xn_te = data
    t0 = time.perf_counter()
    out = train_curves(scorer, p0, Xp, Xn, Xp_te, Xn_te, cfg,
                       n_seeds=n_seeds, eval_every=eval_every,
                       device=device)
    return curve_record(cfg, out, n_seeds), time.perf_counter() - t0


def run_config(scorer, p0, data, cfg, *, n_seeds, eval_every, dataset,
               out_name, extra=None):
    """One sweep cell: train S replicas, emit the full curve row (the
    schema of ``sim_learner.curve_record`` plus the suite's fields and
    ``extra``)."""
    Xp, Xn, Xp_te, Xn_te = data
    curve, wc = curve_cell(scorer, p0, data, cfg, n_seeds=n_seeds,
                           eval_every=eval_every, device=DEVICE)
    rec = dict(
        curve,
        dataset=dataset, seed0=cfg.seed,
        n_train=[len(Xp), len(Xn)],
        n_test=[len(Xp_te), len(Xn_te)],
        m_per_worker=[len(Xp) // cfg.n_workers,
                      len(Xn) // cfg.n_workers],
        wallclock_s=round(wc, 2), **stamp(), **(extra or {}),
    )
    emit(rec, out_name)

    def fmt(v):   # null-safe: n_seeds=1 rows carry no spread estimate
        return "n/a" if v is None else f"{v:.5f}"

    log(f"{dataset} N={cfg.n_workers} n_r={rec['n_r']} "
        f"B={cfg.pairs_per_worker} "
        f"final={rec['final_auc_mean']:.5f}+-{fmt(rec['final_auc_se'])} "
        f"sd={fmt(rec['final_auc_sd'])} ({wc:.1f}s)")
    return rec


def _gauss_cells(q):
    """The one source of the gaussian sweep's data and config cell:
    gauss-chip re-runs stage_gauss's cells exactly."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    n = 128 if q else 512
    n_te = 2000 if q else 20000
    steps = 40 if q else 500
    S = 4 if q else 48
    data = make_gaussian_splits(n, n_te, dim=10, separation=0.8, seed=0)
    scorer = LinearScorer(dim=10)
    p0 = scorer.init(0)
    base = TrainConfig(kernel="hinge", lr=0.3, steps=steps, seed=1000)
    return data, scorer, p0, base, S, steps


def stage_gauss(q):
    """Gaussians, small-block regime: n_r x N sweep + pair-budget sweep."""
    data, scorer, p0, base, S, steps = _gauss_cells(q)
    nrs = (1, 5, NEVER) if q else (1, 5, 25, 125, NEVER)
    for N in ((16, 32) if q else (32, 128, 256, 16)):
        for nr in nrs:
            run_config(
                scorer, p0, data,
                dataclasses.replace(base, n_workers=N,
                                    repartition_every=nr),
                n_seeds=S, eval_every=steps // 20 or 1,
                dataset="gaussians", out_name="learning_gauss.jsonl")
    # pair-budget sweep at fixed N (B=None rows come from the sweep above)
    N = 16 if q else 128
    for B in (1, 4, 16):
        for nr in ((1, NEVER) if q else (1, 25, NEVER)):
            run_config(
                scorer, p0, data,
                dataclasses.replace(base, n_workers=N,
                                    repartition_every=nr,
                                    pairs_per_worker=B),
                n_seeds=S, eval_every=steps // 20 or 1,
                dataset="gaussians", out_name="learning_gauss.jsonl")


def stage_designs(q):
    """Pair-budget designs on the learning side: at N = 128 the
    per-worker grid is 4 x 4 = 16 pairs, so B in {4, 8} is 25 % / 50 % of
    the grid, where swor and bernoulli cut the sampling noise by the
    finite-population factor; swr is the control."""
    data, scorer, p0, base, S, steps = _gauss_cells(q)
    N = 16 if q else 128
    for design in ("swr", "swor", "bernoulli"):
        for B in ((4,) if q else (4, 8)):
            for nr in ((1,) if q else (1, NEVER)):
                run_config(
                    scorer, p0, data,
                    dataclasses.replace(base, n_workers=N,
                                        repartition_every=nr,
                                        pairs_per_worker=B,
                                        pair_design=design),
                    n_seeds=S, eval_every=steps // 20 or 1,
                    dataset="gaussians",
                    out_name="learning_designs.jsonl")


def overlap_cell(scorer, p0, data, cfg, n_seeds):
    """The same cell trained by both instruments: sim replica s against
    the mesh trainer (``train_pairwise`` on its ``cfg.n_workers``-worker
    mesh) at seed cfg.seed + s. Returns (sim finals, mesh finals,
    seconds); raises unless they agree within OVERLAP_RTOL/ATOL."""
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        evaluate_auc, train_pairwise,
    )
    from tuplewise_tpu_torch.models.sim_learner import train_curves

    Xp, Xn, Xp_te, Xn_te = data
    t0 = time.perf_counter()
    out = train_curves(scorer, p0, Xp, Xn, Xp_te, Xn_te, cfg,
                       n_seeds=n_seeds, eval_every=10**9, device=DEVICE)
    sim_finals = [
        float(evaluate_auc(
            scorer, {k: np.asarray(v)[s] for k, v in
                     out["final_params"].items()},
            Xp_te, Xn_te, device=DEVICE))
        for s in range(n_seeds)
    ]
    mesh_finals = []
    for s in range(n_seeds):
        p_s, _ = train_pairwise(
            scorer, p0, Xp, Xn, dataclasses.replace(cfg, seed=cfg.seed + s),
            device=DEVICE)
        mesh_finals.append(float(evaluate_auc(scorer, p_s, Xp_te, Xn_te,
                                              device=DEVICE)))
    wc = time.perf_counter() - t0
    np.testing.assert_allclose(
        mesh_finals, sim_finals, rtol=OVERLAP_RTOL, atol=OVERLAP_ATOL,
        err_msg=f"sim and mesh trainers disagree at n_r="
                f"{cfg.repartition_every}")
    return sim_finals, mesh_finals, wc


def stage_prod(q):
    """Production-size budgeted sweep: n = 16384 a class, S = 16 seeds,
    n_r in {1, never}, N in {8, 64} (N = 64 puts 256 a class in each
    block); then the N = 8 config trained by both instruments."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    n = 1024 if q else 16384
    S = 4 if q else 16
    steps = 40 if q else 500
    data = make_gaussian_splits(n, 2000 if q else 20000, dim=10,
                                separation=0.8, seed=0)
    scorer = LinearScorer(dim=10)
    p0 = scorer.init(0)
    base = TrainConfig(kernel="hinge", lr=0.3, steps=steps, seed=1000,
                       pairs_per_worker=256)
    for N in (8, 64):
        for nr in (1, NEVER):
            run_config(
                scorer, p0, data,
                dataclasses.replace(base, n_workers=N,
                                    repartition_every=nr),
                n_seeds=S, eval_every=steps // 20 or 1,
                dataset="gaussians", out_name="learning_prod.jsonl")
    S_cell = 2 if q else 8
    for nr in ((1,) if q else (1, NEVER)):
        cfg = dataclasses.replace(base, n_workers=8, repartition_every=nr,
                                  steps=40 if q else 200)
        sim_finals, mesh_finals, wc = overlap_cell(scorer, p0, data, cfg,
                                                   S_cell)
        delta = float(np.max(np.abs(np.asarray(sim_finals)
                                    - np.asarray(mesh_finals))))
        emit({
            "cell": "instrument_overlap_prod", "n_workers": 8,
            "n_train_per_class": n,
            "pairs_per_worker": base.pairs_per_worker,
            "n_r": None if nr >= NEVER else nr, "steps": cfg.steps,
            "n_seeds": S_cell,
            "sim_final_auc": [round(v, 6) for v in sim_finals],
            "mesh_final_auc": [round(v, 6) for v in mesh_finals],
            "max_abs_delta": delta,
            "wallclock_incl_compile_s": round(wc, 2),
            **stamp(),
        }, "learning_prod.jsonl")
        log(f"prod overlap n_r={None if nr >= NEVER else nr}: "
            f"max |sim-mesh| = {delta:.2e} over {S_cell} seeds "
            f"({wc:.1f}s)")


def _split(X, frac, rng):
    p = rng.permutation(len(X))
    t = int(frac * len(X))
    return X[p[:t]], X[p[t:]]


def _triplet_task(task, seed, q):
    from tuplewise_tpu_torch.data import load_mnist_embeddings, make_gaussians

    rng = np.random.default_rng(seed)
    if task == "gauss-overlap":
        n = 240 if q else 2_000
        # overlapping clouds: the class overlap caps accuracy well below 1
        X, Y = make_gaussians(n, 3 * n, dim=16, separation=1.0, seed=seed)
    else:
        n_all = 400 if q else 4_000
        E, labels, _ = load_mnist_embeddings(n=n_all, seed=seed)
        X, Y = E[labels == 3], E[labels != 3]
    Xc_tr, Xc_te = _split(np.asarray(X, np.float32), 0.75, rng)
    Xo_tr, Xo_te = _split(np.asarray(Y, np.float32), 0.75, rng)
    return Xc_tr, Xo_tr, Xc_te, Xo_te


def _radial_data(seed, q):
    """Inner shell (class) vs outer shell (others) in d = 8: disjoint
    radii (Bayes triplet accuracy 1.0) that no linear projection
    separates."""
    rng = np.random.default_rng(seed)
    d, n = 8, (240 if q else 2_000)

    def shell(m, r_lo, r_hi):
        v = rng.standard_normal((m, d))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = rng.uniform(r_lo, r_hi, size=(m, 1))
        return (v * r).astype(np.float32)

    X = shell(n, 0.5, 1.0)
    Y = shell(3 * n, 1.8, 2.6)
    Xc_tr, Xc_te = _split(X, 0.75, rng)
    Xo_tr, Xo_te = _split(Y, 0.75, rng)
    return Xc_tr, Xo_tr, Xc_te, Xo_te


def _triplet_seeds(S, data_of, make_emb, cfg_of, steps):
    """(final accuracies, curves, initial accuracies, seconds) of S seeds
    of the triplet learner, its held-out accuracy evaluated through
    kernel 5."""
    from tuplewise_tpu_torch.models.triplet_sgd import (
        evaluate_triplet_accuracy, train_triplet,
    )

    accs, curves, acc0s = [], [], []
    t0 = time.perf_counter()
    for s in range(S):
        Xc_tr, Xo_tr, Xc_te, Xo_te = data_of(s)
        emb, p0 = make_emb(Xc_tr.shape[1], s)
        acc0s.append(evaluate_triplet_accuracy(
            p0, Xc_te, Xo_te, embedder=emb, device=DEVICE))
        _, hist = train_triplet(
            p0, Xc_tr, Xo_tr, cfg_of(s), eval_every=max(steps // 10, 1),
            eval_data=(Xc_te, Xo_te), embedder=emb, device=DEVICE)
        curves.append(hist["test_acc"])
        accs.append(float(hist["test_acc"][-1]))
    return (np.asarray(accs), np.mean(np.stack(curves), axis=0), acc0s,
            time.perf_counter() - t0)


def stage_triplet(q):
    """Degree-3 metric learning: the triplet-hinge learner through a
    k = 2 embedding, held-out triplet accuracy as the curve, on the
    overlapping Gaussian clouds and the MNIST surrogate (class 3 against
    the rest), n_r in {1, 25, never}; then the radial task with the
    linear and the MLP embedding."""
    from tuplewise_tpu_torch.models.scorers import LinearEmbed, MLPEmbed
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, init_embed,
    )

    S = 2 if q else 8
    steps = 30 if q else 300
    N = 4 if q else 8
    tpw = 512 if q else 4_096

    def se(accs):
        return (round(float(accs.std(ddof=1) / np.sqrt(S)), 6)
                if S > 1 else None)

    for task in ("gauss-overlap", "mnist-surrogate"):
        for nr in ((1,) if q else (1, 25, NEVER)):
            accs, curve, acc0s, wc = _triplet_seeds(
                S, lambda s: _triplet_task(task, s, q),
                lambda dim, s: (None, init_embed(dim, 2, seed=s)),
                lambda s: TripletTrainConfig(
                    lr=0.1, steps=steps, n_workers=N, repartition_every=nr,
                    triplets_per_worker=tpw, seed=1_000 + s, embed_dim=2),
                steps)
            rec = {
                "task": task, "embed_dim": 2, "n_workers": N,
                "n_r": None if nr >= NEVER else nr,
                "repartition_every": nr, "steps": steps,
                "triplets_per_worker": tpw,
                "n_seeds": S,
                "acc_init_mean": round(float(np.mean(acc0s)), 6),
                "acc_curve_mean": np.round(curve, 6).tolist(),
                "final_acc_mean": round(float(accs.mean()), 6),
                "final_acc_se": se(accs),
                "wallclock_s": round(wc, 2), **stamp(),
            }
            rec["embedder"] = "linear"
            emit(rec, "learning_triplet.jsonl")
            log(f"triplet {task} n_r={rec['n_r']} "
                f"final={rec['final_acc_mean']:.5f} "
                f"(init {rec['acc_init_mean']:.5f}) ({wc:.1f}s)")

    # the MLP needs a longer horizon to climb past the linear plateau
    r_steps = steps if q else 800
    for name in ("linear", "mlp"):
        def make_emb(dim, s, name=name):
            emb = (LinearEmbed(dim=8, embed_dim=2) if name == "linear"
                   else MLPEmbed(dim=8, hidden=32, embed_dim=2))
            return emb, emb.init(seed=s)

        accs, curve, acc0s, wc = _triplet_seeds(
            S, lambda s: _radial_data(s, q), make_emb,
            lambda s: TripletTrainConfig(
                lr=0.3, steps=r_steps, n_workers=N, repartition_every=1,
                triplets_per_worker=tpw, seed=1_000 + s, embed_dim=2),
            r_steps)
        rec = {
            "task": "radial", "embedder": name, "embed_dim": 2,
            "n_workers": N, "n_r": 1, "repartition_every": 1,
            "steps": r_steps,
            "triplets_per_worker": tpw, "n_seeds": S,
            "bayes_ceiling": 1.0,
            "acc_init_mean": round(float(np.mean(acc0s)), 6),
            "acc_curve_mean": np.round(curve, 6).tolist(),
            "final_acc_mean": round(float(accs.mean()), 6),
            "final_acc_se": se(accs),
            "wallclock_s": round(wc, 2), **stamp(),
        }
        emit(rec, "learning_triplet.jsonl")
        log(f"triplet radial embedder={name} "
            f"final={rec['final_acc_mean']:.5f} "
            f"(init {rec['acc_init_mean']:.5f}) ({wc:.1f}s)")


def twin_z(rec: dict, twin: dict) -> float:
    """z of the difference of two cells' mean final AUCs, by their seed
    spreads' standard errors."""
    se = math.hypot(rec["final_auc_se"], twin["final_auc_se"])
    d = rec["final_auc_mean"] - twin["final_auc_mean"]
    return d / se if se else (0.0 if d == 0 else math.copysign(math.inf, d))


def gauss_against(q, twin_device):
    """stage_gauss's visible-regime cells on ``DEVICE``, each held
    against the same cell on ``twin_device``: the final held-out AUCs'
    means agree within TWIN_Z standard errors or the stage raises. The
    rows carry the twin's mean, standard error, seconds and the z."""
    data, scorer, p0, base, S, steps = _gauss_cells(q)
    N = 16 if q else 256
    for nr in ((1, NEVER) if q else (1, 25, NEVER)):
        cfg = dataclasses.replace(base, n_workers=N, repartition_every=nr)
        twin, twin_s = curve_cell(scorer, p0, data, cfg, n_seeds=S,
                                  eval_every=steps // 20 or 1,
                                  device=twin_device)
        rec = run_config(
            scorer, p0, data, cfg, n_seeds=S, eval_every=steps // 20 or 1,
            dataset="gaussians", out_name="learning_gauss_chip.jsonl",
            extra={"twin_device": str(twin_device),
                   "twin_final_auc_mean": twin["final_auc_mean"],
                   "twin_final_auc_se": twin["final_auc_se"],
                   "twin_wallclock_s": round(twin_s, 2)})
        z = twin_z(rec, twin)
        log(f"gauss-chip N={N} n_r={rec['n_r']}: {DEVICE} "
            f"{rec['final_auc_mean']:.5f} vs {twin_device} "
            f"{twin['final_auc_mean']:.5f}, z={z:+.2f}")
        if not abs(z) <= TWIN_Z:
            raise AssertionError(
                f"gauss-chip N={N} n_r={rec['n_r']}: the final AUCs on "
                f"{DEVICE} and {twin_device} disagree (z={z:+.2f})")


def stage_gauss_chip(q):
    """stage_gauss's visible-regime cells on the card, held against the
    same cells on the CPU. The port's generators differ between the CPU
    and the card, so the two runs draw different partitions and pairs,
    and their final AUCs agree statistically (``gauss_against``)."""
    if DEVICE.type != "cuda":
        raise SystemExit(
            f"gauss-chip must run on the card: the device is {DEVICE} — "
            "a CPU run held against a CPU run would make the comparison "
            "vacuous")
    gauss_against(q, torch.device("cpu"))


def stage_adult(q):
    """The Adult surrogate (the real CSVs when on disk): n_r x N sweep on
    the stratified train/test split."""
    from tuplewise_tpu_torch.data import load_adult_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, split_by_label,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    n = 600 if q else 8000
    steps = 40 if q else 400
    S = 4 if q else 48
    X, y, Xte, yte, meta = load_adult_splits(n=n, seed=0)
    Xp, Xn = split_by_label(X, y)
    Xp_te, Xn_te = split_by_label(Xte, yte)
    data = (Xp, Xn, Xp_te, Xn_te)
    log(f"adult: train pos/neg = {len(Xp)}/{len(Xn)}, "
        f"test = {len(Xp_te)}/{len(Xn_te)}, source={meta['source']}")
    scorer = LinearScorer(dim=Xp.shape[1])
    p0 = scorer.init(0)
    base = TrainConfig(kernel="hinge", lr=0.3, steps=steps, seed=2000)
    nrs = (1, 5, NEVER) if q else (1, 5, 25, 125, NEVER)
    for N in ((8,) if q else (8, 64, 180)):
        for nr in nrs:
            run_config(
                scorer, p0, data,
                dataclasses.replace(base, n_workers=N,
                                    repartition_every=nr),
                n_seeds=S, eval_every=steps // 20 or 1,
                dataset="adult", out_name="learning_adult.jsonl")


def _throughput_row(n_per_class, cfg, label, steps_timed=30,
                    out_name="learning_throughput.jsonl"):
    """Mesh-trainer steps/s at a production size, warmed with the same
    step count (kernels built and loaded outside the clock)."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        evaluate_auc, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.sim_learner import last_recorded_loss

    Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(
        n_per_class, max(n_per_class // 4, 1000), dim=5, seed=0)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    timed = dataclasses.replace(cfg, steps=steps_timed)
    train_pairwise(scorer, p0, Xp, Xn, timed, device=DEVICE)
    sync(DEVICE)
    t0 = time.perf_counter()
    params, hist = train_pairwise(scorer, p0, Xp, Xn, timed, device=DEVICE)
    wc = time.perf_counter() - t0
    pairs_per_step = (len(Xp) // cfg.n_workers) ** 2 * cfg.n_workers \
        if cfg.pairs_per_worker is None \
        else cfg.pairs_per_worker * cfg.n_workers
    rec = {
        "label": label, "platform": platform_of(DEVICE),
        "devices": n_devices(DEVICE),
        "n_workers": cfg.n_workers,
        "n_train_per_class": n_per_class,
        "kernel": cfg.kernel, "lr": cfg.lr,
        "repartition_every": cfg.repartition_every,
        "pairs_per_worker": cfg.pairs_per_worker,
        # loss-free steps record NaN; loss_last is the last RECORDED loss
        # (None = never recorded past step 0, or diverged)
        "loss_every": cfg.loss_every,
        "steps": steps_timed,
        "steps_per_s": round(steps_timed / wc, 3),
        "grad_pairs_per_s": round(pairs_per_step * steps_timed / wc, 1),
        "wallclock_s": round(wc, 3),
        "auc_test_after": evaluate_auc(scorer, params, Xp_te, Xn_te,
                                       device=DEVICE),
        "loss_last": last_recorded_loss(hist["loss"], cfg.loss_every),
        "card": card_of(DEVICE),
    }
    emit(rec, out_name)
    log(f"throughput {label}: {rec['steps_per_s']} steps/s, "
        f"{rec['grad_pairs_per_s']:.3e} grad-pairs/s ({wc:.2f}s)")
    return rec


def stage_mesh8(q):
    """Multi-worker training on the 8-worker mesh (``parallel.mesh``,
    the workers on the device's leading axis): throughput rows, then one
    cell trained by both instruments, seed by seed (the sim replica s
    against the mesh trainer at seed cfg.seed + s)."""
    from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig

    n = 512 if q else 4096
    for nr in (1, 10, NEVER):
        _throughput_row(
            n, TrainConfig(kernel="hinge", lr=0.3, n_workers=8,
                           repartition_every=nr, seed=7),
            label=f"mesh8_nr{'inf' if nr >= NEVER else nr}",
            steps_timed=10 if q else 30)

    data, scorer, p0, base, *_ = _gauss_cells(q)
    S_cell = 2 if q else 8
    for nr in ((1,) if q else (1, NEVER)):
        cfg = dataclasses.replace(base, n_workers=8, repartition_every=nr,
                                  steps=40 if q else 200)
        sim_finals, mesh_finals, wc = overlap_cell(scorer, p0, data, cfg,
                                                   S_cell)
        delta = float(np.max(np.abs(np.asarray(sim_finals)
                                    - np.asarray(mesh_finals))))
        emit({
            "cell": "instrument_overlap", "n_workers": 8,
            "n_r": None if nr >= NEVER else nr, "steps": cfg.steps,
            "n_seeds": S_cell,
            "sim_final_auc": [round(v, 6) for v in sim_finals],
            "mesh_final_auc": [round(v, 6) for v in mesh_finals],
            "max_abs_delta": delta,
            "wallclock_incl_compile_s": round(wc, 2),
            **stamp(),
        }, "learning_mesh_overlap.jsonl")
        log(f"overlap cell n_r={None if nr >= NEVER else nr}: max "
            f"|sim-mesh| final-AUC delta = {delta:.2e} over {S_cell} "
            f"seeds ({wc:.1f}s)")


def stage_chip(q):
    """One-worker training on the card at production sizes; the
    repartition event's cost is the nr=1 vs nr=inf delta, loss-free steps
    (le = never) take the gradient-only kernel."""
    from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig

    for n in ((2048,) if q else (100_000, 500_000)):
        for nr in (1, 10, NEVER):
            for le in (1, NEVER):
                _throughput_row(
                    n,
                    TrainConfig(kernel="hinge", lr=0.3, n_workers=1,
                                repartition_every=nr, seed=7,
                                tile=2048, loss_every=le),
                    label=(f"chip_n{n}_nr{'inf' if nr >= NEVER else nr}"
                           + ("_lossfree" if le >= NEVER else "")),
                    steps_timed=5 if q else 20,
                    out_name="learning_throughput_chip.jsonl")


def _trace_summary():
    """The sibling ``trace_summary.py``, loaded from this directory."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "trace_summary.py")
    spec = importlib.util.spec_from_file_location("_trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_trace(q):
    """Profiler evidence for the trainer: a warm 20-step loss-free run
    (n_r = 2) under ``utils.profiling.trace`` (torch.profiler), digested
    by trace_summary.py into trace_train_chip_summary.txt. The digest
    must name the gradient kernel the steps ran (TRACE_KERNEL): a trace
    that missed it is never committed."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.utils.profiling import trace

    n = 2048 if q else 100_000
    Xp, Xn, _, _ = make_gaussian_splits(n, 1000, dim=5, seed=0)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=20, n_workers=1,
                      repartition_every=2, seed=7, tile=2048,
                      loss_every=NEVER)
    train_pairwise(scorer, p0, Xp, Xn, cfg, device=DEVICE)   # warm
    sync(DEVICE)
    trace_dir = _out_path("trace_train_chip")
    shutil.rmtree(trace_dir, ignore_errors=True)  # one run per digest
    with trace(trace_dir):
        t0 = time.perf_counter()
        train_pairwise(scorer, p0, Xp, Xn, cfg, device=DEVICE)
        sync(DEVICE)
        log(f"traced 20 steps n_r=2 in {time.perf_counter() - t0:.3f}s")
    digest = _trace_summary().summarize(trace_dir, 14)
    if TRACE_KERNEL not in digest:
        raise RuntimeError(
            f"the trace digest does not name {TRACE_KERNEL}, the gradient "
            f"kernel the traced steps ran:\n{digest}")
    out = _out_path("trace_train_chip_summary.txt")
    with open(out, "w") as f:
        f.write(digest + "\n")
    log(f"wrote {out}")
    return digest


def stage_figs():
    from tuplewise_tpu_torch.harness.figures import (
        plot_auc_vs_budget, plot_auc_vs_comm, plot_design_budget,
        plot_learning_curves, plot_sd_vs_comm, plot_triplet_curves,
    )
    import matplotlib  # noqa: F401  (a plain ImportError where missing)

    figs = os.path.join(RESULTS, "figures")
    os.makedirs(figs, exist_ok=True)

    def load(name):
        return read_jsonl(_out_path(name))

    def fig_path(name):
        return os.path.join(figs, _quick_name(name))

    for dataset, fname in (("gaussians", "learning_gauss.jsonl"),
                           ("adult", "learning_adult.jsonl")):
        rows = [r for r in load(fname) if r["pairs_per_worker"] is None]
        if not rows:
            continue
        for N in sorted({r["n_workers"] for r in rows}):
            sub = [r for r in rows if r["n_workers"] == N]
            plot_learning_curves(
                sub, fig_path(f"learning_curves_{dataset}_N{N}.png"),
                title=f"{dataset}, N={N} workers "
                      f"(m={sub[0]['m_per_worker'][0]}/class)")
        plot_auc_vs_comm(
            rows, fig_path(f"learning_auc_vs_comm_{dataset}.png"),
            title=f"{dataset}: final held-out AUC vs communication")
        plot_sd_vs_comm(
            rows, fig_path(f"learning_sd_vs_comm_{dataset}.png"),
            title=f"{dataset}: partition-induced spread vs communication")
    gauss = load("learning_gauss.jsonl")
    b_rows = [r for r in gauss if r["pairs_per_worker"] is not None]
    if b_rows:
        N = b_rows[0]["n_workers"]
        nrs = {r["n_r"] for r in b_rows}
        full = [r for r in gauss if r["pairs_per_worker"] is None
                and r["n_workers"] == N and r["n_r"] in nrs]
        plot_auc_vs_budget(
            b_rows + full, fig_path("learning_auc_vs_budget.png"),
            title=f"gaussians, N={N}: pair budget x repartition")
    d_rows = load("learning_designs.jsonl")
    if d_rows:
        plot_design_budget(
            d_rows, fig_path("learning_design_budget.png"),
            title=f"gaussians, N={d_rows[0]['n_workers']}: pair-budget "
                  "DESIGNS (B/G = 25%, 50% of the per-worker grid)")
    t_rows = load("learning_triplet.jsonl")
    if t_rows:
        plot_triplet_curves(
            t_rows, fig_path("learning_triplet_curves.png"),
            title="degree-3 metric learner, k=2 bottleneck")
    log(f"figures written to {figs}")


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--stages", default=DEFAULT_STAGES,
                    help=f"comma list: {','.join(STAGES)}")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    stages = set(args.stages.split(","))
    if stages - set(STAGES):
        ap.error(f"unknown stages {sorted(stages - set(STAGES))}")
    global QUICK, DEVICE, RESULTS
    DEVICE = driver_device(ap, args.device)
    QUICK = args.quick
    RESULTS = results or RESULTS
    _touched.clear()
    os.makedirs(RESULTS, exist_ok=True)

    q = args.quick
    for name, fn in (("gauss", stage_gauss), ("adult", stage_adult),
                     ("designs", stage_designs), ("prod", stage_prod),
                     ("triplet", stage_triplet), ("mesh8", stage_mesh8),
                     ("chip", stage_chip), ("gauss-chip", stage_gauss_chip),
                     ("trace", stage_trace)):
        if name in stages:
            fn(q)
    # the data stages completed: publish their rows before figs reads
    # them (a crash above leaves the earlier files untouched)
    finalize_outputs()
    if "figs" in stages:
        stage_figs()
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
