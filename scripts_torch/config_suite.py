"""BASELINE.json benchmark suite of the port: one row per BASELINE config
(the counterpart of the JAX package's ``scripts/config_suite.py``).

The host oracles (numpy, and the C++ engine where g++ builds it) are the
baseline, the port's kernels on the card the build. Emits
``<results>/configs.jsonl``, one line per config:

  1 AUC U-statistic, Gaussians, n = 10k: numpy vs torch vs cpp parity
    and pairs/s (kernel 1)
  2 bipartite ranking, pairwise hinge, the Adult surrogate: AUC lift and
    steps/s (kernels 3-4)
  2b the learner's gradient throughput: the analytic g' mean
    (kernels 3-4) against autograd through the tiled plain mean
  3 incomplete U, n = 10^6, B = 10^4
  4 degree-3 triplet statistic on MNIST embeddings: numpy vs torch, and
    the complete degree-3 throughput grid through kernel 5
    (``<results>/triplet_scaling.jsonl``)
  5 the mesh backend's ring at n = 10^7 total, one worker a card

Rows keep the JAX script's schema with "torch" where it writes "jax";
each timed row carries ``card``. A config that fails on the card leaves
an error row, the suite goes on, and ``main`` returns 1 at the end; only
the host oracles may be reported unavailable.

Usage: python scripts_torch/config_suite.py [--quick] [--configs 1,2,...]
       [--device cpu]
(``--device``: the torch device, default the card; ``main(argv,
results=DIR)`` writes into DIR instead of results/torch/.)
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device, n_devices, sync, utc_stamp,
)
from tuplewise_tpu_torch.harness.variance import HOST_BACKENDS  # noqa: E402
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402
from tuplewise_tpu_torch.utils.results_io import quick_sibling  # noqa: E402

QUICK = False   # set by main(); stamped so quick rows can't pass as full
DEVICE = torch.device("cpu")   # set by main()


def log(msg):
    print(f"[configs] {msg}", file=sys.stderr, flush=True)


def emit(rec, out):
    if QUICK:
        rec["quick"] = True
    rec["ts"] = utc_stamp()
    out.write(json.dumps(rec) + "\n")
    out.flush()
    log(json.dumps(rec))


def timed(fn, reps=3):
    fn()  # warm: kernels built and loaded outside the clock
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def config1(out, q):
    """AUC U-stat on Gaussians, n = 10k total: parity + pairs/s."""
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.estimators.estimator import Estimator

    n = 640 if q else 5000
    X, Y = make_gaussians(n, n, dim=1, separation=1.0, seed=0)
    s1, s2 = X[:, 0], Y[:, 0]
    vals, rates = {}, {}
    for backend in ("numpy", "torch", "cpp"):
        if backend in HOST_BACKENDS:
            try:
                est = Estimator("auc", backend=backend)
            except RuntimeError as e:   # a host oracle without its build
                log(f"config1: {backend} unavailable: {e!r}")
                continue
        else:
            est = Estimator("auc", backend=backend, device=DEVICE)
        vals[backend] = float(est.complete(s1, s2))
        rates[backend] = n * n / timed(lambda: est.complete(s1, s2))
    emit({
        "config": 1, "name": "auc_gaussians_n10k",
        "n_pos": n, "n_neg": n, "estimates": vals,
        "pairs_per_s": {k: round(v, 1) for k, v in rates.items()},
        "max_parity_delta": max(
            abs(v - vals["numpy"]) for v in vals.values()
        ),
        "card": card_of(DEVICE),
    }, out)


def config2(out, q):
    """Pairwise hinge bipartite ranking on the (surrogate) UCI Adult,
    held out: train on the train split, report train AND test AUC."""
    from tuplewise_tpu_torch.data import load_adult_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, evaluate_auc, split_by_label, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    n = 400 if q else 8000
    steps = 20 if q else 200
    X, y, Xte, yte, meta = load_adult_splits(n=n, seed=0)
    Xp, Xn = split_by_label(X, y)
    Xp_te, Xn_te = split_by_label(Xte, yte)
    scorer = LinearScorer(dim=Xp.shape[1])
    p0 = scorer.init(0)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=steps,
                      n_workers=min(4, n_devices(DEVICE)),
                      repartition_every=10, seed=0)
    train_pairwise(scorer, p0, Xp, Xn, cfg, device=DEVICE)   # warm
    t0 = time.perf_counter()
    params, hist = train_pairwise(scorer, p0, Xp, Xn, cfg, device=DEVICE)
    dt = time.perf_counter() - t0

    def auc(p, A, B):
        return evaluate_auc(scorer, p, A, B, device=DEVICE)

    auc_tr0, auc_tr1 = auc(p0, Xp, Xn), auc(params, Xp, Xn)
    auc_te0, auc_te1 = auc(p0, Xp_te, Xn_te), auc(params, Xp_te, Xn_te)
    fig = None
    try:
        import matplotlib  # noqa: F401  (the figure is drawn on the host)
    except ImportError as e:
        log(f"config2: no learning-curve figure: {e!r}")
    else:
        from tuplewise_tpu_torch.harness.figures import plot_learning_curve

        figdir = os.path.join(RESULTS, "figures")
        os.makedirs(figdir, exist_ok=True)
        fig = plot_learning_curve(
            hist, os.path.join(figdir, quick_sibling(
                "learning_curve_adult.png", QUICK)),
            auc_before=auc_te0, auc_after=auc_te1,
        )
    emit({
        "config": 2, "name": "pairwise_hinge_adult",
        "n": n, "steps": steps, "n_workers": cfg.n_workers,
        "n_test": len(Xte),
        "data_synthetic": bool(meta["synthetic"]),
        "split": meta.get("split"),
        "auc_train_before": auc_tr0, "auc_train": auc_tr1,
        "auc_test_before": auc_te0, "auc_test": auc_te1,
        "loss_first": float(hist["loss"][0]),
        "loss_last": float(hist["loss"][-1]),
        "steps_per_s": round(steps / dt, 2),
        "figure": fig,
        "card": card_of(DEVICE),
    }, out)


def tiled_mean(kernel, s1, s2, tile):
    """The plain tiled pair mean (``ops.pair_tiles.pair_stats``) with each
    row block of ``tile`` scores recomputed in the backward
    (``torch.utils.checkpoint``): autograd through the tiles at bounded
    memory, the counterpart of the JAX package's checkpointed tiles."""
    from torch.utils.checkpoint import checkpoint

    from tuplewise_tpu_torch.ops import pair_tiles

    def row_sum(a):
        return pair_tiles.pair_stats(kernel, a, s2, tile_a=tile,
                                     tile_b=tile)[0]

    total = sum(checkpoint(row_sum, s1[i0:i0 + tile], use_reentrant=False)
                for i0 in range(0, s1.shape[0], tile))
    return total / float(s1.shape[0] * s2.shape[0])


def config2b(out, q):
    """Gradient throughput of the pairwise learner's hot loop: SGD steps
    on the full pair grid through both gradient paths, the analytic
    streamed g' (``ops.pair_tiles.diff_pair_mean``: kernels 3-4, the
    trainer's path for hinge and logistic) against autograd through the
    tiled plain mean (the path of kernels without an analytic g')."""
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.ops import pair_tiles
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    n = 512 if q else 100_000   # per class
    steps = 3 if q else 10
    tile = 2048
    kernel = get_kernel("hinge")
    Xp, Xn = make_gaussians(n, n, dim=5, separation=1.0, seed=1)
    Xp = torch.as_tensor(Xp, dtype=torch.float32, device=DEVICE)
    Xn = torch.as_tensor(Xn, dtype=torch.float32, device=DEVICE)
    scorer = LinearScorer(dim=5)
    p0 = {k: torch.as_tensor(v, dtype=torch.float32, device=DEVICE)
          for k, v in scorer.init(1).items()}
    rng = np.random.default_rng(2)

    rates = {}
    for label, mean_fn in (
        ("analytic_gp", lambda s1, s2: pair_tiles.diff_pair_mean(
            kernel, s1, s2)),
        ("autodiff_tiles", lambda s1, s2: tiled_mean(kernel, s1, s2,
                                                     tile)),
    ):
        def run(p):
            p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            for _ in range(steps):
                loss = mean_fn(scorer.score(p, Xp), scorer.score(p, Xn))
                grads = torch.autograd.grad(loss, list(p.values()))
                with torch.no_grad():
                    p = {k: (v - 0.1 * g).requires_grad_(True)
                         for (k, v), g in zip(p.items(), grads)}
            # the host read ends the clock after the last step's update
            return float(sum(v.detach().sum() for v in p.values()))

        run(p0)   # warm: kernels built and loaded outside the clock
        ts = []
        for _ in range(3):
            pp = {k: v + 1e-6 * torch.as_tensor(
                      rng.standard_normal(tuple(v.shape)),
                      dtype=torch.float32, device=DEVICE)
                  for k, v in p0.items()}
            sync(DEVICE)
            t0 = time.perf_counter()
            run(pp)
            ts.append(time.perf_counter() - t0)
        rates[label] = round(steps * n * n / min(ts), 1)
    emit({
        "config": "2b", "name": "pairwise_grad_throughput",
        "n_pos": n, "n_neg": n, "steps": steps, "tile": tile,
        "grad_pairs_per_s": rates,
        "card": card_of(DEVICE),
    }, out)


def config3(out, q):
    """Incomplete U at n = 10^6 total, B = 10^4 (the Monte-Carlo row of
    this cell is northstar's ``pairs_n1e6.jsonl``)."""
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.estimators.estimator import Estimator

    n = 1000 if q else 500_000
    X, Y = make_gaussians(n, n, dim=1, separation=1.0, seed=0)
    s1, s2 = X[:, 0], Y[:, 0]
    est = Estimator("auc", backend="torch", device=DEVICE)
    val = float(est.incomplete(s1, s2, n_pairs=10_000, seed=0))
    dt = timed(lambda: est.incomplete(s1, s2, n_pairs=10_000, seed=0))
    emit({
        "config": 3, "name": "incomplete_n1e6_B1e4",
        "n_pos": n, "n_neg": n, "B": 10_000, "estimate": val,
        "seconds_per_estimate": round(dt, 5),
        "mc_reference": "results/torch/pairs_n1e6.jsonl",
        "card": card_of(DEVICE),
    }, out)


def triplet_rate(est, rng, nt, d, reps):
    """Complete-triplet throughput at one (n, d) shape: distinct inputs
    per rep, made resident on the device before the clock (a host input
    would put its copy inside the timed window), the value read back to
    the host inside it. The whole statistic is one call; kernel 5 walks
    the anchors in its own chunks."""
    inputs = [
        (torch.as_tensor(rng.standard_normal((nt, d)).astype(np.float32),
                         device=DEVICE),
         torch.as_tensor((rng.standard_normal((nt, d)) + 0.3)
                         .astype(np.float32), device=DEVICE))
        for _ in range(reps + 1)
    ]
    sync(DEVICE)
    est.complete(*inputs[0])           # warm outside the timer
    times = []
    for X, Y in inputs[1:]:
        t1 = time.perf_counter()
        est.complete(X, Y)             # float() inside = synced
        times.append(time.perf_counter() - t1)
    return float(nt) * (nt - 1) * nt / min(times), min(times)


def config4(out, q):
    """Degree-3 triplet statistic on MNIST embeddings (the surrogate
    unless real IDX files are in TUPLEWISE_DATA_DIR), and the complete
    degree-3 throughput grid through kernel 5. Returns the number of
    failed grid cells."""
    from tuplewise_tpu_torch.estimators.estimator import Estimator
    from tuplewise_tpu_torch.harness.triplet_experiment import (
        triplet_mnist_statistic,
    )

    n = 200 if q else 2000
    r_np = triplet_mnist_statistic(
        kernel="triplet_indicator", backend="numpy", n=n,
        n_pairs=20_000, seed=0,
    )
    t0 = time.perf_counter()
    r_t = triplet_mnist_statistic(
        kernel="triplet_indicator", backend="torch", n=n,
        n_pairs=20_000, seed=0, device=DEVICE,
    )
    dt = time.perf_counter() - t0

    # the scaling grid of the JAX script: the rate should rise with n
    # (the O(n^2 d) distance phase against the O(n^3) combine) and fall
    # with d at fixed n; reps shrink at the big shapes
    rng = np.random.default_rng(0)
    est_t = Estimator("triplet_indicator", backend="torch", device=DEVICE)
    grid = ([(256, 8, 3)] if q else [
        (4096, 16, 3), (4096, 32, 3), (4096, 128, 3),
        (16384, 16, 2), (16384, 32, 2), (16384, 128, 2),
        (32768, 16, 1), (32768, 32, 1), (32768, 128, 1),
        (65536, 32, 1),
    ])
    scale_rows = []
    for nt, d, reps in grid:
        try:
            r, dt_min = triplet_rate(est_t, rng, nt, d, reps)
        except Exception as e:   # one cell must not void the grid
            log(f"config4 scaling n={nt} d={d} FAILED: {e!r}")
            scale_rows.append({
                "n": nt, "dim": d, "reps": reps, "error": repr(e)[:300],
            })
            continue
        scale_rows.append({
            "n": nt, "dim": d, "reps": reps,
            "triplets_per_s": round(r, 1),
            "seconds": round(dt_min, 3),
            "card": card_of(DEVICE),
        })
        log(f"config4 scaling n={nt} d={d}: {r:.3e} triplets/s "
            f"({dt_min:.3f}s)")
    spath = os.path.join(RESULTS,
                         quick_sibling("triplet_scaling.jsonl", QUICK))
    with open(spath + ".partial", "w") as f:
        for r in scale_rows:
            r["ts"] = utc_stamp()
            f.write(json.dumps(r) + "\n")
    os.replace(spath + ".partial", spath)

    failed = sum("error" in r for r in scale_rows)
    ok_rows = [r for r in scale_rows if "error" not in r]
    if not ok_rows:
        # every cell failed: still emit the config row so the
        # error-annotated grid is on record
        emit({
            "config": 4, "name": "triplet_mnist", "n": n,
            "numpy": r_np, "torch": r_t,
            "torch_seconds_total": round(dt, 3),
            "scaling_error": "all scaling cells failed; see "
                             + os.path.basename(spath),
            "card": card_of(DEVICE),
        }, out)
        return failed
    big = max(ok_rows, key=lambda r: (r["n"], r["triplets_per_s"]))
    emit({
        "config": 4, "name": "triplet_mnist",
        "n": n, "numpy": r_np, "torch": r_t,
        "torch_seconds_total": round(dt, 3),
        # headline = the largest-n rate; the full grid is
        # results/torch/triplet_scaling.jsonl
        "complete_triplets_per_s": big["triplets_per_s"],
        "complete_throughput_shape": {"n_anchors": big["n"],
                                      "dim": big["dim"]},
        "scaling_file": "results/torch/triplet_scaling.jsonl",
        "card": card_of(DEVICE),
    }, out)
    return failed


def config5(out, q):
    """Cross-shard ring all-pairs at n = 10^7 total: the mesh backend's
    ring (kernel 1 at each stop, kernel 2 where a shard is padded) with
    one worker a card, as the JAX script's ``jax.device_count()``."""
    from tuplewise_tpu_torch.backends.mesh_backend import MeshBackend
    from tuplewise_tpu_torch.ops.kernels import get_kernel
    from tuplewise_tpu_torch.parallel.device_partition import pack_blocks

    n = 1000 if q else 5_000_000   # per class; 2n = 10^7 total
    rng = np.random.default_rng(5)
    be = MeshBackend(get_kernel("auc"), n_workers=n_devices(DEVICE),
                     device=DEVICE)
    pa = pack_blocks(be.to_device(rng.standard_normal(n).astype(
        np.float32)), be.mesh)
    pb = pack_blocks(be.to_device(rng.standard_normal(n).astype(
        np.float32)), be.mesh)

    no_masks = n % be.n_shards == 0   # same padding guard as .complete()

    def go():
        (a, ma, ia), (b, mb, ib) = pa, pb
        s, c = be.complete_stats(a, ma, ia, b, mb, ib, no_masks=no_masks)
        return float(s) / float(c)

    val = go()
    dt = timed(go, reps=1 if not q else 2)
    emit({
        "config": 5, "name": "ring_all_pairs_n1e7",
        "n_pos": n, "n_neg": n, "n_shards": be.n_shards,
        "impl": be.impl, "estimate": val,
        "pairs_per_s_per_chip": round(n * n / dt / be.n_shards, 1),
        "seconds": round(dt, 2),
        "multi_shard_evidence":
            "tests/test_torch_mesh_backend.py + test_torch_ring.py (8 "
            "workers on one device) + chip_smoke.py phase 24 (8 workers "
            "on the card)",
        "card": card_of(DEVICE),
    }, out)


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--configs", default="1,2,2b,3,4,5")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    global QUICK, DEVICE, RESULTS
    DEVICE = driver_device(ap, args.device)
    QUICK = args.quick
    RESULTS = results or RESULTS
    os.makedirs(RESULTS, exist_ok=True)

    # quick runs write a sibling file: a smoke run never replaces the
    # full-run rows
    path = os.path.join(RESULTS, quick_sibling("configs.jsonl", QUICK))
    wanted = set(args.configs.split(","))
    fns = {"1": config1, "2": config2, "2b": config2b, "3": config3,
           "4": config4, "5": config5}
    if wanted - set(fns):
        ap.error(f"unknown configs {sorted(wanted - set(fns))}; choose "
                 f"from {sorted(fns)}")
    # a subset run replaces only ITS rows
    keep = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if str(rec.get("config")) not in wanted:
                    keep.append(line)
    # after every config, the kept rows and everything finished so far
    # are rewritten into a .partial sibling and renamed onto the file: a
    # crash mid-config loses only that config's rows
    done_rows, failed = [], []
    partial = path + ".partial"
    for key in sorted(wanted):
        buf = io.StringIO()
        try:
            if fns[key](buf, args.quick):
                failed.append(f"{key} (scaling cells)")
        except Exception as e:  # keep the suite going; record why
            log(f"config {key} FAILED: {e!r}")
            emit({"config": key, "error": repr(e)}, buf)
            failed.append(key)
        done_rows.append(buf.getvalue())
        with open(partial, "w") as out:
            out.writelines(keep)
            out.writelines(done_rows)
        os.replace(partial, path)
    log(f"wrote {path}")
    if failed:
        log(f"FAILED configs: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
