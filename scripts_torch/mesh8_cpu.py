"""Distributed-semantics evidence on an 8-worker mesh (the counterpart of
the JAX package's ``scripts/mesh8_cpu.py``; the file keeps that name so a
reader finds it).

The reference runs its mesh backend over 8 virtual CPU devices. The port
runs the same 8 workers on the card's worker axis (``parallel.mesh``,
``parallel.comm.LocalComm``: one device, the workers on a leading axis of
its tensors), and ``--device cpu`` gives the reference's CPU run. The
script Monte-Carlos each scheme on the mesh backend, so the committed
rows show the N = 8 distributed estimators producing the statistics the
closed forms predict (unbiased means, ordered variances): the seven 1-D
configs at 8192 a class, M = 100, in chunks of 25 reps. A second section
runs the 2-D (dcn = 2 x ici = 4) double ring, with a ragged 8197 / 8187
shape, and the non-difference kernel kinds (scatter one-sample with
global-id exclusion; the degree-3 triplet double ring) through the mesh
Monte-Carlo runner (``harness.mesh_mc``).

Writes ``<results>/mesh8_cpu.jsonl`` and ``<results>/mesh8_2d_cpu.jsonl``
(default ``results/torch/``); every row carries ``card``.

Usage: python scripts_torch/mesh8_cpu.py [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device,
)
from tuplewise_tpu_torch.harness.mesh_mc import (  # noqa: E402
    make_mesh_mc_runner,
)
from tuplewise_tpu_torch.harness.variance import (  # noqa: E402
    VarianceConfig, run_variance_experiment, write_jsonl,
)
from tuplewise_tpu_torch.parallel.mesh import make_mesh_2d  # noqa: E402
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

# the reference's sizes: per class n, reps M, the chunk of reps; the
# ragged 2-D shape, scatter's sample, the triplet double ring's classes
N, M, CHUNK = 8192, 100, 25
RAGGED = (8197, 8187)
SCATTER_N, TRIPLET_N = 4096, 96
ROUNDS_1D, PAIRS_1D = (1, 4, 16), (1_000, 100_000)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _fresh(path: str) -> str:
    if os.path.exists(path):
        os.remove(path)
    return path


def main_1d(device, results):
    """The seven 1-D configs through the harness on backend="mesh"."""
    out = _fresh(os.path.join(results, "mesh8_cpu.jsonl"))
    base = VarianceConfig(backend="mesh", n_workers=8, n_pos=N, n_neg=N,
                          n_reps=M)
    runs = [base, dataclasses.replace(base, scheme="local")]
    runs += [dataclasses.replace(base, scheme="repartitioned", n_rounds=T)
             for T in ROUNDS_1D]
    runs += [dataclasses.replace(base, scheme="incomplete", n_pairs=B)
             for B in PAIRS_1D]
    t0 = time.perf_counter()
    for cfg in runs:
        r = run_variance_experiment(cfg, checkpoint_every=CHUNK,
                                    device=device)
        r["vmapped"] = r.pop("batched")
        r["devices"] = r.pop("device")
        r["card"] = card_of(device)
        write_jsonl([r], out)
        print(json.dumps({
            "scheme": cfg.scheme, "T": cfg.n_rounds, "B": cfg.n_pairs,
            "mean": round(r["mean"], 6),
            "variance": r["variance"],
        }), flush=True)
    log(f"# wrote {out} in {time.perf_counter() - t0:.1f}s")


def main_2d_and_kernels(device, results):
    """The 2-D hierarchical ring and the non-difference kernel kinds,
    through the mesh Monte-Carlo runner."""
    out = _fresh(os.path.join(results, "mesh8_2d_cpu.jsonl"))
    mesh2d = make_mesh_2d(2, 4, device)
    base = VarianceConfig(backend="mesh", n_workers=8, n_pos=N, n_neg=N,
                          n_reps=M)
    rows = [
        # the 2-D dcn x ici double ring, every scheme, a ragged size too
        ("2d", base),
        ("2d", dataclasses.replace(base, scheme="local")),
        ("2d", dataclasses.replace(base, scheme="repartitioned",
                                   n_rounds=4)),
        ("2d", dataclasses.replace(base, n_pos=RAGGED[0],
                                   n_neg=RAGGED[1])),
        # the kernel-kind matrix on the 1-D mesh: scatter (one-sample,
        # population E h = dim) and degree-3 triplet (double ring)
        ("1d", dataclasses.replace(base, kernel="scatter", n_pos=SCATTER_N,
                                   n_neg=SCATTER_N)),
        ("1d", dataclasses.replace(base, kernel="triplet_indicator",
                                   n_pos=TRIPLET_N, n_neg=TRIPLET_N,
                                   dim=3)),
    ]
    t0 = time.perf_counter()
    for topo, cfg in rows:
        runner = make_mesh_mc_runner(
            cfg, mesh=mesh2d if topo == "2d" else None, device=device)
        t = time.perf_counter()
        ests = runner(range(cfg.n_reps))     # on the host: synchronised
        r = {
            "config": cfg.to_json(),
            "mesh": "dcn2 x ici4" if topo == "2d" else "w8",
            "mean": float(ests.mean()),
            "variance": float(ests.var(ddof=1)),
            "std_error": float(ests.std(ddof=1) / np.sqrt(cfg.n_reps)),
            "vmapped": True,
            "n_reps": cfg.n_reps,
            "wallclock_s": time.perf_counter() - t,
            "devices": str(device),
            "card": card_of(device),
        }
        write_jsonl([r], out)
        print(json.dumps({
            "mesh": r["mesh"], "kernel": cfg.kernel,
            "scheme": cfg.scheme, "n": [cfg.n_pos, cfg.n_neg],
            "mean": round(r["mean"], 6), "variance": r["variance"],
        }), flush=True)
    log(f"# wrote {out} in {time.perf_counter() - t0:.1f}s")


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    results = results or RESULTS
    os.makedirs(results, exist_ok=True)
    main_1d(device, results)
    main_2d_and_kernels(device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
