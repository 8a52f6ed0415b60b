"""North-star experiment driver of the port (the counterpart of the JAX
package's ``scripts/northstar.py``).

Runs the paper-shaped suite on the card and writes every artifact the
trade-off figures need, into ``<results>`` (default ``results/torch/``):

  variance_n1e6.jsonl   complete/local at n=10^6 (M=200)
  rounds_n1e6.jsonl     repartitioned T in {1,2,4,8,16} (M=200)
  pairs_n1e6.jsonl      incomplete B in {1e3..1e7}     (M=200)
  variance_n1e7.jsonl   complete/local at n=10^7 (M=32)
  rounds_n1e7.jsonl     repartitioned T in {1,2,4,8}  (M=16)
  pairs_n1e7.jsonl      incomplete B in {1e3..1e7}    (M=64)
  tradeoff_*.jsonl      the visible trade-off regime (M=800)
  designs_*.jsonl       the sampling designs, measured
  mesh_n1e6.jsonl       the mesh backend (ring), one worker a card
  exact_n1e{6,7,8}.jsonl  the O(n log n) rank-AUC series
  pairs_n1e8.jsonl      incomplete at n=10^8
  serving.jsonl         the serving replay
  figures/*.png         the paper-shaped figures

"n" is the TOTAL sample size (n_pos = n_neg = n/2). Wall-clocks are the
harness's compute-only clocks (kernels built before the clock starts,
each chunk's clock stopped after its estimates reach the host). Chunked
execution (``checkpoint_every``) bounds device memory. Rows keep the JAX
script's schema: "torch" where it writes "jax", ``vmapped`` true where
the harness batches the reps, ``platform`` the torch device type; every
row also carries ``card``.

Usage: python scripts_torch/northstar.py [--quick] [--stages 1e6,1e7,...]
       [--device cpu]
(``--device``: the torch device, default the card; ``main(argv,
results=DIR)`` writes into DIR.) ``figs`` needs matplotlib and fails with
an ImportError where it is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import uuid

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device, n_devices, platform_of, read_jsonl, sync,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402
from tuplewise_tpu_torch.harness.variance import (  # noqa: E402
    VarianceConfig, run_variance_experiment, write_jsonl,
)
from tuplewise_tpu_torch.utils.results_io import (  # noqa: E402
    is_quick, quick_sibling, strip_quick,
)

T0 = time.perf_counter()
QUICK = False    # set by main(); quick output never touches full files
DEVICE = torch.device("cpu")   # set by main()
STAGES = ("1e6", "1e7", "tradeoff", "designs", "mesh", "exact", "scale8",
          "serve", "figs")


def log(msg):
    print(f"[northstar +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _qname(name: str) -> str:
    return quick_sibling(name, QUICK)


def _out(name: str) -> str:
    return os.path.join(RESULTS, _qname(name))


_touched = set()


def _fresh(path: str) -> None:
    """Truncate an output once per invocation, so re-running a stage
    never duplicates rows."""
    if path not in _touched:
        _touched.add(path)
        if os.path.exists(path):
            os.remove(path)


def harness_row(r: dict) -> dict:
    """A harness result in the JAX script's row schema: ``platform`` for
    the device, ``vmapped`` for ``batched``, plus the card."""
    row = {"config": r["config"], "platform": platform_of(DEVICE)}
    row.update((k, r[k]) for k in ("mean", "variance", "std_error",
                                   "wallclock_s"))
    row["vmapped"] = r["batched"]
    row.update((k, r[k]) for k in ("n_reps", "recovery"))
    row.update((k, r[k]) for k in ("trace_dir", "population_value")
               if k in r)
    row["card"] = card_of(DEVICE)
    return row


def run(cfg, out, chunk=None, trace_dir=None):
    path = _out(out)
    _fresh(path)
    r = harness_row(run_variance_experiment(
        cfg, checkpoint_every=chunk, trace_dir=trace_dir, device=DEVICE))
    write_jsonl([r], path)
    log(f"{out}: scheme={cfg.scheme} N={cfg.n_workers} T={cfg.n_rounds} "
        f"B={cfg.n_pairs} var={r['variance']:.3e} "
        f"wc={r['wallclock_s']:.3f}s")
    return r


def exact_rep(n: int, rep: int, seed: int = 0) -> float:
    """One rep of the exact series: fresh Gaussians from the rep's own
    generator (the JAX script's (seed, "mc_rep", rep, "data") chain),
    reduced by the O(n log n) rank AUC (``ops.rank_auc``)."""
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc
    from tuplewise_tpu_torch.utils.rng import generator

    g = generator(seed, "mc_rep", rep, "data", device=DEVICE)
    s1 = torch.randn(n, generator=g, device=DEVICE) + 1.0
    s2 = torch.randn(n, generator=g, device=DEVICE)
    return float(rank_auc(s1, s2))


def exact_row(n: int, M: int, wc: float, ests) -> dict:
    ests = np.asarray(ests)
    return {
        "config": {
            "kernel": "auc", "scheme": "complete",
            "estimator": "rank_auc_exact", "backend": "torch",
            "n_pos": n, "n_neg": n, "dim": 1,
            "separation": 1.0, "n_workers": 1, "n_rounds": 1,
            "n_pairs": 0, "partition_scheme": "swor",
            "n_reps": M, "seed": 0,
        },
        "mean": float(ests.mean()),
        "variance": float(ests.var(ddof=1)),
        "std_error": float(ests.std(ddof=1) / np.sqrt(M)),
        "wallclock_s": wc,
    }


def exact_series(n: int, M: int):
    """(estimates, wall-clock) of M exact reps, one dispatch a rep, the
    clock over the reps (each rep's value read back inside it) after one
    warm rep."""
    exact_rep(n, M)                  # warm: a rep outside the series
    sync(DEVICE)
    ests, wc = [], 0.0
    for rep in range(M):
        t0 = time.perf_counter()
        ests.append(exact_rep(n, rep))
        wc += time.perf_counter() - t0
    return ests, wc


def stage_1e6(base6, q):
    log(f"== stage n=1e6 (n_pos=n_neg={base6.n_pos}, M={base6.n_reps}) ==")
    run(base6, "variance_n1e6.jsonl", chunk=None if q else 8)
    run(dataclasses.replace(base6, scheme="local"),
        "variance_n1e6.jsonl", chunk=None if q else 8)
    for T in (1, 2, 4, 8, 16):
        run(dataclasses.replace(base6, scheme="repartitioned", n_rounds=T),
            "rounds_n1e6.jsonl", chunk=None if q else 8)
    for B in (1_000, 10_000, 100_000, 1_000_000, 10_000_000):
        if q and B > 100_000:
            continue
        run(dataclasses.replace(base6, scheme="incomplete", n_pairs=B),
            "pairs_n1e6.jsonl", chunk=None if q else 25)


def stage_1e7(base7, q):
    m7r = 4 if q else 16
    log(f"== stage n=1e7 (n_pos=n_neg={base7.n_pos}, M={base7.n_reps}) ==")
    run(base7, "variance_n1e7.jsonl", chunk=None if q else 1)
    run(dataclasses.replace(base7, scheme="local"),
        "variance_n1e7.jsonl", chunk=None if q else 1)
    for T in (1, 2, 4, 8):
        run(dataclasses.replace(base7, scheme="repartitioned", n_rounds=T,
                                n_reps=m7r),
            "rounds_n1e7.jsonl", chunk=None if q else 1)
    for B in (1_000, 10_000, 100_000, 1_000_000, 10_000_000):
        if q and B > 100_000:
            continue
        run(dataclasses.replace(base7, scheme="incomplete", n_pairs=B,
                                n_reps=4 if q else 64),
            "pairs_n1e7.jsonl", chunk=None if q else 8)


def stage_tradeoff(base6, q):
    """The paper's visible trade-off regime: many workers, small blocks
    (the local-average deficit ~ zeta_11/(n m) needs m in the tens). N
    sweep for the local estimator, T sweeps at the two smallest block
    sizes, plus the closed-form Hoeffding prediction for the overlay."""
    mt = 8 if q else 800
    n6 = base6.n_pos
    baset = dataclasses.replace(base6, n_reps=mt)
    log(f"== stage tradeoff (n_pos=n_neg={n6}, M={mt}) ==")
    run(baset, "tradeoff_complete.jsonl", chunk=None if q else 8)
    n_sweep = (2, 4) if q else (8, 100, 1000, 12500, 125000, 250000)
    for N in n_sweep:
        run(dataclasses.replace(baset, scheme="local", n_workers=N),
            "tradeoff_workers.jsonl", chunk=None if q else 8)
    rounds_n = (4,) if q else (125000, 250000)
    for N in rounds_n:
        for T in (1, 2) if q else (1, 2, 4, 8, 16, 32):
            run(dataclasses.replace(baset, scheme="repartitioned",
                                    n_workers=N, n_rounds=T),
                f"tradeoff_rounds_N{N}.jsonl", chunk=None if q else 25)
    # plug-in zetas on a 20k sample -> the closed-form overlay curves
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.estimators.variance import (
        two_sample_variance_from_zetas, two_sample_zetas,
    )

    Xz, Yz = make_gaussians(20_000, 20_000, 1, 1.0, seed=7)
    zetas = two_sample_zetas("auc", Xz[:, 0], Yz[:, 0])
    vc = two_sample_variance_from_zetas(zetas, n6, n6)

    def v_loc(N):
        return two_sample_variance_from_zetas(zetas, n6 // N, n6 // N) / N

    theory = {
        "zetas": list(zetas),
        "complete": vc,
        "workers": [[int(N), v_loc(N)] for N in n_sweep],
        "rounds": {
            str(N): [[T, vc + max(v_loc(N) - vc, 0.0) / T]
                     for T in (1, 2, 4, 8, 16, 32)]
            for N in rounds_n
        },
    }
    with open(_out("tradeoff_theory.json"), "w") as f:
        json.dump(theory, f, indent=1)
    log("tradeoff stage done (theory overlay written)")


def stage_designs(base6, q):
    """The sampling designs measured: at the headline scale (B << G,
    swor and bernoulli variance-neutral against swr), then conditional on
    one frozen dataset (fix_data), where the audit's closed forms are
    exact: pairs at n = 500 a class and triplets at n = 40 (G = 62400)."""
    log("== stage sampling designs (swor/bernoulli, measured) ==")
    for design in ("swor", "bernoulli"):
        for B in (1_000, 10_000, 100_000):
            if q and B > 10_000:
                continue
            run(dataclasses.replace(base6, scheme="incomplete", n_pairs=B,
                                    design=design),
                "designs_n1e6.jsonl", chunk=None if q else 25)
    mC = 8 if q else 2_000
    baseC = VarianceConfig(n_pos=500, n_neg=500, separation=1.0,
                           n_workers=2, n_reps=mC, fix_data=True)
    for design in ("swr", "swor", "bernoulli"):
        for B in (25_000, 125_000):
            if q and B > 25_000:
                continue
            run(dataclasses.replace(baseC, scheme="incomplete", n_pairs=B,
                                    design=design),
                "designs_conditional.jsonl", chunk=None if q else 250)
    GT = 40 * 39 * 40
    baseT = VarianceConfig(kernel="triplet_indicator", n_pos=40, n_neg=40,
                           dim=3, separation=1.0, n_workers=2, n_reps=mC,
                           fix_data=True)
    for design in ("swr", "swor", "bernoulli"):
        for B in (GT // 10, GT // 2):
            if q and B > GT // 10:
                continue
            run(dataclasses.replace(baseT, scheme="incomplete", n_pairs=B,
                                    design=design),
                "designs_conditional.jsonl", chunk=None if q else 250)


def stage_mesh(base6, q):
    """The distributed estimator on the card: the mesh backend's ring,
    one worker a card (the JAX script's ``jax.device_count()``), the
    Monte-Carlo on the workers, with torch.profiler traces of the
    complete and repartitioned runs."""
    from tuplewise_tpu_torch.utils.profiling import device_memory_stats

    nw = n_devices(DEVICE)
    log(f"== stage mesh ({nw}-worker mesh, device={DEVICE}) ==")
    mesh6 = dataclasses.replace(base6, backend="mesh", n_workers=nw,
                                n_reps=8 if q else 50)
    run(mesh6, "mesh_n1e6.jsonl", chunk=None if q else 4,
        trace_dir=_out("trace_mesh_complete"))
    run(dataclasses.replace(mesh6, scheme="repartitioned", n_rounds=4),
        "mesh_n1e6.jsonl", chunk=None if q else 4,
        trace_dir=_out("trace_mesh_repart"))
    run(dataclasses.replace(mesh6, scheme="local"), "mesh_n1e6.jsonl",
        chunk=None if q else 4)
    # the designed incomplete through the mesh: distinct tuple sets drawn
    # on the device per rep; the swr row prices the design's extra cost
    for design in ("swr", "swor"):
        run(dataclasses.replace(mesh6, scheme="incomplete",
                                n_pairs=100_000, design=design,
                                n_reps=8 if q else 50),
            "mesh_n1e6.jsonl", chunk=None if q else 10)
    # the allocator's high-water of the mesh stage (cards that report it)
    for dev, stats in device_memory_stats().items():
        log(f"memory {dev}: "
            + ", ".join(f"{k}={v}" for k, v in sorted(stats.items())
                        if "bytes" in k and k.endswith(".all.peak")))


def stage_exact(n6, n7, m6, m7):
    """The AUC statistic's O(n log n) exact path (``ops.rank_auc``: one
    sort and two searches a positive): the same Monte-Carlo protocol as
    the 1e6 and 1e7 stages, fresh Gaussian draws a rep on the device.
    The complete rows price the generic kernel; this series prices
    exactness for the AUC."""
    log("== stage exact (rank-AUC fast path) ==")
    for scale, n, M in (("n1e6", n6, m6), ("n1e7", n7, m7)):
        ests, wc = exact_series(n, M)
        row = exact_row(n, M, wc, ests)
        # one dispatch a rep, looped on the host: not a batched program
        row.update(vmapped=False, n_reps=M, card=card_of(DEVICE))
        path = _out(f"exact_{scale}.jsonl")
        _fresh(path)
        write_jsonl([row], path)
        log(f"exact_{scale}: var={row['variance']:.3e} "
            f"wc={wc:.3f}s for M={M} ({wc / M * 1e3:.2f} ms/rep)")


def stage_scale8(q):
    """n = 10^8 TOTAL samples: the O(n log n) exact rank statistic (one
    rep's 400 MB of scores at a time, one dispatch a rep) and the
    incomplete family."""
    n8 = 4_000 if q else 50_000_000     # per class; 10^8 total
    M8 = 2 if q else 8
    log(f"== stage scale8 (n_pos=n_neg={n8}, M={M8}) ==")
    ests, wc = exact_series(n8, M8)
    row = exact_row(n8, M8, wc, ests)
    row.update(vmapped=False, dispatch="per_rep", n_reps=M8,
               card=card_of(DEVICE))
    path = _out("exact_n1e8.jsonl")
    _fresh(path)
    write_jsonl([row], path)
    log(f"exact_n1e8: var={row['variance']:.3e} wc={wc:.3f}s "
        f"({wc / M8 * 1e3:.1f} ms/rep)")
    base8 = VarianceConfig(n_pos=n8, n_neg=n8, n_workers=8, n_reps=M8)
    for B in (100_000, 10_000_000, 100_000_000):
        if q and B > 100_000:
            continue
        run(dataclasses.replace(base8, scheme="incomplete", n_pairs=B),
            "pairs_n1e8.jsonl", chunk=None if q else 4)


def serve_cells(nS: int):
    """The JAX script's serving cells (bounded closed-loop submission,
    64 in flight; the sync-compaction cell is the on-thread baseline of
    the bg-compaction p99), the mesh-sharded pair where the host has at
    least 4 cards, and one cell of the port's with the fused count
    kernel (kernel 6, one launch a micro-batch) beside its
    searchsorted twin."""
    cells = [
        {"max_batch": 256, "budget": 64},        # sync compaction
        {"max_batch": 256, "budget": 64, "bg_compact": True},
        {"max_batch": 256, "budget": 4, "bg_compact": True},
        {"max_batch": 256, "budget": 64, "window": nS // 4,
         "bg_compact": True},
        {"max_batch": 1, "budget": 64},          # unbatched baseline
        {"max_batch": 256, "budget": 64, "bg_compact": True,
         "count_kernel": True},
    ]
    if n_devices(DEVICE) >= 4:
        cells.insert(2, {"max_batch": 256, "budget": 64,
                         "bg_compact": True, "mesh_shards": 4})
        cells.insert(3, {"max_batch": 256, "budget": 64,
                         "bg_compact": True, "mesh_shards": 4,
                         "delta_fraction": 0.0})
    return cells


def stage_serve(q):
    """The online serving replay: one row a configuration cell (events/s,
    latency percentiles, batch fill, the exact-vs-oracle parity
    guardrail) into ``serving.jsonl`` of the results directory."""
    from tuplewise_tpu_torch.serving import ServingConfig
    from tuplewise_tpu_torch.serving.replay import make_stream, replay

    nS = 2_000 if q else 300_000
    log(f"== stage serve (replay, n_events={nS}) ==")
    sS, lS = make_stream(nS, pos_frac=0.5, separation=1.0, seed=0)
    run_id = uuid.uuid4().hex[:12]
    path = _out("serving.jsonl")
    _fresh(path)
    p99s = {}
    for cell in serve_cells(nS):
        cfg = ServingConfig(policy="block", flush_timeout_s=0.0005,
                            compact_every=1024, device=str(DEVICE), **cell)
        # the unbatched baseline prices coalescing; a shorter stream
        # bounds its wall time
        nCell = min(nS, 50_000) if cell.get("max_batch") == 1 else nS
        rec = replay(sS[:nCell], lS[:nCell], config=cfg, warmup=not q,
                     max_inflight=64, run_id=run_id)
        rec["stage"] = "serve"
        rec["max_inflight"] = 64
        rec["card"] = card_of(DEVICE)
        write_jsonl([rec], path)
        if (cell.get("max_batch") != 1 and "window" not in cell
                and cell.get("budget") == 64
                and "mesh_shards" not in cell
                and "count_kernel" not in cell):
            p99s[bool(cell.get("bg_compact"))] = rec["insert_latency_p99_ms"]
        log(f"serve {cell}: {rec['events_per_s']:.0f} ev/s "
            f"insert p99={rec['insert_latency_p99_ms']:.1f}ms "
            f"pause p99={rec['compaction_pause_p99_ms']} "
            f"fill={rec['mean_batch_fill']:.2f} "
            f"auc_err={rec.get('auc_abs_err')}")
    if True in p99s and False in p99s and p99s[True]:
        log(f"serve: bg-compaction p99 insert win = "
            f"{p99s[False] / p99s[True]:.1f}x "
            f"(sync {p99s[False]:.1f}ms -> bg {p99s[True]:.1f}ms)")


def stage_figs():
    log("== stage figures ==")
    from tuplewise_tpu_torch.harness.figures import (
        plot_frontier, plot_variance_vs_pairs, plot_variance_vs_rounds,
        plot_variance_vs_wallclock, plot_variance_vs_workers,
    )
    import matplotlib  # noqa: F401  (a plain ImportError where missing)

    def load(name):
        return read_jsonl(_out(name))

    figs = os.path.join(RESULTS, "figures")
    os.makedirs(figs, exist_ok=True)

    def fig(name):
        return os.path.join(figs, _qname(name))

    for scale in ("n1e6", "n1e7"):
        rounds = load(f"rounds_{scale}.jsonl")
        var = load(f"variance_{scale}.jsonl")
        pairs = load(f"pairs_{scale}.jsonl")
        exact = load(f"exact_{scale}.jsonl")
        comp = next(
            (r for r in var if r["config"]["scheme"] == "complete"), None)
        if rounds:
            plot_variance_vs_rounds(
                rounds, fig(f"var_vs_rounds_{scale}.png"), baseline=comp)
            plot_variance_vs_wallclock(
                rounds + ([comp] if comp else []),
                fig(f"var_vs_wallclock_{scale}.png"))
        if pairs:
            plot_variance_vs_pairs(pairs, fig(f"var_vs_pairs_{scale}.png"))
        if var or rounds or pairs:
            plot_frontier(
                {
                    "complete $U_n$ (generic kernel)":
                        [comp] if comp else [],
                    "local average": [
                        r for r in var
                        if r["config"]["scheme"] == "local"
                    ],
                    "repartitioned T=1..": rounds,
                    "incomplete B sweep": pairs,
                    "exact rank-AUC ($O(n\\log n)$)": exact,
                },
                fig(f"frontier_{scale}.png"),
            )
    # trade-off-regime figures with the closed-form overlay
    tthe = {}
    tpath = _out("tradeoff_theory.json")
    if os.path.exists(tpath):
        with open(tpath) as f:
            tthe = json.load(f)
    tcomp = load("tradeoff_complete.jsonl")
    tcomp = tcomp[0] if tcomp else None
    workers = load("tradeoff_workers.jsonl")
    if workers:
        plot_variance_vs_workers(workers, fig("var_vs_workers.png"),
                                 baseline=tcomp, theory=tthe.get("workers"))
    for name in sorted(os.listdir(RESULTS)):
        if not name.startswith("tradeoff_rounds_N"):
            continue
        # quick inputs pair with quick figures
        if is_quick(name) != QUICK:
            continue
        base = strip_quick(name)
        N = base[len("tradeoff_rounds_N"):-len(".jsonl")]
        plot_variance_vs_rounds(
            load(base), fig(f"var_vs_rounds_N{N}.png"), baseline=tcomp,
            theory=(tthe.get("rounds") or {}).get(N))
    log(f"figures written to {figs}")


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--stages", type=str, default=",".join(STAGES),
                    help=f"comma list of stages to run: {','.join(STAGES)}")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    stages = set(args.stages.split(","))
    if stages - set(STAGES):
        ap.error(f"unknown stages {sorted(stages - set(STAGES))}; "
                 f"choose from {sorted(STAGES)}")
    global QUICK, DEVICE, RESULTS
    DEVICE = driver_device(ap, args.device)
    QUICK = args.quick
    RESULTS = results or RESULTS
    _touched.clear()
    os.makedirs(RESULTS, exist_ok=True)

    q = args.quick
    # n here is PER CLASS: n_pos = n_neg = n/2 of the total sample size
    n6 = 1_000 if q else 500_000          # "n = 10^6"
    n7 = 2_000 if q else 5_000_000        # "n = 10^7"
    m6 = 8 if q else 200
    m7 = 4 if q else 32
    base6 = VarianceConfig(n_pos=n6, n_neg=n6, n_workers=8, n_reps=m6)
    base7 = VarianceConfig(n_pos=n7, n_neg=n7, n_workers=8, n_reps=m7)

    if "1e6" in stages:
        stage_1e6(base6, q)
    if "1e7" in stages:
        stage_1e7(base7, q)
    if "tradeoff" in stages:
        stage_tradeoff(base6, q)
    if "designs" in stages:
        stage_designs(base6, q)
    if "mesh" in stages:
        stage_mesh(base6, q)
    if "exact" in stages:
        stage_exact(n6, n7, m6, m7)
    if "scale8" in stages:
        stage_scale8(q)
    if "serve" in stages:
        stage_serve(q)
    if "figs" in stages:
        stage_figs()
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
