#!/usr/bin/env python3
"""Times the logistic and hinge pair sums, the masked pair sums, the
triplet hinge sums, the gradient pair sums, the fleet's tenant counts and
the index's signed counts of two or more checkouts of the PyTorch port in one run, on one GPU, in
turns.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bench_torch_ab.py OTHER_CHECKOUT [MORE ...]

Each checkout (this one first, then the others) is timed in a process of
its own, which builds that checkout's kernels from its own sources, in
the order given and then again in reverse (A, B, B, A for two), so that
a drift of the card's clock over the run shows as a difference between
the two turns of one checkout. Every turn runs the same inputs, made
from one seed on the card, at the shapes of chip_smoke.py's main path:

* ``pair_sum`` with the logistic and the hinge body at 2^20 x 2^20
  (N(1, 1) against N(0, 1) scores), phase 5's rows;
* ``masked_pair_sum`` with the logistic, auc and hinge bodies at W = 8,
  125001 x 125000 (ragged worker blocks: the last row of 3 workers masked
  out), phase 5's masked rows, and around the masked auc and hinge the
  Estimator backend's ragged local round (``local_round_from_blocks``,
  N = 8 blocks of 10^6 + 5 / 10^6 scores), phase 3's, also by
  torch.profiler's device time a call ("<row> device");
* ``batched_masked_pair_sum`` with the hinge combine (margin 1) on the
  distances of 128 anchors and of all 32768 anchors to 32768 positives
  and 32768 negatives, d = 32 (N(0, I) against N(0.3, I)), phase 12b's
  rows; the full width in the chunks of ``triplet_kernels.anchor_chunk``;
* ``pair_loss_grad`` and ``pair_grad_sums`` (kernels 3-4) with the hinge
  and the logistic body at W = 1, 5e5 x 5e5 (N(0.3, 0.5) against
  N(0, 0.5) scores, phase 6's rows) and at the simulated learner's batch,
  W = 1536 problems of 16 x 16 (there, host-bound calls, also
  torch.profiler's device time a call, "<row> device");
* the learner around them: 20 hinge steps of ``train_pairwise`` at
  n = 5e5 per class (loss_every 1, chip_smoke.py phase 7's first run)
  and one 500-step ``train_curves`` cell of the gauss sweep (S = 48
  seeds x N = 32 workers, phase 10), wall-clock by CUDA events around
  calls that end on the host;
* ``tenant_count`` (kernel 7) at phase 20's headline: T_bucket 1024,
  the packs of make_tenant_stream(10^6, 1024, skew 1.1, seed 0) at caps
  2^17 and the last 256-event apply's query block (chip_smoke.py's own
  helpers), timed by torch.profiler's device time a launch (its "ms";
  CUDA events a call beside it);
* ``signed_count`` (kernel 6) at phase 16's headline (two runs of 500000
  values on a 1/64 grid at cap 2^19, 512 queries a set, half of them run
  values) and at the index's shape (two runs of 250000 N(0, 1) values at
  cap 2^18, 255 and 257 N(0, 1) queries), timed the same way.

With ``--harness`` (``python3 bench_torch_ab.py --harness OTHER ...``)
the turns time the variance harness instead, and nothing else: one
``batched_estimates`` call (auc, M = 64 reps, seed 0) with its estimates
copied to the host, by the host's clock (the harness's own wall-clock
metric, less the closed form, which the parent computes at n = 10^6 over
the whole grid), at chip_smoke.py phase 4's four cells (n = 10^4 a
class, N = 8 workers, T = 4 rounds, B = 10^4 with-replacement pairs) and
at config 3's incomplete cell (n = 10^6, B = 10^4, swr): the median and
the least of 7 calls after a warm-up.

With ``--counts`` the turns time only kernels 7 and 6 at the shapes
above (a check that a kernel's other forms left its flat form's time
alone), about a minute a turn.

With ``--trainers`` the turns time the learners end to end instead,
and nothing else: 20 hinge steps of ``train_pairwise`` at n = 5e5 per
class, N = 1 (chip_smoke.py phase 7's data; repartition_every 1 with
loss_every 1, and 10 with the loss never recorded), and 300 steps of
``train_triplet`` at phase 14's gauss-overlap cell (seed 0, N = 8, B =
4096, repartition_every 1, no evaluation), by the host's clock around
calls that end on the host: the median and the best of 5 calls after a
warm-up, as steps/s (the best is the most steps/s).

A kernel time is the mean of several calls by CUDA events after a
warm-up. After the turns it reads each checkout's built
``csrc/pair_sum.cu`` library with cuobjdump and counts, in the unmasked
logistic kernel, the SASS instructions a pair of the loop that calls
expf once a pair (the loop with the most MUFU.EX2; in a kernel that
factors the exponential, its per-pair branch) and, where there is one,
of the loop with no expf (the factored branch, one MUFU.RCP a pair); and
in each logistic gradient kernel (``csrc/pair_grad.cu``, with and
without the loss) the instructions a pair of the loop that calls expf
once a pair or, where the kernel has several forms of a chunk's pairs,
of each form's straight-line body (chip_smoke.grad_loops). It prints one
line a turn, then one JSON object with every turn's times and
sums and each checkout's counts, the card's name and power limit as
nvidia-smi gives them. Without a CUDA device it exits nonzero.
"""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0


HARNESS_CELLS = (
    ("complete", dict(scheme="complete")),
    ("local", dict(scheme="local")),
    ("repartitioned", dict(scheme="repartitioned", n_rounds=4)),
    ("incomplete", dict(scheme="incomplete")),
    ("incomplete config 3", dict(scheme="incomplete", n_pos=10 ** 6,
                                 n_neg=10 ** 6)),
)


def _harness_turn():
    """One checkout's harness wall-clocks (ms: median, least of 7)."""
    import statistics
    import time

    sys.path.insert(0, os.getcwd())
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, batched_estimates,
    )

    def once(cfg):
        t0 = time.perf_counter()
        batched_estimates(cfg, "cuda").cpu()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for tag, kw in HARNESS_CELLS:
        cfg = VarianceConfig(**{**dict(kernel="auc", n_pos=10_000,
                                       n_neg=10_000, n_workers=8,
                                       n_pairs=10_000, n_reps=64,
                                       seed=SEED), **kw})
        once(cfg)                                         # warm-up
        runs = [once(cfg) for _ in range(7)]
        out[f"harness {tag}"] = (statistics.median(runs), min(runs))
    print(json.dumps(out), flush=True)


def _trainers_turn():
    """One checkout's learner steps/s (median, best of 5 calls)."""
    import statistics
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from tuplewise_tpu_torch.data import make_gaussian_splits, make_gaussians
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, init_embed, train_triplet,
    )

    def rates(fn, steps):
        fn()                                              # warm-up
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(steps / (time.perf_counter() - t0))
        return statistics.median(runs), max(runs)

    Xp, Xn, _, _ = make_gaussian_splits(500_000, 125_000, dim=5, seed=0)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    out = {}
    for nr, le in ((1, 1), (10, 1 << 30)):
        cfg = TrainConfig(kernel="hinge", lr=0.3, n_workers=1,
                          repartition_every=nr, seed=7, tile=2048,
                          loss_every=le, steps=20)
        out[f"train_pairwise n_r={nr} loss_every={le}"] = rates(
            lambda: train_pairwise(scorer, p0, Xp, Xn, cfg), 20)
    # chip_smoke.triplet_task("gauss-overlap", 0): the same draws
    rng = np.random.default_rng(0)
    X, Y = make_gaussians(2_000, 6_000, dim=16, separation=1.0, seed=0)
    Xc = np.asarray(X, np.float32)[rng.permutation(2_000)[:1_500]]
    Xo = np.asarray(Y, np.float32)[rng.permutation(6_000)[:4_500]]
    tcfg = TripletTrainConfig(lr=0.1, steps=300, n_workers=8,
                              repartition_every=1, triplets_per_worker=4_096,
                              seed=1_000, embed_dim=2)
    out["train_triplet 300 steps"] = rates(
        lambda: train_triplet(init_embed(16, 2), Xc, Xo, tcfg), 300)
    print(json.dumps(out), flush=True)


def _turn():
    """One checkout's times (the current directory's package)."""
    import torch

    sys.path.insert(0, os.getcwd())
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops import triplet_kernels as tk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def ms(fn, reps):
        fn()                                              # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    out = {}
    logistic = get_kernel("logistic")
    n = 1 << 20
    a = torch.randn(n, generator=g, device="cuda") + 1.0
    b = torch.randn(n, generator=g, device="cuda")
    t, s = ms(lambda: pk.pair_sum(a, b, logistic), 3)
    out["pair_sum[logistic]"] = (t, float(s))
    t, s = ms(lambda: pk.pair_sum(a, b, get_kernel("hinge")), 20)
    out["pair_sum[hinge]"] = (t, float(s))
    ab = torch.randn(8, 125001, generator=g, device="cuda")
    bb = torch.randn(8, 125000, generator=g, device="cuda")
    ma, mb = torch.ones_like(ab), torch.ones_like(bb)
    ma[5:, -1] = 0.0
    t, s = ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, logistic), 3)
    out["masked_pair_sum[logistic]"] = (t, float(s.sum()))
    for name in ("auc", "hinge"):
        k = get_kernel(name)
        t, s = ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, k), 20)
        out[f"masked_pair_sum[{name}]"] = (t, float(s.sum()))
    del a, b, ab, bb, ma, mb

    import chip_smoke as cs
    from tuplewise_tpu_torch import Estimator
    n = 10 ** 6
    s1 = torch.randn(n + 5, generator=g, device="cuda") + 1.0
    s2 = torch.randn(n, generator=g, device="cuda")
    i1, i2 = cs.ragged_blocks(g, n + 5, 8), cs.ragged_blocks(g, n, 8)
    for name in ("auc", "hinge"):
        be = Estimator(name, backend="torch").backend
        t, v = ms(lambda: float(be.local_round_from_blocks(s1, s2, i1, i2)),
                  5)
        out[f"ragged local round[{name}]"] = (t, v)
        _, dev, _ = cs.timed_on_device(
            lambda: be.local_round_from_blocks(s1, s2, i1, i2), 5)
        out[f"ragged local round[{name}] device"] = (dev, 0.0)
    del s1, s2, i1, i2

    m = 32768
    X = torch.randn(m, 32, generator=g, device="cuda")
    Y = torch.randn(m, 32, generator=g, device="cuda") + 0.3
    comb = tk.triplet_combine_kernel(get_kernel("triplet_hinge"))
    ids = torch.arange(m, device="cuda")
    ones = torch.ones(1, m, device="cuda")

    def hinge(A, B, ia):
        return tk.batched_masked_pair_sum(A, B, ones, ids[None], ia, ones,
                                          comb)

    c = 128
    A, B = tk.sqdist_matrix(X[:c], X), tk.sqdist_matrix(X[:c], Y)
    t, s = ms(lambda: hinge(A, B, ids[:c]), 3)
    out["batched_masked_pair_sum[triplet_hinge]"] = (t, float(s.sum()))
    del A, B
    total_ms, total = 0.0, 0.0
    chunk = tk.anchor_chunk(1, m, m, m, X.device)
    for a0, d_pa, d_an in tk.distance_chunks(X[None], X[None], Y[None],
                                             chunk):
        ia = ids[a0:a0 + d_pa.shape[1]]
        t, s = ms(lambda: hinge(d_pa[0], d_an[0], ia), 1)
        total_ms += t
        total += float(s.sum())
        del d_pa, d_an
    out["batched_masked_pair_sum[triplet_hinge] full"] = (total_ms, total)
    del X, Y, ids, ones

    from tuplewise_tpu_torch.ops import pair_grad_kernels as pg
    for W, n1, n2, tag in [(1, 500_000, 500_000, ""),
                           (1536, 16, 16, " 1536x16x16")]:
        a = torch.randn(W, n1, generator=g, device="cuda") * 0.5 + 0.3
        b = torch.randn(W, n2, generator=g, device="cuda") * 0.5
        for name in ("hinge", "logistic"):
            k = get_kernel(name)
            reps = 2 if name == "logistic" and W == 1 else 20
            t, (s, _, _) = ms(lambda: pg.pair_loss_grad(a, b, k), reps)
            out[f"pair_loss_grad[{name}]{tag}"] = (t, float(s.sum()))
            t, (r, _) = ms(lambda: pg.pair_grad_sums(a, b, k), reps)
            out[f"pair_grad_sums[{name}]{tag}"] = (t, float(r.sum()))
            if W > 1:
                # host-bound calls: their device time a call beside
                for wrapper, fn in (("pair_loss_grad", pg.pair_loss_grad),
                                    ("pair_grad_sums", pg.pair_grad_sums)):
                    _, dev, _ = cs.timed_on_device(lambda: fn(a, b, k), 50)
                    out[f"{wrapper}[{name}]{tag} device"] = (dev, 0.0)
    del a, b

    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.sim_learner import train_curves

    Xp, Xn, _, _ = make_gaussian_splits(500_000, 1000, dim=5, seed=0)
    scorer = LinearScorer(dim=5)
    cfg = TrainConfig(kernel="hinge", lr=0.3, n_workers=1,
                      repartition_every=1, seed=7, tile=2048, loss_every=1,
                      steps=20)
    t, (_, hist) = ms(lambda: train_pairwise(scorer, scorer.init(0), Xp, Xn,
                                             cfg), 1)
    out["train_pairwise[hinge] 20 steps"] = (t, float(hist["loss"][-1]))
    Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(512, 20000, dim=10,
                                                separation=0.8, seed=0)
    scorer = LinearScorer(dim=10)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=500, seed=1000,
                      n_workers=32, repartition_every=5)
    t, res = ms(lambda: train_curves(scorer, scorer.init(0), Xp, Xn, Xp_te,
                                     Xn_te, cfg, n_seeds=48, eval_every=25),
                1)
    out["train_curves[hinge] cell"] = (t, float(res["loss"].mean()))

    _count_times(out, g, cs)
    print(json.dumps(out), flush=True)


def _count_times(out, g, cs):
    """Kernels 7 and 6 at their headlines (the module note) into out."""
    import torch

    from tuplewise_tpu_torch.ops import count_kernels as ck
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    scores, labels, tids = cs.fleet_stream(cs.FLEET_EVENTS, cs.FLEET_TENANTS)
    pos, neg, _, _ = cs.fleet_packs(scores, labels, tids, cs.FLEET_TENANTS)
    last = cs.fleet_chunks(scores[-cs.FLEET_CHUNK:], labels[-cs.FLEET_CHUNK:],
                           tids[-cs.FLEET_CHUNK:], cs.FLEET_CHUNK)[0]
    qn, qp = cs.apply_queries(last, cs.FLEET_TENANTS)
    ck.tenant_count(pos, neg, qn, qp)                     # warm-up
    call_ms, t, got = cs.timed_on_device(
        lambda: ck.tenant_count(pos, neg, qn, qp), 200)
    out["tenant_count"] = (t, int(got.long().sum()))
    out["tenant_count call"] = (call_ms, int(got.long().sum()))

    for tag, grid, n, (la, lb) in (("", True, cs.COUNT_BASE, (512, 512)),
                                   (" index", False, 250_000, (255, 257))):
        vals = [torch.randn(n, generator=g, device="cuda") + shift
                for shift in (0.0, 1.0)]
        if grid:
            vals = [torch.round(v * 64) / 64 for v in vals]
        vals = [torch.sort(v).values for v in vals]
        runs = [cs.padded(v, sc.next_bucket(n)) for v in vals]
        if grid:
            qa = cs.tied_queries(g, la, vals[0])
            qb = cs.tied_queries(g, lb, vals[1])
        else:
            qa = torch.randn(la, generator=g, device="cuda")
            qb = torch.randn(lb, generator=g, device="cuda")
        args = (runs, [1, 1], [0, 1], qa, qb)
        ck.signed_count(*args)                            # warm-up
        call_ms, t, got = cs.timed_on_device(
            lambda: ck.signed_count(*args), 1000)
        out[f"signed_count{tag}"] = (t, int(got.long().sum()))
        out[f"signed_count{tag} call"] = (call_ms, int(got.long().sum()))


def _counts_turn():
    """One checkout's times of kernels 7 and 6 alone (``--counts``)."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    out = {}
    _count_times(out, torch.Generator(device="cuda").manual_seed(SEED), cs)
    print(json.dumps(out), flush=True)


def logistic_sass(root):
    """{"expf loop": instructions a pair, "factored loop": ...} of the
    unmasked logistic kernel in root's built pair_sum library."""
    from chip_smoke import count_ops, sass_loops
    from tuplewise_tpu_torch.ops import _build

    lib, = glob.glob(os.path.join(root, "tuplewise_tpu_torch", "_build",
                                  "libpair_sum_*.so"))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    func, = [f for f in sass.split("Function : ")[1:]
             if "ogistic" in f.split("\n")[0] and "Lb0E" in f.split("\n")[0]]
    loops = sass_loops(func.splitlines())
    expf = max(loops, key=lambda lp: count_ops(lp, "MUFU.EX2"))
    out = {"expf loop": len(expf) / count_ops(expf, "MUFU.EX2")}
    fact = [lp for lp in loops if count_ops(lp, "MUFU.EX2") == 0
            and count_ops(lp, "MUFU.RCP") >= 8]
    if fact:
        best = max(fact, key=lambda lp: count_ops(lp, "MUFU.RCP"))
        out["factored loop"] = len(best) / count_ops(best, "MUFU.RCP")
    return out


def grad_sass(root):
    """{"<wrapper> <form>": instructions a pair} of the logistic gradient
    kernels in root's built pair_grad library (see the module note)."""
    from chip_smoke import count_ops, cuobjdump_sass, grad_loops, sass_loops

    lib, = glob.glob(os.path.join(root, "tuplewise_tpu_torch", "_build",
                                  "libpair_grad_*.so"))
    sass = cuobjdump_sass(lib)
    if "logistic_grad_kernel" in sass:
        return {f"{w} {form}": n / m
                for (w, form), (n, m) in grad_loops(sass).items()}
    out = {}
    # a kernel that calls expf for g' and for g: one MUFU.EX2 a pair
    # without the loss, two with it
    for wrapper, mangled, ex2 in (("pair_grad_sums", "Lb0E", 1),
                                  ("pair_loss_grad", "Lb1E", 2)):
        func, = [f for f in sass.split("Function : ")[1:]
                 if "LogisticBody" in f.split("\n")[0]
                 and mangled in f.split("\n")[0]]
        loop = max(sass_loops(func.splitlines()),
                   key=lambda lp: count_ops(lp, "MUFU.EX2"))
        out[f"{wrapper} expf loop"] = (len(loop) * ex2
                                       / count_ops(loop, "MUFU.EX2"))
    return out


def main():
    mode = next((m for m in ("--harness", "--trainers", "--counts")
                 if m in sys.argv), None)
    args = [a for a in sys.argv[1:] if a != mode]
    if args[:1] == ["--turn"]:
        {"--harness": _harness_turn, "--trainers": _trainers_turn,
         "--counts": _counts_turn}.get(mode, _turn)()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_ab: no CUDA device is available", file=sys.stderr)
        return 2
    roots = [ROOT] + [os.path.abspath(r) for r in args]
    for r in roots:
        if not os.path.isdir(os.path.join(r, "tuplewise_tpu_torch")):
            print(f"bench_torch_ab: {r} holds no tuplewise_tpu_torch",
                  file=sys.stderr)
            return 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    turns = []
    for root in roots + roots[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             *([mode] if mode else [])], cwd=root,
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 4
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"root": root, "times": times})
        unit = "steps/s" if mode == "--trainers" else "ms"
        print(f"[turn] {root}: " + "; ".join(
            f"{k} {v[0]:.3f} {unit}" for k, v in times.items()), flush=True)
    sass = {} if mode else {
        root: {**logistic_sass(root), **grad_sass(root)} for root in roots}
    for root, counts in sass.items():
        print(f"[sass] {root}: logistic kernels, SASS instructions a pair: "
              + "; ".join(f"{k} {v:.3f}" for k, v in counts.items()),
              flush=True)
    print(json.dumps({"turns": turns, "sass_per_pair": sass, "card": card}),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
