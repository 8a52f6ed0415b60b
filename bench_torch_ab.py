#!/usr/bin/env python3
"""Times the logistic pair sums and the triplet hinge sums of two or more
checkouts of the PyTorch port in one run, on one GPU, in turns.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bench_torch_ab.py OTHER_CHECKOUT [MORE ...]

Each checkout (this one first, then the others) is timed in a process of
its own, which builds that checkout's kernels from its own sources, in
the order given and then again in reverse (A, B, B, A for two), so that
a drift of the card's clock over the run shows as a difference between
the two turns of one checkout. Every turn runs the same inputs, made
from one seed on the card, at the shapes of chip_smoke.py's main path:

* ``pair_sum`` with the logistic body at 2^20 x 2^20 (N(1, 1) against
  N(0, 1) scores), phase 5's row;
* ``masked_pair_sum`` with the logistic body at W = 8, 125001 x 125000
  (ragged worker blocks: the last row of 3 workers masked out), phase 5's
  masked row;
* ``batched_masked_pair_sum`` with the hinge combine (margin 1) on the
  distances of 128 anchors and of all 32768 anchors to 32768 positives
  and 32768 negatives, d = 32 (N(0, I) against N(0.3, I)), phase 12b's
  rows; the full width in the chunks of ``triplet_kernels.anchor_chunk``.

A kernel time is the mean of several calls by CUDA events after a
warm-up. After the turns it reads each checkout's built
``csrc/pair_sum.cu`` library with cuobjdump and counts, in the unmasked
logistic kernel, the SASS instructions a pair of the loop that calls
expf once a pair (the loop with the most MUFU.EX2; in a kernel that
factors the exponential, its per-pair branch) and, where there is one,
of the loop with no expf (the factored branch, one MUFU.RCP a pair). It
prints one line a turn, then one JSON object with every turn's times and
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
    ab = torch.randn(8, 125001, generator=g, device="cuda")
    bb = torch.randn(8, 125000, generator=g, device="cuda")
    ma, mb = torch.ones_like(ab), torch.ones_like(bb)
    ma[5:, -1] = 0.0
    t, s = ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, logistic), 3)
    out["masked_pair_sum[logistic]"] = (t, float(s.sum()))
    del a, b, ab, bb, ma, mb

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


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--turn":
        _turn()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_ab: no CUDA device is available", file=sys.stderr)
        return 2
    roots = [ROOT] + [os.path.abspath(r) for r in sys.argv[1:]]
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
            [sys.executable, os.path.abspath(__file__), "--turn"], cwd=root,
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 4
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"root": root, "times": times})
        print(f"[turn] {root}: " + "; ".join(
            f"{k} {v[0]:.3f} ms" for k, v in times.items()), flush=True)
    sass = {root: logistic_sass(root) for root in roots}
    for root, counts in sass.items():
        print(f"[sass] {root}: logistic kernel, SASS instructions a pair: "
              + "; ".join(f"{k} {v:.3f}" for k, v in counts.items()),
              flush=True)
    print(json.dumps({"turns": turns, "sass_per_pair": sass, "card": card}),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
