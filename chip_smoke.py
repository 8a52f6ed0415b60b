#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (tuplewise_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA pair kernels from tuplewise_tpu_torch/csrc with nvcc,
then runs five phases. Each phase asserts what it checks, and nothing is
caught: any failure exits nonzero.

1. Build: compile the kernels and print the build seconds.
2. Kernel vs plain: pair_sum and masked_pair_sum for auc, hinge and
   logistic at a ragged size (4133 x 8197), batched (W = 8), at
   2^14 x 2^14 and at the harness's local-round batch (W = 512,
   1250 x 1250), each against its plain PyTorch version on the same card.
   AUC must be equal exactly (both sum halves exactly: float32 below 2^23
   per partial, float64 above). hinge and logistic must agree within rel
   1e-5: both sum float32 values, in different orders.
3. Main path at full size, through Estimator(kernel, backend="torch") on
   the default device: complete at n = 2^20 and 2^20 + 64 per class (AUC
   with auc_fast=False, which must equal rank_auc exactly), local_average
   and repartitioned (N = 8, T = 4, n = 10^6), a local round over a
   ragged partition that keeps every row (the masked kernel), and
   incomplete (n = 10^6, B = 10^4), each timed with CUDA events.
4. Variance harness (BASELINE config 1): M = 64 batched reps at n = 10^4
   per class for the complete, local (N = 8), repartitioned (T = 4) and
   incomplete (B = 10^4) schemes; the Monte-Carlo variance must sit in
   the chi-square band of the closed form (see CHI2_BAND). Each scheme
   runs once to warm up before its timed run.
5. Timing at the main-path shapes: each kernel, its plain version and,
   for AUC, rank_auc, with CUDA events; and the bound. Each timed kernel
   result is held against its plain result as in phase 2, and that
   full-size error of the mean is the row's max_abs_err (phase 2's is
   max_abs_err_small).

The launch counters are set to 0 before phase 3 and read after phase 4:
every kernel must have been launched on the main path. The script prints
one JSON line of kernels, the card's name and power limit as nvidia-smi
reports them, and, last, {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside it, it exits nonzero and prints no
result.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NAMES = ("auc", "hinge", "logistic")
SEED = 0
# chi2(63)/63 two-sided 1e-4 quantiles: the band of s^2 / sigma^2 for
# M = 64 reps; the plug-in closed form's own few-percent error fits in it
CHI2_BAND = (0.45, 1.85)
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per pair, counted from the body: the subtraction and
# the accumulating add, plus auc 3 (two compares, a select), hinge 2
# (1 - d, max), logistic 5 (abs, exp, log1p, max, add); the masked kernel
# adds a multiply. exp and log1p count as one operation each, which makes
# the bound a lower one.
OPS_PER_PAIR = {"auc": 5, "hinge": 4, "logistic": 7}
REPLACES = {
    "pair_sum": "tuplewise_tpu/ops/pallas_pairs.py:134",
    "masked_pair_sum": "tuplewise_tpu/ops/pallas_pairs.py:300",
}
SOURCE = "tuplewise_tpu_torch/csrc/pair_sum.cu"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=1):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from tuplewise_tpu_torch.ops import _build, pair_kernels

    t0 = time.perf_counter()
    pair_kernels.load_library()
    log(f"[build] {SOURCE} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS})")


def check_against_plain(name, got, want, count, what):
    """Assert a kernel result against its plain version (AUC exactly,
    hinge/logistic within rel 1e-5) and return the absolute error of the
    statistic the caller forms, sum / count."""
    torch.cuda.synchronize()
    if name == "auc":
        assert torch.equal(got, want), (name, what)
    else:
        rel = float(((got - want).abs() / want.abs()).max())
        assert rel < 1e-5, (name, what, rel)
    return float(((got - want) / count).abs().max())


def phase_kernel_vs_plain(errs):
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED)
    # ragged, batched, square, and the harness's local round (M = 64 reps
    # x N = 8 workers of 10^4 / 8 rows per class)
    for W, n1, n2 in [(1, 4133, 8197), (8, 4133, 8197), (1, 1 << 14, 1 << 14),
                      (512, 1250, 1250)]:
        a = torch.randn(W, n1, generator=g, device="cuda") + 1.0
        b = torch.randn(W, n2, generator=g, device="cuda")
        a[:, :97] = b[:, :97]                      # exact ties
        ma = (torch.rand(W, n1, generator=g, device="cuda") > 0.3).float()
        mb = (torch.rand(W, n2, generator=g, device="cuda") > 0.3).float()
        for name in NAMES:
            k = get_kernel(name)
            cases = {
                "pair_sum": (pk.pair_sum(a, b, k),
                             pk.pair_sum(a, b, k, impl="plain"),
                             float(n1 * n2)),
                "masked_pair_sum": (
                    pk.masked_pair_sum(a, b, ma, mb, k),
                    pk.masked_pair_sum(a, b, ma, mb, k, impl="plain"),
                    ma.sum(1, dtype=torch.float64)
                    * mb.sum(1, dtype=torch.float64)),
            }
            for wrapper, (got, want, count) in cases.items():
                err = check_against_plain(name, got, want, count,
                                          (wrapper, W, n1, n2))
                key = f"{wrapper}[{name}]"
                errs[key] = max(errs.get(key, 0.0), err)
        log(f"[kernel vs plain] W={W} {n1}x{n2}: auc exact, hinge/logistic "
            f"within rel 1e-5")


def ragged_blocks(gen, n, n_workers):
    """A partition of range(n) that keeps every row: blocks of
    ceil(n/N) or floor(n/N) rows, padded with -1."""
    perm = torch.randperm(n, generator=gen, device="cuda")
    m = -(-n // n_workers)
    blocks = torch.full((n_workers * m,), -1, dtype=torch.int64, device="cuda")
    sizes = [n // n_workers + (w < n % n_workers) for w in range(n_workers)]
    at = 0
    for w, size in enumerate(sizes):
        blocks[w * m:w * m + size] = perm[at:at + size]
        at += size
    return blocks.reshape(n_workers, m)


def phase_main_path(launches_by_phase):
    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.data import true_gaussian_auc
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    truth = true_gaussian_auc(1.0)

    def scores(n):
        return (torch.randn(n, generator=g, device="cuda") + 1.0,
                torch.randn(n, generator=g, device="cuda"))

    def snapshot(label, before):
        delta = {k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
                 if v - before.get(k, 0)}
        launches_by_phase[label] = delta
        return dict(pk.LAUNCHES)

    seen = dict(pk.LAUNCHES)
    for n in (1 << 20, (1 << 20) + 64):
        s1, s2 = scores(n)
        for name in NAMES:
            est = Estimator(name, backend="torch", auc_fast=False)
            ms, val = cuda_ms(lambda: est.complete(s1, s2))
            assert math.isfinite(val), (name, n, val)
            log(f"[main] complete {name:8s} n={n}: {val:.9f}  "
                f"{n * n / ms * 1e3:.4g} pairs/s ({ms:.1f} ms)")
            if name == "auc":
                exact = float(rank_auc(s1, s2))
                assert val == exact, (val, exact)
                assert val == Estimator("auc", backend="torch").complete(s1, s2)
                assert abs(val - truth) < 5e-3, (val, truth)
    seen = snapshot("complete", seen)

    n = 10 ** 6
    s1, s2 = scores(n)
    for name in NAMES:
        est = Estimator(name, backend="torch", n_workers=8)
        full = est.complete(s1, s2)
        ms, loc = cuda_ms(lambda: est.local_average(s1, s2, seed=SEED))
        ms_r, rep = cuda_ms(lambda: est.repartitioned(s1, s2, n_rounds=4,
                                                      seed=SEED))
        ms_i, inc = cuda_ms(lambda: est.incomplete(s1, s2, n_pairs=10_000,
                                                   seed=SEED))
        for v, tol in [(loc, 0.01), (rep, 0.01), (inc, 0.1)]:
            assert math.isfinite(v) and abs(v - full) < tol, (name, v, full)
        per_round = 8 * (n // 8) ** 2
        log(f"[main] {name:8s} n={n} complete {full:.6f} local {loc:.6f} "
            f"({per_round / ms * 1e3:.4g} pairs/s) repartitioned(T=4) "
            f"{rep:.6f} ({4 * per_round / ms_r * 1e3:.4g} pairs/s) "
            f"incomplete(B=1e4) {inc:.6f} ({ms_i:.3f} ms)")
    seen = snapshot("local+repartitioned", seen)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    s1, s2 = scores(n + 5)
    i1, i2 = ragged_blocks(gen, n + 5, 8), ragged_blocks(gen, n, 8)
    for name in NAMES:
        be = Estimator(name, backend="torch").backend
        val = float(be.local_round_from_blocks(s1, s2, i1, i2))
        full = Estimator(name, backend="torch").complete(s1, s2)
        assert math.isfinite(val) and abs(val - full) < 0.01, (name, val)
        log(f"[main] ragged local round {name:8s} (blocks of "
            f"{i1.shape[1]}/{i1.shape[1] - 1} rows): {val:.6f}")
    snapshot("ragged local round", seen)
    return i1, i2


def phase_harness(launches_by_phase):
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, run_variance_experiment,
    )
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    before = dict(pk.LAUNCHES)
    for scheme in ("complete", "local", "repartitioned", "incomplete"):
        cfg = VarianceConfig(kernel="auc", scheme=scheme, n_pos=10_000,
                             n_neg=10_000, n_workers=8, n_rounds=4,
                             n_pairs=10_000, n_reps=64, seed=SEED)
        run_variance_experiment(cfg)               # first use: warm-up
        r = run_variance_experiment(cfg)
        ratio = r["variance"] / r["closed_form_variance"]
        log(f"[harness] {scheme:13s} M=64 mean {r['mean']:.6f} var "
            f"{r['variance']:.4e} closed form {r['closed_form_variance']:.4e} "
            f"ratio {ratio:.3f} ({r['wallclock_s'] * 1e3:.1f} ms)")
        assert CHI2_BAND[0] < ratio < CHI2_BAND[1], (scheme, ratio)
        assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
    launches_by_phase["harness"] = {
        k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
        if v - before.get(k, 0)}


def bound_ms(name, pairs, masked, n_inputs):
    ops = pairs * (OPS_PER_PAIR[name] + (1 if masked else 0))
    byts = 4 * n_inputs + 8
    return max(ops / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, (
        "operations" if ops / PEAK_FP32_OPS >= byts / PEAK_BYTES else "bytes")


def phase_timing(errs, launches, i1, i2):
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n = 1 << 20
    a = torch.randn(n, generator=g, device="cuda") + 1.0
    b = torch.randn(n, generator=g, device="cuda")
    # the ragged local round's worker blocks, as the main path gave them
    ab = torch.randn(i1.shape, generator=g, device="cuda")
    bb = torch.randn(i2.shape, generator=g, device="cuda")
    ma, mb = (i1 >= 0).float(), (i2 >= 0).float()
    masked_pairs = float((ma.sum(1, dtype=torch.float64)
                          * mb.sum(1, dtype=torch.float64)).sum())
    rows = []
    for name in NAMES:
        k = get_kernel(name)
        cuda_ms(lambda: pk.pair_sum(a, b, k))                 # warm-up
        ms, got = cuda_ms(lambda: pk.pair_sum(a, b, k), reps=3)
        plain_ms, want = cuda_ms(lambda: pk.pair_sum(a, b, k, impl="plain"))
        err = check_against_plain(name, got, want, float(n * n),
                                  ("pair_sum", 1, n, n))
        library_ms = None
        if name == "auc":
            cuda_ms(lambda: rank_auc(a, b))
            library_ms, _ = cuda_ms(lambda: rank_auc(a, b), reps=3)
        bms, by = bound_ms(name, float(n * n), False, 2 * n)
        rows.append(dict(
            name=f"pair_sum[{name}]", route="cuda", source=SOURCE,
            replaces=REPLACES["pair_sum"],
            launches=launches.get(f"pair_sum[{name}]", 0),
            max_abs_err=err, max_abs_err_small=errs[f"pair_sum[{name}]"],
            ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=library_ms,
            shape=f"W=1 {n}x{n}"))
        cuda_ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, k))
        ms, got = cuda_ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, k),
                          reps=3)
        plain_ms, want = cuda_ms(
            lambda: pk.masked_pair_sum(ab, bb, ma, mb, k, impl="plain"))
        err = check_against_plain(
            name, got, want,
            ma.sum(1, dtype=torch.float64) * mb.sum(1, dtype=torch.float64),
            ("masked_pair_sum", *i1.shape, i2.shape[1]))
        bms, by = bound_ms(name, masked_pairs, True,
                           2 * (i1.numel() + i2.numel()))
        rows.append(dict(
            name=f"masked_pair_sum[{name}]", route="cuda", source=SOURCE,
            replaces=REPLACES["masked_pair_sum"],
            launches=launches.get(f"masked_pair_sum[{name}]", 0),
            max_abs_err=err,
            max_abs_err_small=errs[f"masked_pair_sum[{name}]"], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
            shape=f"W={i1.shape[0]} {i1.shape[1]}x{i2.shape[1]}"))
        for r in rows[-2:]:
            log(f"[timing] {r['name']:24s} {r['shape']:22s} {r['ms']:9.2f} ms "
                f"(bound {r['bound_ms']:.2f} ms by {r['bound_by']}, plain "
                f"{r['plain_ms']:.1f} ms, library {r['library_ms']}); "
                f"error of the mean vs plain {r['max_abs_err']:.3g}")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.exists(os.path.join(ROOT, SOURCE)):
        print("chip_smoke: run it from a checkout of the repository "
              f"({SOURCE} is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    errs = {}
    phase_kernel_vs_plain(errs)

    pk.reset_launch_counts()
    by_phase = {}
    i1, i2 = phase_main_path(by_phase)
    phase_harness(by_phase)
    launches = dict(pk.LAUNCHES)
    log(f"[launches] main path {json.dumps(launches)}; by phase "
        f"{json.dumps(by_phase)}")
    for label, delta in by_phase.items():
        assert sum(delta.values()) > 0, f"no kernel launched in {label}"
    for wrapper in REPLACES:
        for name in NAMES:
            key = f"{wrapper}[{name}]"
            assert launches.get(key, 0) > 0, f"{key} never launched"

    rows = phase_timing(errs, launches, i1, i2)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
