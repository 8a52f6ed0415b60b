#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bench_torch_train.py

It traces, with torch.profiler (CPU and CUDA activities), a few steps of
two runs of the port's learner after a warm-up run:

* the trainer at full width (train_pairwise, hinge, n = 5e5 per class,
  dim 5, one worker, as in chip_smoke.py phase 7), with loss_every 1 and
  with the loss never recorded;
* the simulated learner's gauss cell (train_curves, n = 512, dim 10,
  N = 32 workers, S = 48 seeds: W = 1536 problems of 16 x 16 pairs),
  50 steps with the test AUC of every seed before and after.

For each it prints the wall-clock per step, the device busy share (the
union of all kernel intervals over the traced window), and the device
time per kernel name, largest first. It also prints what ptxas reports
for the gradient kernels (registers, spills, shared memory per kernel:
csrc/pair_grad.cu, and the hinge route's grad_* kernels of
csrc/rank_count.cu) and
the card's name and power limit. It prints "not measured" where the
trace holds no device events. Without a CUDA device it exits nonzero.
"""

import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def busy_and_kernels(prof, wall_us):
    """(device busy share of the window, [(kernel name, device us)])."""
    spans, per_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        per_name[ev.name] = per_name.get(ev.name, 0.0) + (end - start)
    if not spans:
        return None, []
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    return busy / wall_us, top


def traced(label, fn, steps):
    from torch.profiler import ProfilerActivity, profile

    fn()                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    share, top = busy_and_kernels(prof, wall * 1e6)
    print(f"[{label}] {steps} steps in {wall * 1e3:.2f} ms "
          f"({wall / steps * 1e3:.3f} ms/step); device busy "
          + ("not measured (no device events in the trace)" if share is None
             else f"{share * 100:.1f}% of the window"), flush=True)
    for name, us in top[:8]:
        print(f"    {us / 1e3:10.3f} ms  {us / wall / 1e4:5.1f}%  "
              f"{name[:90]}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("bench_torch_train: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.sim_learner import train_curves
    from tuplewise_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(f"[card] {card.stdout.strip()}; torch {torch.__version__}",
          flush=True)
    for source, only in (("pair_grad.cu", ""), ("rank_count.cu", "grad_")):
        with tempfile.TemporaryDirectory() as d:
            ptx = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-o", os.path.join(d, "lib.so"),
                 os.path.join(_build.CSRC, source)],
                capture_output=True, text=True, timeout=600)
        keep = False
        for line in (ptx.stdout + ptx.stderr).splitlines():
            if "Compiling entry" in line:
                keep = only in line
            if keep and ("Compiling entry" in line or "Used" in line
                         or "spill" in line):
                print(f"[ptxas] {source}: {line.strip()}", flush=True)

    Xp, Xn, _, _ = make_gaussian_splits(500_000, 1000, dim=5, seed=0)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    steps = 5
    for le in (1, 1 << 30):
        cfg = TrainConfig(kernel="hinge", lr=0.3, n_workers=1,
                          repartition_every=1, seed=7, tile=2048,
                          loss_every=le, steps=steps)
        traced(f"train n=5e5/class loss_every={'never' if le > 1 else 1}",
               lambda: train_pairwise(scorer, p0, Xp, Xn, cfg), steps)

    Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(512, 20000, dim=10,
                                                separation=0.8, seed=0)
    scorer = LinearScorer(dim=10)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=50, seed=1000,
                      n_workers=32, repartition_every=5)
    traced("sim learner S=48 N=32 (W=1536 of 16x16), 2 evaluations",
           lambda: train_curves(scorer, scorer.init(0), Xp, Xn, Xp_te,
                                Xn_te, cfg, n_seeds=48, eval_every=50),
           cfg.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
