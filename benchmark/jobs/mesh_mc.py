"""The mesh Monte-Carlo runner of the port
(``harness/mesh_mc.make_mesh_mc_runner``) on fresh data each rep.

The traffic's ``runner`` holds the ``VarianceConfig`` fields of its
scheme (``scheme``, ``n_rounds``, ``n_pairs``, ``design``, ...); the
configuration gives the kernel, the class sizes, the separation and the
workers. The window calls ``run(reps)`` over consecutive ranges of
``reps_per_call`` absolute rep indices, after a warm-up call of
``warmup_reps`` reps. ``correct``: the estimates of ``check_reps`` reps
of the window, drawn from the seed, against the plain reference
(``reference/auc_mc.py`` and the scheme's ``reference/auc_<scheme>.py``),
which draws each rep's rows and partitions again from the seed; the
number compared is the widest gap.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark.reference import auc_mc
from benchmark.reference.rng import derive_seed


class Job:
    unit = "reps"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tuplewise_tpu_torch.harness.mesh_mc import make_mesh_mc_runner
        from tuplewise_tpu_torch.harness.variance import VarianceConfig

        self.n1, self.n2 = class_sizes(config, traffic)
        self.N = config["n_workers"]
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.cfg = VarianceConfig(
            kernel=config["kernel"], backend="mesh", n_pos=self.n1,
            n_neg=self.n2, separation=config["separation"],
            n_workers=self.N, seed=seed, **traffic["runner"])
        self.run = make_mesh_mc_runner(self.cfg, device=device)
        self.per_call = traffic["reps_per_call"]
        self.next_rep = 0
        self.estimates = {}
        self._call(traffic["warmup_reps"])
        self.estimates.clear()

    def _call(self, k: int) -> int:
        reps = range(self.next_rep, self.next_rep + k)
        out = self.run(reps)
        self.estimates.update(zip(reps, out.tolist()))
        self.next_rep += k
        return k

    def step(self) -> int:
        return self._call(self.per_call)

    def answers(self):
        """Every estimate of the window."""
        return list(self.estimates.values())

    def launch_shapes(self) -> dict:
        N, n1, n2 = self.N, self.n1, self.n2
        if self.cfg.scheme == "complete" and (n1 % N or n2 % N):
            # a ragged ring: every stop is kernel 2 over padded blocks
            return {"masked_pair_sum[auc]":
                    (N, -(-n1 // N), -(-n2 // N), True)}
        # the ring's stops or a partitioned round: W = N blocks of n // N
        # rows
        return {"pair_sum[auc]": (N, n1 // N, n2 // N, False)}

    def step_ops(self):
        return None

    def finish(self) -> None:
        self.run = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self):
        gaps = []
        for r in sample_reps(self.seed, self.estimates,
                             self.traffic["check_reps"]):
            ref = reference(self.config, self.traffic, self.seed, r,
                            self.device)
            gaps.append(abs(self.estimates[r] - ref))
        return {"est_gap": gaps}


def class_sizes(config: dict, traffic: dict):
    off = traffic.get("class_size_offsets", [0, 0])
    return config["n_pos"] + off[0], config["n_neg"] + off[1]


def sample_reps(seed: int, reps, k: int):
    """k reps of ``reps`` drawn from the seed, in order."""
    reps = sorted(reps)
    rng = np.random.default_rng(derive_seed(seed, "check"))
    return sorted(rng.choice(reps, size=min(k, len(reps)),
                             replace=False).tolist())


def reference(config, traffic, seed, rep, device, dtype=None) -> float:
    n1, n2 = class_sizes(config, traffic)
    return auc_mc.estimate(traffic["runner"], seed, rep, n1, n2,
                           config["n_workers"], config["separation"],
                           device, dtype)


#: the controls ``controls`` can put in the program's place
VARIANTS = ("bfloat16",)


def controls(config: dict, traffic: dict, seed: int, device) -> dict:
    """{variant: the numbers ``check`` compares}, with the reference
    computed on rows rounded to bfloat16 in the program's place, over
    the reps a window of eight calls would give."""
    w, per = traffic["warmup_reps"], traffic["reps_per_call"]
    gaps = [abs(reference(config, traffic, seed, r, device, torch.bfloat16)
                - reference(config, traffic, seed, r, device))
            for r in sample_reps(seed, range(w, w + 8 * per),
                                 traffic["check_reps"])]
    return {"bfloat16": {"est_gap": gaps}}
