"""The port's pairwise SGD learner (``models/pairwise_sgd.train_pairwise``)
with a linear scorer on every local pair.

Set-up makes the rows and the first parameters from the seed
(``reference/pairwise_sgd.py``) on the device, hands the trainer the
rows on the host (it places them on the card in every call, as a user
who trains in epochs), and drives ``check_steps`` one-step calls from
the first parameters: they warm up every shape. The window continues
from their parameters with calls of ``steps_per_call`` steps, call k
under the seed (seed, "train_call", k).

``correct``: the plain reference follows the same one-step calls and
the window's first call, on rows and partitions it draws again from the
seed, from its own first parameters. Compared: the loss of each check
step and of every step of the window's first call (gap over the
reference's), the first gradient, worked out from the parameters after
one step, the parameters' change over the check steps, and their change
over the window's first call (its regathers inside the call, every
step's update), the last three by the worst leaf
(``reference.pairwise_sgd.leaf_gaps``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark import roofline
from benchmark.reference import pairwise_sgd as ref


class Job:
    unit = "steps"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tuplewise_tpu_torch.models.pairwise_sgd import (
            TrainConfig, train_pairwise,
        )
        from tuplewise_tpu_torch.models.scorers import LinearScorer

        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.N, self.dim = config["n_workers"], config["dim"]
        Xp, Xn = ref.make_rows(seed, config["n_pos"], config["n_neg"],
                               self.dim, config["separation"], device)
        self.rows = (Xp.cpu(), Xn.cpu())
        p0 = ref.init_params(seed, self.dim, device)
        self.params = {k: v.cpu().numpy() for k, v in p0.items()}
        self.scorer = LinearScorer(dim=self.dim)
        self._train, self._cfg = train_pairwise, TrainConfig
        self.calls = 0
        self.losses = []
        # the parameters after each check call, p0 first
        self.check_params = [self.params]
        for _ in range(traffic["check_steps"]):
            self._call(1)
            self.check_params.append(self.params)
        self.check_losses = list(self.losses)
        self.window_losses = []
        # the parameters after the window's first call
        self.call_params = None

    def _call(self, steps: int) -> int:
        t = self.traffic
        cfg = self._cfg(
            kernel=t["surrogate"], lr=t["lr"], steps=steps,
            n_workers=self.N, repartition_every=t["repartition_every"],
            pairs_per_worker=t["pairs_per_worker"],
            loss_every=t["loss_every"],
            seed=ref.call_seed(self.seed, self.calls))
        self.params, hist = self._train(self.scorer, self.params, *self.rows,
                                        cfg, device=self.device)
        self.losses.extend(np.asarray(hist["loss"]).tolist())
        self.calls += 1
        return steps

    def step(self) -> int:
        n = self._call(self.traffic["steps_per_call"])
        self.window_losses.extend(self.losses[-n:])
        if self.call_params is None:
            self.call_params = self.params
        return n

    def answers(self):
        """Every loss the window recorded."""
        return [v for i, v in enumerate(self.window_losses)
                if i % self.traffic["loss_every"] == 0]

    def _shape(self):
        return (self.N, self.config["n_pos"] // self.N,
                self.config["n_neg"] // self.N)

    def launch_shapes(self) -> dict:
        shape = self._shape()
        return {f"{w}[{self.traffic['surrogate']}]": shape
                for w in ("pair_loss_grad", "pair_grad_sums")}

    def step_ops(self):
        if self.traffic["pairs_per_worker"] is not None:
            return None
        every = self.traffic["loss_every"]
        W, m1, m2 = self._shape()
        # the mean over a period of loss_every steps, one with the loss
        return sum(roofline.linear_sgd_step_ops(
            self.traffic["surrogate"], W, m1, m2, self.dim, i == 0)
            for i in range(every)) / every

    def finish(self) -> None:
        self.rows = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self):
        out = reference(self.config, self.traffic, self.seed, self.device)
        every = self.traffic["loss_every"]
        call = [v if i % every == 0 else None for i, v in enumerate(
            self.window_losses[:self.traffic["steps_per_call"]])]
        return compare(self.check_params, self.call_params,
                       self.check_losses + call, out, self.traffic["lr"])


def reference(config: dict, traffic: dict, seed: int, device, **kw):
    """The reference's check calls and the window's first call, from the
    seed's inputs (``kw``: ``sgd_calls``'s dtype or faults)."""
    if traffic["pairs_per_worker"] is not None:
        raise ValueError("the reference follows every local pair; the "
                         "budgeted draw has no reference yet")
    Xp, Xn = ref.make_rows(seed, config["n_pos"], config["n_neg"],
                           config["dim"], config["separation"], device)
    p0 = ref.init_params(seed, config["dim"], device)
    n = traffic["check_steps"]
    calls = [(ref.call_seed(seed, i), 1) for i in range(n)]
    calls.append((ref.call_seed(seed, n), traffic["steps_per_call"]))
    return ref.sgd_calls(Xp, Xn, p0, calls, n_workers=config["n_workers"],
                         lr=traffic["lr"],
                         repartition_every=traffic["repartition_every"],
                         surrogate=traffic["surrogate"], **kw)


#: the control and the faults ``controls`` puts in the program's place
VARIANTS = ("bfloat16", "half_batch", "no_regather", "state_unchanged")


def controls(config: dict, traffic: dict, seed: int, device) -> dict:
    """{variant: the numbers ``check`` compares}, with the reference in
    the program's place computed in bfloat16 ("bfloat16"), over the first
    half of the workers' pairs alone ("half_batch": half of the batch
    left out, the mean taken over the rest), with a call's first blocks
    kept for all its steps ("no_regather"), or with the parameters never
    moved ("state_unchanged")."""
    kw = {"bfloat16": {"dtype": torch.bfloat16},
          "half_batch": {"workers": range(config["n_workers"] // 2)},
          "no_regather": {"regather": False},
          "state_unchanged": {"update": False}}
    out = reference(config, traffic, seed, device)
    n = traffic["check_steps"]

    def numpy(p):
        return {k: v.cpu().numpy() for k, v in p.items()}

    gaps = {}
    for variant in VARIANTS:
        alt = reference(config, traffic, seed, device, **kw[variant])
        gaps[variant] = compare([numpy(p) for p in alt["params"][:n + 1]],
                                numpy(alt["params"][-1]), alt["loss"], out,
                                traffic["lr"])
    return gaps


def compare(check_params, call_params, losses, out, lr: float) -> dict:
    """The gaps of the program to the reference's ``sgd_calls``:
    ``check_params`` the parameters after each check call (numpy dicts,
    the first parameters first), ``call_params`` those after the
    window's first call (None where the window made none), ``losses``
    each compared step's loss (None where ``loss_every`` skips it). What
    the window did not reach reads NaN."""
    dev = out["grad"][0]["w"].device

    def t(p):
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float64,
                                   device=dev) for k, v in p.items()}

    p = [t(x) for x in check_params]
    n = len(p) - 1
    ref_p = out["params"]
    grad = {k: (p[0][k] - p[1][k]) / lr for k in p[0]}

    def change(a, b):
        return {k: b[k] - a[k] for k in a}

    call_gap = float("nan")
    if call_params is not None:
        call_gap = ref.leaf_gaps(change(p[n], t(call_params)),
                                 change(ref_p[n], ref_p[-1]), out["grad"][n])
    losses = list(losses) + [float("nan")] * (len(out["loss"]) - len(losses))
    return {
        "loss_gap": [abs(a - b) / abs(b)
                     for a, b in zip(losses, out["loss"]) if a is not None],
        "grad_gap": [ref.leaf_gaps(grad, out["grad"][0], out["grad"][0])],
        "change_gap": [ref.leaf_gaps(change(p[0], p[n]),
                                     change(ref_p[0], ref_p[n]),
                                     out["grad"][0])],
        "call_change_gap": [call_gap],
    }
