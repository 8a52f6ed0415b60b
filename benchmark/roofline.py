"""The least time of a launch or a step, from its own shapes.

The least time is the larger of two figures: the input bytes read once
and the output bytes written once over the card's bandwidth, and the
operations the mathematics needs over its float32 peak (``peaks.json``).
A share of the roofline is a sum of least times over the device time
the launches took, so it reads the same work whatever implements it,
and it cannot pass 100 % unless the counts are too high.

* The auc and hinge pair sums count bytes only: a sort-and-count is
  sub-quadratic, so n1 n2 operations would read over the peak.
* The logistic gradients count ``GRAD_OPS_PER_PAIR`` operations a pair,
  copied from ``chip_smoke.py`` (the subtraction, g' as exp, add,
  reciprocal and negation, the row and col adds; the loss adds the body's
  abs, exp, log1p, max, add and its accumulation). Counting exp and
  log1p as one operation each makes the bound a lower one. A surrogate
  the table does not hold (the hinge: a sort-and-search) counts bytes
  only, as the pair sums do.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
GRAD_OPS_PER_PAIR = {"logistic": {"pair_grad_sums": 7, "pair_loss_grad": 13}}
F32, F64 = 4, 8


def peaks(kind: str) -> Optional[dict]:
    """The card's peaks by its ``torch.cuda.get_device_name()``, or None
    for a card the table does not hold."""
    table = json.loads((HERE / "peaks.json").read_text())["cards"]
    return table.get(kind)


def least_s(ops: float, nbytes: float, peak: dict) -> float:
    return max(ops / peak["fp32_ops_per_s"], nbytes / peak["bytes_per_s"])


def pair_sum_least_s(W: int, n1: int, n2: int, masked: bool,
                     peak: dict) -> float:
    """A launch of the auc (or hinge) pair sum over W problems of n1 x n2
    float32 scores: the scores (and, masked, their float32 weights) read
    once, W float64 sums written once."""
    nbytes = F32 * W * (n1 + n2) * (2 if masked else 1) + F64 * W
    return least_s(0.0, nbytes, peak)


def pair_ops(surrogate: str, wrapper: str) -> int:
    """Operations a pair of a gradient launch; 0 where only bytes count."""
    return GRAD_OPS_PER_PAIR.get(surrogate, {}).get(wrapper, 0)


def grad_least_s(surrogate: str, wrapper: str, W: int, n1: int, n2: int,
                 peak: dict) -> float:
    """A launch of the gradient sums (``pair_loss_grad`` or
    ``pair_grad_sums``) of a surrogate over W problems of n1 x n2: the
    scores read once, the row and col sums written once (and the W
    float64 losses)."""
    loss = wrapper == "pair_loss_grad"
    nbytes = F32 * 2 * W * (n1 + n2) + (F64 * W if loss else 0)
    ops = float(W) * n1 * n2 * pair_ops(surrogate, wrapper)
    return least_s(ops, nbytes, peak)


def linear_sgd_step_ops(surrogate: str, W: int, m1: int, m2: int,
                        dim: int, with_loss: bool) -> float:
    """The operations of one full-pair step of a linear scorer over W
    workers' m1 x m2 pairs: the pairs' loss and gradient sums, the
    scores (2 dim a row), the gradient of the scores (2 dim a row) and
    the update (2 a parameter)."""
    wrapper = "pair_loss_grad" if with_loss else "pair_grad_sums"
    rows = W * (m1 + m2)
    return (float(W) * m1 * m2 * pair_ops(surrogate, wrapper)
            + 4.0 * dim * rows + 2.0 * (dim + 1))
