"""The flagship forward step: a twin of the JAX package's
``__graft_entry__.entry``.

``entry()`` returns ``(forward, example_args)``: the full-pair logistic
surrogate loss, mean over the 2048 x 2048 pair grid, of a
``LinearScorer(dim=16)`` on two [2048, 16] feature blocks, with the
reference's inputs (parameters from ``scorer.init(0)``, blocks from
``numpy.random.default_rng(0)``). On the card the pair sum is one launch
of kernel 1's logistic body (``ops.pair_kernels.pair_sum``,
``csrc/pair_sum.cu``); on the CPU, or with ``impl="plain"``, its plain
version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.ops import pair_kernels
from tuplewise_tpu_torch.ops.kernels import logistic_kernel
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.state import params_to_state

DIM, ROWS = 16, 2048


def entry(device=None, impl: Optional[str] = None):
    """(forward, (params, xp, xn)): forward(params, xp, xn) is the mean
    logistic pair loss as a float64 0-d tensor. device: None runs on the
    card (and raises where there is none), "cpu" the plain version."""
    dev = resolve_device(device)
    scorer = LinearScorer(dim=DIM)
    rng = np.random.default_rng(0)
    params = params_to_state(scorer.init(0), dev)
    xp = torch.as_tensor(rng.standard_normal((ROWS, DIM)),
                         dtype=torch.float32, device=dev)
    xn = torch.as_tensor(rng.standard_normal((ROWS, DIM)),
                         dtype=torch.float32, device=dev)

    def forward(params, xp, xn):
        s1 = scorer.score(params, xp)
        s2 = scorer.score(params, xn)
        total = pair_kernels.pair_sum(s1, s2, logistic_kernel, impl=impl)
        return total / float(s1.shape[0] * s2.shape[0])

    return forward, (params, xp, xn)
