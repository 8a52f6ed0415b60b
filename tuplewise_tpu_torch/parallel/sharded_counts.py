"""Signed rank counts of sorted runs: the serving index's count layer.

The single-device half of ``tuplewise_tpu.parallel.sharded_counts``. The
serving hot path needs, per micro-batch, for queries q the integer
counts ``less = #{v < q}`` and ``leq = #{v <= q}`` against a signed union
of sorted runs (base runs +1, a tombstone multiset -1). Counting is
additive over runs, so one call sums every run's signed counts:

* ``kernel=True``: one launch of the fused CUDA kernel
  (``ops.count_kernels.signed_count``, kernel 6) on a CUDA device, or
  its plain version on the CPU. No fallback: a kernel that fails to
  build or launch raises.
* ``kernel=None``: the ``torch.searchsorted`` route
  (:func:`signed_count_searchsorted`), two searches per run: the
  counterpart of the JAX package's XLA searchsorted path.

Both give the same integers. A run is either a host array, padded to its
bucket and copied to the device by the call, or a device tensor placed
once by :func:`place_run` and reused until its host copy changes. The
mesh form (runs sharded over devices, one all-reduce) is not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.obs.ledger import device_section
from tuplewise_tpu_torch.ops.count_kernels import signed_count
from tuplewise_tpu_torch.utils.device import resolve_device

_MIN_BUCKET = 256


def next_bucket(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded counts over a device mesh are not ported to "
            "tuplewise_tpu_torch yet; pass mesh=None")


def place_run(arr: np.ndarray, cap: int, device) -> torch.Tensor:
    """A sorted host run as a float32 tensor of length ``cap`` on
    ``device``, +inf past its values (finite queries never count the
    padding)."""
    out = np.full(cap, np.inf, dtype=np.float32)
    out[: len(arr)] = arr
    return torch.from_numpy(out).to(device)


def signed_count_searchsorted(runs: Sequence[torch.Tensor],
                              signs: Sequence[int], sets: Sequence[int],
                              qa: torch.Tensor,
                              qb: torch.Tensor) -> torch.Tensor:
    """The ``torch.searchsorted`` twin of the fused kernel: per run a
    left and a right search of its query set, summed with the run's sign
    into the same int32 block [4, max(len(qa), len(qb))]."""
    qs = (qa, qb)
    out = torch.zeros((4, max(len(qa), len(qb))), dtype=torch.int32,
                      device=qa.device)
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        if len(q) == 0:
            continue
        for row, right in ((2 * a, False), (2 * a + 1, True)):
            c = torch.searchsorted(run, q, right=right, out_int32=True)
            out[row, :len(q)] += s * c
    return out


def signed_pair_counts(mesh, runs_a, runs_b, q_a: np.ndarray,
                       q_b: np.ndarray, dtype=np.float32, *, kernel=None,
                       metrics=None, device=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Signed counts of two query sets in one device call.

    ``runs_a`` / ``runs_b``: sequences of ``(run, cap, sign)`` counted
    against ``q_a`` / ``q_b``: ``run`` a sorted host array (padded here
    to ``cap``) or a placed device tensor of length ``cap``. ``device``:
    where host runs and the queries go (a placed run's own device wins);
    None is the card, and raises where there is none.
    Returns four int64 arrays ``(less_a, leq_a, less_b, leq_b)`` trimmed
    to the query lengths.

    ``kernel``: None takes the searchsorted route; True the fused kernel
    (its plain version on the CPU), counted in ``metrics`` as
    ``count_kernel_calls_total``. Only float32 runs are taken, the
    index's ``engine="torch"`` storage.
    """
    _check_mesh(mesh)
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"device counts take float32 runs, got {dtype}")
    la, lb = len(q_a), len(q_b)
    if not runs_a and not runs_b:
        return (np.zeros(la, np.int64), np.zeros(la, np.int64),
                np.zeros(lb, np.int64), np.zeros(lb, np.int64))
    dev = None
    for run, _, _ in (*runs_a, *runs_b):
        if isinstance(run, torch.Tensor):
            dev = run.device
            break
    dev = resolve_device(device) if dev is None else dev
    tensors, caps, signs, sets = [], [], [], []
    for side, rs in ((0, runs_a), (1, runs_b)):
        for run, cap, sign in rs:
            if not isinstance(run, torch.Tensor):
                run = place_run(np.asarray(run, np.float32), cap, dev)
            tensors.append(run)
            caps.append(cap)
            signs.append(sign)
            sets.append(side)
    key = ("signed_pair", tuple(caps), tuple(signs), tuple(sets),
           kernel is not None)
    with device_section(key) as ds:
        # one host-to-device copy carries both query sets
        q = torch.from_numpy(np.concatenate(
            [np.asarray(q_a, np.float32), np.asarray(q_b, np.float32)]))
        q = q.to(dev)
        qa, qb = q[:la], q[la:]
        if kernel is not None:
            out = signed_count(tensors, signs, sets, qa, qb)
        else:
            out = signed_count_searchsorted(tensors, signs, sets, qa, qb)
        ds.dispatched()
        out = out.cpu().numpy().astype(np.int64)
    if kernel is not None and metrics is not None:
        metrics.counter("count_kernel_calls_total").inc()
    return (out[0, :la], out[1, :la], out[2, :lb], out[3, :lb])
