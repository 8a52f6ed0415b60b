"""Failure simulation, detection, and drop-and-renormalize tolerance (the
counterpart of ``tuplewise_tpu.parallel.faults``).

A dropped worker's local U-statistic is excluded and the average
renormalizes over the survivors; each survivor's value is unbiased, so
dropping raises variance only.

* ``alive_mask`` / ``normalize_dropped``: declare which workers are lost.
* ``sample_failures``: independent per-worker failure injection (never
  kills the last survivor); its numpy draws are the JAX package's.
* ``check_mesh_health``: failure detection, an all-reduce of ones through
  the mesh's communicator that must come back as the mesh size.
* ``detect_dropped_workers``: the collective probe first; only when it
  fails, a probe a worker. On ``LocalComm`` every worker lives on the
  mesh's one device, so a worker's probe is a tiny op there. On
  ``DistComm`` a rank can probe only its own device: a failed collective
  leaves every other rank unknown, and the detector raises rather than
  guess a dropped set.
* ``run_with_fault_tolerance``: probe, then run a local or repartitioned
  estimate over the survivors, in one call.

Every probe may run under a wall-clock bound (``_run_bounded``): a hung
device blocks instead of raising, and the detector must not become the
hang it exists to detect.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


class ProbeTimeout(RuntimeError):
    """A health probe did not return within its deadline: the device (or
    collective) is treated as hung, a failure and not an exception to
    swallow silently."""


def _run_bounded(fn: Callable[[], object],
                 timeout_s: Optional[float]) -> object:
    """Run ``fn`` with a wall-clock bound.

    The probe runs in a daemon helper thread; if it misses the deadline
    the caller gets ``ProbeTimeout`` and the thread is abandoned (it
    holds no lock of ours, and a wedged NCCL or gloo collective cannot
    be cancelled from Python; as a daemon it does not keep the process
    alive). ``timeout_s`` of None runs ``fn`` synchronously."""
    if timeout_s is None:
        return fn()
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:      # noqa: BLE001 — relayed below
            box["exc"] = e

    t = threading.Thread(target=run, name="tuplewise-probe", daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive():
        raise ProbeTimeout(f"health probe hung past {timeout_s}s")
    if "exc" in box:
        raise box["exc"]
    return box["value"]


def normalize_dropped(
    dropped: Iterable[int], n_workers: int
) -> Tuple[int, ...]:
    """Validate + canonicalize a dropped-worker set (sorted, unique)."""
    d = sorted(set(int(w) for w in dropped))
    if any(w < 0 or w >= n_workers for w in d):
        raise ValueError(
            f"dropped workers {d} out of range for n_workers={n_workers}"
        )
    if len(d) >= n_workers:
        raise ValueError(
            f"cannot drop all {n_workers} workers: no survivors to "
            "renormalize over"
        )
    return tuple(d)


def alive_mask(n_workers: int, dropped: Iterable[int] = ()) -> np.ndarray:
    """Float {0,1} mask over workers; mask[w] == 0 iff w is dropped."""
    d = normalize_dropped(dropped, n_workers)
    mask = np.ones(n_workers, dtype=np.float64)
    mask[list(d)] = 0.0
    return mask


def sample_failures(
    seed: int, n_workers: int, p_fail: float
) -> Tuple[int, ...]:
    """Independent worker failures with probability p_fail each,
    conditioned on at least one survivor (resampling the would-be last
    victim back to life)."""
    if not 0.0 <= p_fail < 1.0:
        raise ValueError(f"p_fail must be in [0, 1), got {p_fail}")
    rng = np.random.default_rng(seed)
    fails = rng.random(n_workers) < p_fail
    if fails.all():
        fails[rng.integers(n_workers)] = False
    return tuple(int(w) for w in np.nonzero(fails)[0])


def survivors(n_workers: int, dropped: Sequence[int]) -> Tuple[int, ...]:
    d = set(normalize_dropped(dropped, n_workers))
    return tuple(w for w in range(n_workers) if w not in d)


def _collective_probe(mesh) -> bool:
    """The raw probe body: every worker adds 1 through the mesh's
    all-reduce (all axes of a 2-D mesh at once). Separated so that the
    timeout wrapper, and tests simulating a hang, replace exactly the
    part that talks to devices."""
    ones = torch.ones(mesh.comm.n_local, dtype=torch.float64,
                      device=mesh.device)
    return int(mesh.comm.all_reduce_sum(ones)) == mesh.n_workers


def _device_probe(mesh, worker: int) -> bool:
    """Tiny transfer and compute on the device of ``worker``; True when
    it answers. On the worker axis every worker lives on the mesh's
    device."""
    x = torch.ones((), device=mesh.device)
    return float(x + 1) == 2.0


def check_mesh_health(mesh, timeout_s: Optional[float] = None) -> bool:
    """Failure detection probe: every worker contributes 1 to an
    all-reduce; a healthy N-worker mesh returns N. Runtime errors of a
    dead device propagate to the caller, which maps them (or a False
    return) to a dropped set. ``timeout_s`` bounds the probe's wall
    clock: on expiry the mesh is reported unhealthy (False)."""
    try:
        return bool(_run_bounded(lambda: _collective_probe(mesh),
                                 timeout_s))
    except ProbeTimeout:
        return False


def detect_dropped_workers(
    mesh, timeout_s: Optional[float] = None
) -> Tuple[int, ...]:
    """Map an unhealthy mesh to the set of dead workers.

    Fast path: the collective ``check_mesh_health`` probe; healthy means
    no per-worker work at all. On failure (False, or the collective
    raising, which is how a dead device surfaces) each worker is probed
    on its own with a tiny op; workers whose probe raises, or hangs past
    ``timeout_s``, are the dropped set. Raises RuntimeError when every
    worker fails, and on a distributed mesh (``DistComm``), where a rank
    can probe only its own device and every other rank's state is
    unknown."""
    try:
        if check_mesh_health(mesh, timeout_s=timeout_s):
            return ()
    except Exception:  # noqa: BLE001 — the collective died: probe each
        pass
    if mesh.distributed:
        raise RuntimeError(
            "the mesh's collective failed, and a rank can probe only its "
            "own device: every other rank's state is unknown, so no "
            "dropped set is derived")
    dropped = []
    for w in range(mesh.n_workers):
        try:
            if not _run_bounded(lambda w=w: _device_probe(mesh, w),
                                timeout_s):
                dropped.append(w)
        except Exception:  # noqa: BLE001 — a raising probe is a dead worker
            dropped.append(w)
    if len(dropped) >= mesh.n_workers:
        raise RuntimeError(
            f"all {mesh.n_workers} workers failed the health probe; "
            "cannot renormalize")
    return tuple(dropped)


def run_with_fault_tolerance(
    estimator,
    scheme: str,
    A,
    B=None,
    *,
    detector=None,
    **kwargs,
):
    """Probe health -> derive the dropped set -> run the estimator, in
    one call.

    scheme: "local" or "repartitioned", the schemes whose per-worker
    values stay individually unbiased under worker loss (complete and
    incomplete statistics need every shard's data, so a dead worker is
    not recoverable by renormalizing and the caller must re-pack).

    detector: () -> dropped tuple; defaults to ``detect_dropped_workers``
    on the estimator's mesh (mesh backend) or no failures for the
    single-device backend. kwargs pass through to the estimator method
    (n_rounds, seed, scheme=partition scheme...).
    """
    methods = {"local": "local_average", "repartitioned": "repartitioned"}
    if scheme not in methods:
        raise ValueError(
            f"fault tolerance applies to {sorted(methods)} schemes "
            f"(per-worker values stay unbiased under loss); got {scheme!r}"
        )
    if detector is None:
        mesh = getattr(estimator.backend, "mesh", None)
        if mesh is not None:
            detector = lambda: detect_dropped_workers(mesh)  # noqa: E731
        else:
            detector = tuple
    dropped = normalize_dropped(detector(), estimator.n_workers)
    return getattr(estimator, methods[scheme])(
        A, B, dropped_workers=dropped, **kwargs
    )
