"""Elastic mesh self-healing for the batch path (the counterpart of
``tuplewise_tpu.parallel.self_heal``).

* :class:`Backoff`: ONE bounded-exponential-backoff implementation, with
  deterministic seeded jitter so synchronized retry storms decorrelate
  (``parallel.distributed.initialize`` retries a bring-up with it too).
* :class:`MeshHealer`: owns the mutable mesh reference and the recovery
  counters (``reshard_events``, ``shard_retries_total``,
  ``recovery_time_s``, the JAX package's metric names). ``run(fn)``
  executes a mesh computation under the heal-and-retry protocol: probe,
  rebuild the mesh, let the caller re-place its state, back off, retry.

Two reshard policies, chosen by who can tolerate a width change:

* **fixed width** (``fixed_width=N``: the Estimator, the trainers, the
  mesh Monte-Carlo): the logical worker count is part of the
  experiment's semantics (every generator chain folds a worker index,
  block sizes are n // N), so a reshard KEEPS the width: lost slots are
  backfilled from the spare slots of the ``pool``
  (``parallel.mesh``). Results are bit for bit the fault-free ones by
  construction: values depend on (rep, step, logical worker), never on
  a slot. When the pool can no longer sustain the width,
  :class:`HealExhaustedError` is raised: the job resumes from its
  checkpoint rather than silently continuing a DIFFERENT experiment at
  a smaller N.
* **shrink** (``fixed_width=None``): rebuild over the survivors of the
  current mesh.

On a distributed mesh (``DistComm``, one worker a rank) a failure with
no dropped worker retries on the same group; a dropped worker under the
fixed-width policy raises :class:`HealExhaustedError` (a rank cannot be
backfilled inside the process: the job resumes from its checkpoint).
The shrink policy (the mesh form of serving) rebuilds the group over the
survivors when the drop was declared by the chaos schedule with every
process alive: every rank calls ``dist.new_group`` over the survivors
(a collective of the whole default group), the survivors continue on a
``DistComm`` of the subgroup, and the dropped rank leaves the loop with
:class:`WorkerDroppedError`. A loss a probe found, not declared, raises
:class:`HealExhaustedError` as on the fixed width: a process cannot
tell a dead peer's group to rebuild.

A retry re-runs the same computation on the same device with the same
kernels: nothing here switches ``impl`` or the device, which would be a
fallback that hides a kernel. ``MeshHealer(mesh=None)`` degrades to
retry-with-backoff only (no probe, no reshard): the single-device
backends share the retry discipline through it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from tuplewise_tpu_torch.obs.tracing import check_tracer
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


class HealExhaustedError(RuntimeError):
    """The slot pool can no longer sustain the required mesh width:
    resume the job from its checkpoint on a healthy pool instead."""


class WorkerDroppedError(RuntimeError):
    """This process's rank was dropped from a distributed mesh by a heal:
    the survivors go on without it, and it leaves the serving loop."""


class Backoff:
    """Bounded exponential backoff with deterministic seeded jitter.

    ``delay_s(attempt)`` (1-based) is ``base_s * 2**(attempt-1)``
    capped at ``cap_s``, stretched by up to ``jitter`` fraction drawn
    from a seeded generator: deterministic per instance, decorrelated
    across instances with different seeds (retry storms from many
    workers must not re-synchronize on the failed resource).
    """

    def __init__(self, base_s: float = 0.02, cap_s: float = 1.0,
                 jitter: float = 0.25, seed: int = 0):
        if base_s < 0 or cap_s < 0:
            raise ValueError(f"backoff times must be >= 0: "
                             f"base_s={base_s}, cap_s={cap_s}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)

    def delay_s(self, attempt: int) -> float:
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.base_s * (2.0 ** (attempt - 1)), self.cap_s)
        if self.jitter:
            d *= 1.0 + self.jitter * float(self._rng.random())
        return d

    def sleep(self, attempt: int) -> None:
        time.sleep(self.delay_s(attempt))


class MeshHealer:
    """Probe → reshard → re-place → backoff → retry.

    Args:
      mesh: the ``parallel.mesh.Mesh`` to heal, or None for
        retry-with-backoff only.
      fixed_width: keep the mesh at exactly this many workers across
        reshards, backfilling lost slots from ``pool``; None shrinks to
        the survivors.
      pool: slots eligible for rebuilds (default: the mesh's own slots,
        shrink-only). Callers pass ``mesh.pool`` to let a reshard use
        the spare slots.
      chaos: a ``testing.chaos.FaultInjector`` whose ``take_dropped()``
        supplies the dead-worker set a scheduled fault declared, in
        place of a real probe.
      probe_timeout_s: wall-clock bound on the health probe.
      metrics: a ``utils.profiling.MetricsRegistry`` to record
        ``reshard_events`` / ``shard_retries_total`` / ``recovery_time_s``
        into (create-or-return); None = a private one.
      backoff: a :class:`Backoff`; None = defaults.
      tracer: must be None (span tracing is not ported).
      flight: an ``obs.flight.FlightRecorder``: every heal round and
        resize records a lifecycle event; None = no events.
    """

    def __init__(self, mesh=None, *, fixed_width: Optional[int] = None,
                 pool: Optional[Sequence[int]] = None, chaos=None,
                 probe_timeout_s: float = 5.0, metrics=None,
                 backoff: Optional[Backoff] = None, tracer=None,
                 flight=None):
        check_tracer(tracer)
        if fixed_width is not None and mesh is None:
            raise ValueError("fixed_width needs a mesh to keep at width")
        self.mesh = mesh
        self.fixed_width = fixed_width
        self.chaos = chaos
        self.probe_timeout_s = probe_timeout_s
        self.backoff = backoff if backoff is not None else Backoff()
        self.flight = flight
        self._declared = False
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_reshard = self.metrics.counter("reshard_events")
        self._c_retries = self.metrics.counter("shard_retries_total")
        self._h_recovery = self.metrics.histogram("recovery_time_s")
        if mesh is not None:
            self._pool = list(pool) if pool is not None else list(mesh.slots)
            if fixed_width is not None and mesh.n_workers != fixed_width:
                raise ValueError(
                    f"fixed_width={fixed_width} but the mesh has "
                    f"{mesh.n_workers} workers")
        else:
            self._pool = []

    # ------------------------------------------------------------------ #
    @property
    def n_workers(self) -> Optional[int]:
        return None if self.mesh is None else self.mesh.n_workers

    @property
    def reshard_events(self) -> int:
        return self._c_reshard.value

    @property
    def retries_total(self) -> int:
        return self._c_retries.value

    # ------------------------------------------------------------------ #
    def _probe_dropped(self) -> tuple:
        """Dead-worker set: the chaos schedule's declared topology when
        one is pending, else a real (wall-clock-bounded) mesh probe.
        ``self._declared`` records which of the two it was."""
        dropped = self.chaos.take_dropped() if self.chaos is not None \
            else None
        self._declared = dropped is not None
        if dropped is not None:
            return tuple(dropped)
        from tuplewise_tpu_torch.parallel.faults import (
            detect_dropped_workers,
        )

        try:
            return detect_dropped_workers(
                self.mesh, timeout_s=self.probe_timeout_s)
        except Exception:  # noqa: BLE001 — retried below, bounded
            # the detector itself failed (every worker unreachable, or a
            # distributed mesh whose peers cannot be probed): retry on
            # the same mesh; if the fault was transient the retry
            # succeeds, else the retry bound surfaces the original error
            return ()

    def lost_worker(self) -> bool:
        """True when a probe of the mesh finds a dead worker: how a
        caller tells a lost worker from a fault of its own code (the
        index's major merge takes its host path only for the first). A
        probe that cannot decide (every worker unreachable, a
        distributed mesh) answers False."""
        from tuplewise_tpu_torch.parallel.faults import (
            detect_dropped_workers,
        )

        if self.mesh is None:
            return False
        try:
            return bool(detect_dropped_workers(
                self.mesh, timeout_s=self.probe_timeout_s))
        except RuntimeError:     # every worker failed, or a distributed mesh
            return False

    def _rebuilt(self, slots):
        """The mesh over ``slots``: the same shape at fixed width, a 1-D
        mesh of the survivors when shrinking."""
        from tuplewise_tpu_torch.parallel.mesh import make_mesh

        if len(slots) == self.mesh.n_workers:
            return dataclasses.replace(self.mesh, slots=tuple(slots),
                                       pool=tuple(self._pool))
        return make_mesh(len(slots), self.mesh.device, slots=slots,
                         pool=self._pool)

    def _reshard(self) -> bool:
        """Probe and rebuild the mesh; True when the mesh changed.
        Raises :class:`HealExhaustedError` when nothing is left to
        rebuild over (or the pool can't sustain ``fixed_width``)."""
        dropped = self._probe_dropped()
        if not dropped:
            return False
        if self.mesh.distributed:
            if self.fixed_width is None and self._declared:
                return self._shrink_group(dropped)
            raise HealExhaustedError(
                f"workers {sorted(dropped)} of a distributed mesh dropped: "
                "a rank cannot be backfilled inside the process; resume "
                "from the checkpoint")
        dead = {self.mesh.slots[int(w)] for w in dropped
                if 0 <= int(w) < self.mesh.n_workers}
        self._pool = [s for s in self._pool if s not in dead]
        if self.fixed_width is not None:
            if len(self._pool) < self.fixed_width:
                raise HealExhaustedError(
                    f"slot pool ({len(self._pool)} alive) can no longer "
                    f"sustain the mesh width {self.fixed_width}; resume "
                    "from the checkpoint on a healthy pool")
            new_slots = self._pool[: self.fixed_width]
        else:
            new_slots = [s for s in self.mesh.slots if s not in dead]
            if not new_slots:
                raise HealExhaustedError(
                    "every mesh worker failed; nothing to reshard over")
        self.mesh = self._rebuilt(new_slots)
        return True

    def _shrink_group(self, dropped) -> bool:
        """The distributed shrink: a group of the surviving workers,
        made by every rank of the default group (``dist.new_group`` is a
        collective of it, so every process takes part, the dropped ones
        too). Raises :class:`WorkerDroppedError` on a dropped rank."""
        import torch.distributed as dist

        from tuplewise_tpu_torch.parallel.comm import DistComm
        from tuplewise_tpu_torch.parallel.mesh import Mesh, shard_axis_name

        comm = self.mesh.comm
        dead = {int(w) for w in dropped if 0 <= int(w) < comm.n_workers}
        keep = [w for w in range(comm.n_workers) if w not in dead]
        if not keep:
            raise HealExhaustedError(
                "every mesh worker failed; nothing to reshard over")
        ranks = [w if comm.group is None
                 else dist.get_global_rank(comm.group, w) for w in keep]
        group = dist.new_group(ranks=ranks)
        if comm.rank in dead:
            raise WorkerDroppedError(
                f"worker {comm.rank} was dropped from the mesh; "
                f"{len(keep)} workers go on")
        self.mesh = Mesh((len(keep),), (shard_axis_name,), self.mesh.device,
                         DistComm((len(keep),), group=group))
        self._pool = list(self.mesh.slots)
        return True

    def resize(self, width: int) -> bool:
        """Deliberate mesh re-width, a control-plane actuation and not a
        recovery: rebuild the mesh at ``width`` workers over the pool's
        prefix. Returns True when the mesh changed; the CALLER re-places
        its state, as after ``heal``. Refused (False) for the
        ``fixed_width`` policy, mesh-less and distributed healers,
        out-of-pool widths and no-op widths. Counts as a
        ``reshard_events`` and records a ``mesh_resize`` flight event."""
        from tuplewise_tpu_torch.parallel.mesh import make_mesh

        if (self.mesh is None or self.fixed_width is not None
                or self.mesh.distributed):
            return False
        width = int(width)
        old = self.n_workers
        if width < 1 or width > len(self._pool) or width == old:
            return False
        self.mesh = make_mesh(width, self.mesh.device,
                              slots=self._pool[:width], pool=self._pool)
        self._c_reshard.inc()
        if self.flight is not None:
            self.flight.record("mesh_resize", from_width=old,
                               to_width=width)
        return True

    def heal(self, attempt: int,
             on_heal: Optional[Callable] = None) -> bool:
        """One recovery round: probe/reshard, let the caller re-place
        (``on_heal(self)``, unconditional: state may be torn even when
        the mesh itself survived), record the recovery, back off.
        Returns True when the mesh changed."""
        changed = False
        if self.mesh is not None:
            t0 = time.perf_counter()
            changed = self._reshard()
            if on_heal is not None:
                on_heal(self)
            self._c_reshard.inc()
            dt = time.perf_counter() - t0
            self._h_recovery.observe(dt)
            if self.flight is not None:
                self.flight.record(
                    "heal", attempt=attempt, mesh_changed=changed,
                    mesh_width=self.n_workers, recovery_s=dt)
        elif on_heal is not None:
            on_heal(self)
        self.backoff.sleep(attempt)
        return changed

    def run(self, fn: Callable[[], object], *, retries: int = 3,
            on_heal: Optional[Callable] = None, lock=None):
        """Execute ``fn()`` under the heal-and-retry protocol: on
        failure, heal (probe → reshard → ``on_heal`` re-placement →
        backoff) and retry, at most ``retries`` times; persistent
        failure re-raises rather than spinning. ``HealExhaustedError``
        and ``WorkerDroppedError`` propagate at once (retrying cannot
        help). ``lock``: held across each heal round (not the attempts),
        so a caller whose state other threads read can heal from a
        thread that does not hold it."""
        attempt = 0
        while True:
            try:
                return fn()
            except (HealExhaustedError, WorkerDroppedError):
                raise
            except Exception:  # noqa: BLE001 — re-raised past the bound
                attempt += 1
                if attempt > retries:
                    raise
                self._c_retries.inc()
                if lock is None:
                    self.heal(attempt, on_heal=on_heal)
                else:
                    with lock:
                        self.heal(attempt, on_heal=on_heal)
