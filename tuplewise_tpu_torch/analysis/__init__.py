"""Static invariant checks of the port (the counterpart of
``tuplewise_tpu.analysis``; standard library only, ``ast`` over the
port's sources, never an import of them), exposed as ``tuplewise-torch
check`` and a fail-mode CI leg (``scripts_torch/analysis_gate.py``).
It scans ``tuplewise_tpu_torch/**/*.py``, ``scripts_torch/*.py`` and
``bench_torch*.py``. Each pass keeps the reference's rules; where the
reference's hook is a JAX marker (``jax.jit``, ``pl.pallas_call``, an
``lru_cache`` jit factory) that torch eager does not have, the pass
holds a declared table of the port's counterpart instead:

* ``lock-order``      — lock-acquisition graph, acquisition-order
                        cycles, locks held across blocking ops
                        (device dispatch: the count kernels' launchers
                        and their searchsorted twins, the count layer,
                        the ``parallel.comm`` collectives,
                        ``torch.cuda.synchronize``; unbounded queue
                        put/get, fsync, sleep, ``Future.result``).
* ``traced-purity``   — inside the device bodies (``TRACED_ROOTS``, the
                        counterparts of the reference's traced code,
                        and every ``torch.autograd.Function``'s forward
                        and backward): no wall-clock reads, no host or
                        global-generator RNG, no ``float()``/``int()``
                        of a tensor, no syncs (``.item()``,
                        ``.tolist()``, ``.cpu()``, ``.numpy()``).
* ``telemetry-xref``  — every metric / flight-event kind / span name
                        consumed by doctor / SLO / report / perf-gate
                        (or documented) must have a matching producer.
* ``compile-ladder``  — the size arguments of the chokepoints
                        (``CHOKEPOINTS``: the placements, counts,
                        append and merge) must come off the bucket
                        helpers, never raw ``len()``-derived values.
* ``config-drift``    — ServingConfig/TenancyConfig/ControllerConfig
                        fields <-> CLI flags <-> README/DESIGN mentions
                        must agree.
* ``races``           — guard inference: per thread role, attributes
                        reachable from >= 2 roles that are accessed
                        unguarded or under inconsistent locks.
* ``exactness``       — int-lattice proof that no float taints a wins2
                        accumulator, plus the int32 overflow
                        certificate of the declared accumulators
                        (``ACCUMULATORS``) at the compile-ladder maxima,
                        diffed in CI against exactness_bounds.toml.
* ``hotpath``         — abstract cost certification of everything
                        reachable from the request-path roots (a kernel
                        launcher is a dispatch leaf), classified
                        O(1)/O(tenants)/O(events) and diffed in CI
                        against hotpath_budget.toml: growth fails,
                        shrinkage ratchets the budget down.
* ``lifecycle``       — every Future resolves on every path,
                        Thread/Timer daemon-or-join, file handles close
                        on exception paths, every typed serving error is
                        wire-handled, doctor-visible and documented.

Findings are suppressible ONLY via the committed, per-finding-justified
waiver file (``analysis/waivers.toml``); each waiver absorbs a bounded
count of findings, so NEW violations fail even where old waived ones
exist (the ratchet). The shared module graph also emits an import-cycle
report (fail on new top-level cycles) and a warn-only dead-public-
symbol list. DESIGN §17 documents the rule catalogue and waiver policy.
"""

from tuplewise_tpu_torch.analysis.core import Finding, ModuleSet

__all__ = ["Finding", "ModuleSet", "PASSES", "run_checks"]


def __getattr__(name):
    # lazy: the runner imports every pass module, and the passes import
    # this package — a top-level import here would be exactly the
    # import cycle the module-graph report exists to forbid
    if name in ("PASSES", "run_checks"):
        from tuplewise_tpu_torch.analysis import runner

        return getattr(runner, {"PASSES": "PASSES",
                                "run_checks": "run_checks"}[name])
    raise AttributeError(name)
