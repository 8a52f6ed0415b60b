"""Observability of the serving and batch paths.

* ``tracing.Tracer``        — span tracing: monotonic clocks, explicit
                              parent/child ids, a bounded thread-safe
                              ring, hard-off by default (call sites hold
                              None and pay one ``is not None`` check);
                              span JSONL and Chrome trace-event exports.
* ``flight.FlightRecorder`` — a bounded ring of lifecycle events
                              (compactions, restarts, snapshots, heals,
                              chaos injections), trace-id correlated,
                              dumped as JSONL (next to the recovery
                              snapshots when recovery is on).
* ``metrics_export.MetricsFlusher`` — a side thread appending registry
                              snapshots to JSONL at a fixed cadence, with
                              rotation and row observers.
* ``slo.SloMonitor``        — declarative SLO objectives (latency
                              quantiles, burn-rate error budgets, counter
                              caps, saturation, label wildcards) judged
                              on each flushed row, with observer and
                              actuator hooks.
* ``prof.SamplingProfiler`` — hard-off folded-stack sampler with a
                              guarded overhead; collapsed and speedscope
                              exports.
* ``ledger.WaveLedger``     — the host-tax split of every insert
                              micro-batch into queue wait, lock wait,
                              host Python, dispatch, device compute,
                              first-use build and GC buckets.
* ``health``                — CI-width tracking of the streaming
                              estimate and drift against the exact
                              index.
* ``report``                — the functions that build ``replay``'s
                              report.
* ``doctor``                — post-hoc diagnosis of a run's artifacts
                              (metrics, flight dump, spans): SLO, health,
                              host-tax and kernel verdicts, fault and
                              actuation attribution, one machine verdict
                              line.
"""

from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.health import (
    DriftDetector, EstimateHealth, shard_balance,
)
from tuplewise_tpu_torch.obs.ledger import WaveLedger, device_section
from tuplewise_tpu_torch.obs.metrics_export import (
    MetricsFlusher, config_digest,
)
from tuplewise_tpu_torch.obs.prof import SamplingProfiler
from tuplewise_tpu_torch.obs.report import (
    host_tax_block, recovery_counters, service_report,
)
from tuplewise_tpu_torch.obs.slo import SloMonitor, SloSpec, evaluate_history
from tuplewise_tpu_torch.obs.tracing import Span, Tracer

__all__ = [
    "DriftDetector",
    "EstimateHealth",
    "FlightRecorder",
    "MetricsFlusher",
    "SamplingProfiler",
    "SloMonitor",
    "SloSpec",
    "Span",
    "Tracer",
    "WaveLedger",
    "config_digest",
    "device_section",
    "evaluate_history",
    "host_tax_block",
    "recovery_counters",
    "service_report",
    "shard_balance",
]
