"""The functions that build the report of ``replay`` records.

A copy of ``tuplewise_tpu.obs.report``: every input is the plain-dict
output of ``MetricsRegistry.snapshot()``, so the functions also work on
a saved snapshot. A fleet's metrics add the ``tenancy`` block, a run
with a ``serving.control.FleetController`` the ``controller`` block.
"""

from __future__ import annotations

from typing import Optional

# the insert-latency decomposition: consecutive boundary timestamps in
# the engine's insert apply path, so the stage values of one request sum
# exactly to its measured insert latency
INSERT_STAGES = ("queue_wait", "coalesce", "wal_append", "index_insert",
                 "stream_extend", "snapshot", "resolve")


def stage_metric(stage: str) -> str:
    return f"insert_stage_{stage}_s"


# the recovery counter set every report carries
_RECOVERY_COUNTERS = (
    "reshard_events",
    "shard_retries_total",
    "bg_compactor_restarts",
    "batcher_restarts",
    "major_merge_fallbacks",
    "poison_rejects",
    "deadline_expired_total",
    "flusher_late_flushes_total",
)

# the host-tax buckets obs.ledger.WaveLedger bills, in tiling order
HOST_TAX_BUCKETS = ("queue_wait", "lock_wait", "host_python",
                    "dispatch", "device_compute", "xla_compile",
                    "gc_pause")


def host_tax_metric(bucket: str) -> str:
    return f"host_tax_{bucket}_s"


def _v(m: dict, name: str):
    return m.get(name, {}).get("value", 0)


def _p_ms(m: dict, name: str, q: str):
    v = m.get(name, {}).get(q)
    return None if v is None else v * 1e3


def recovery_counters(metrics: dict) -> dict:
    """The recovery counter block of a report."""
    return {name: _v(metrics, name) for name in _RECOVERY_COUNTERS}


def stage_p99_ms(metrics: dict) -> dict:
    """Per-stage insert-latency p99s (ms), one entry per stage that
    recorded at least one sample."""
    out = {}
    for stage in INSERT_STAGES:
        p = _p_ms(metrics, stage_metric(stage), "p99")
        if p is not None:
            out[stage] = p
    return out


def stage_attribution(metrics: dict) -> Optional[dict]:
    """Stage sums against the ``insert_latency_s`` sum: ``coverage`` is
    1.0 up to float rounding, since the stages tile each request's
    lifetime."""
    total = metrics.get("insert_latency_s", {})
    if not total.get("count"):
        return None
    attributed = sum(
        metrics.get(stage_metric(s), {}).get("sum", 0.0)
        for s in INSERT_STAGES)
    return {
        "attributed_s": attributed,
        "measured_s": total["sum"],
        "coverage": (attributed / total["sum"]) if total["sum"] else None,
    }


def host_tax_block(metrics: dict) -> Optional[dict]:
    """The host-tax summary: host and device fractions, coverage (bucket
    sums over measured insert latency, 1.0 up to float rounding),
    first-use build and GC event counts, and per-bucket p99s. None when
    no wave was recorded."""
    if not metrics.get("host_tax_waves_total", {}).get("value"):
        return None
    total = metrics.get("insert_latency_s", {})
    attributed = sum(
        metrics.get(host_tax_metric(b), {}).get("sum", 0.0)
        for b in HOST_TAX_BUCKETS)
    batches = _v(metrics, "batches_total")
    compile_events = _v(metrics, "xla_compile_events_total")
    p99 = {}
    for b in HOST_TAX_BUCKETS:
        p = _p_ms(metrics, host_tax_metric(b), "p99")
        if p is not None:
            p99[b] = p
    return {
        "host_fraction": metrics.get(
            "host_tax_host_fraction", {}).get("value"),
        "device_fraction": metrics.get(
            "host_tax_device_fraction", {}).get("value"),
        "coverage": ((attributed / total["sum"])
                     if total.get("sum") else None),
        "attributed_s": attributed,
        "measured_s": total.get("sum", 0.0),
        "waves": _v(metrics, "host_tax_waves_total"),
        "compile_events": compile_events,
        "compile_events_per_1k_batches": (
            1e3 * compile_events / batches if batches else None),
        "gc_pauses": _v(metrics, "gc_pauses_total"),
        "gc_pause_p99_ms": _p_ms(metrics, "gc_pause_s", "p99"),
        "tail_exemplars": _v(metrics, "tail_exemplars_total"),
        "bucket_p99_ms": p99,
    }


def service_report(metrics: dict, chaos=None, flight=None,
                   slo=None) -> dict:
    """The shared serving report: load shedding, compaction, transfer,
    latency with per-stage p99 attribution, the host-tax block and the
    recovery counters. ``chaos``: an optional ``FaultInjector`` whose
    ``snapshot()`` rides along; ``flight``: an optional
    ``FlightRecorder`` whose per-kind event counts ride along; ``slo``:
    an optional ``obs.slo.SloMonitor`` (or a report dict) whose verdicts
    ride along under ``"slo"``."""
    report = {
        "rejected_total": _v(metrics, "rejected_total"),
        "dropped_total": _v(metrics, "dropped_total"),
        "compactions_total": _v(metrics, "compactions_total"),
        "compaction_pause_p99_ms": _p_ms(metrics, "compaction_pause_s",
                                         "p99"),
        "compaction_pause_max_ms": _p_ms(metrics, "compaction_pause_s",
                                         "max"),
        "insert_latency_p99_ms": _p_ms(metrics, "insert_latency_s",
                                       "p99"),
        "insert_stage_p99_ms": stage_p99_ms(metrics),
        "stage_attribution": stage_attribution(metrics),
        "host_tax": host_tax_block(metrics),
        "bytes_h2d": _v(metrics, "bytes_h2d"),
        "bytes_h2d_saved": _v(metrics, "bytes_h2d_saved"),
        "major_merges_total": _v(metrics, "major_merges_total"),
    }
    report.update(recovery_counters(metrics))
    # the fleet block, only when the metrics came from a multi-tenant
    # engine (single-tenant reports keep their key set)
    if "fleet_count_calls_total" in metrics:
        report["tenancy"] = {
            "tenants_live": _v(metrics, "tenants_live"),
            "tenants_created_total": _v(metrics, "tenants_created_total"),
            "tenants_evicted_total": _v(metrics, "tenants_evicted_total"),
            "tenant_rejected_total": _v(metrics, "tenant_rejected_total"),
            "fleet_count_calls": _v(metrics, "fleet_count_calls_total"),
            "fleet_compact_aborts": _v(metrics, "fleet_compact_aborts"),
            "whale_promotions": _v(metrics, "fleet_whale_promotions"),
            "whale_demotions": _v(metrics, "fleet_whale_demotions"),
            "whales_live": _v(metrics, "fleet_whales"),
            "pack_replaces": _v(metrics, "pack_replaces_total"),
            "pack_full_replaces": _v(metrics, "pack_full_replaces_total"),
            "pack_occupancy": _v(metrics, "pack_occupancy"),
            "pack_stale_rows": _v(metrics, "pack_stale_rows"),
            "tenant_metric_collapsed": _v(metrics,
                                          "tenant_metric_collapsed"),
        }
    # the control-plane block, only when a FleetController ran (reports
    # of runs without one keep their key set)
    if "controller_actuations_total" in metrics:
        report["controller"] = {
            "actuations_total": _v(metrics, "controller_actuations_total"),
            "reverts_total": _v(metrics, "controller_reverts_total"),
            "tenant_throttled_total": _v(metrics, "tenant_throttled_total"),
            "throttled_now": _v(metrics, "controller_throttled_tenants"),
            "flush_scale": _v(metrics, "controller_flush_scale"),
            "max_batch": _v(metrics, "controller_max_batch"),
            "mesh_level": _v(metrics, "controller_mesh_level"),
        }
    if chaos is not None:
        report["chaos"] = chaos.snapshot()
    if flight is not None:
        report["flight_events"] = flight.counts()
    if slo is not None:
        report["slo"] = slo.report() if hasattr(slo, "report") else slo
    return report
