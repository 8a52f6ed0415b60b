"""Replay a scored event stream through the micro-batch engines.

The counterpart of ``tuplewise_tpu.serving.replay``: make (or accept) a
stream of (score, label) events, submit them as individual requests (the
engine's batcher does the coalescing), and report sustained events/s,
latency percentiles, batch fill, backpressure counts, the host-tax split
and exact-AUC parity against the batch oracle. ``replay`` drives the
single-tenant ``MicroBatchEngine``; ``replay_fleet`` drives the
``MultiTenantEngine`` with a tenant-assigned stream
(``make_tenant_stream``) and checks every tenant's AUC against its own
oracle. The records carry the JAX records' keys.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

import numpy as np

from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.obs.report import (
    recovery_counters, service_report, stage_attribution, stage_p99_ms,
)
from tuplewise_tpu_torch.serving.engine import (
    BackpressureError, EngineClosedError, MicroBatchEngine,
    PoisonEventError, ServingConfig,
)
from tuplewise_tpu_torch.utils.profiling import parse_labeled_name


def make_stream(n_events: int, pos_frac: float = 0.5,
                separation: float = 1.0, seed: int = 0):
    """Shuffled Gaussian score stream: positives ~ N(separation, 1),
    negatives ~ N(0, 1), labels i.i.d. Bernoulli(pos_frac). The same
    draws as the JAX package's ``make_stream``."""
    rng = np.random.default_rng(seed)
    labels = rng.random(n_events) < pos_frac
    scores = rng.standard_normal(n_events) + separation * labels
    return scores, labels


def make_tenant_stream(n_events: int, n_tenants: int, skew: float = 1.0,
                       pos_frac: float = 0.5, separation: float = 1.0,
                       seed: int = 0):
    """Multi-tenant stream: the Gaussian score stream plus a per-event
    tenant drawn from a Zipf law (tenant rank k with probability
    proportional to ``1 / k**skew``; ``skew=0`` is uniform). Returns
    ``(scores, labels, tenant_ids)`` with ids ``"t0".."t{n-1}"`` in rank
    order. The same draws as the JAX package's ``make_tenant_stream``."""
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1: {n_tenants}")
    if skew < 0:
        raise ValueError(f"skew must be >= 0: {skew}")
    rng = np.random.default_rng(seed)
    labels = rng.random(n_events) < pos_frac
    scores = rng.standard_normal(n_events) + separation * labels
    if n_tenants == 1:
        ks = np.zeros(n_events, dtype=np.int64)
    else:
        p = np.arange(1, n_tenants + 1, dtype=np.float64) ** (-skew)
        p /= p.sum()
        ks = rng.choice(n_tenants, size=n_events, p=p)
    tenants = np.asarray([f"t{k}" for k in ks])
    return scores, labels, tenants


def config_digest(config) -> str:
    """Short stable digest of a config: the key that joins records of
    one configuration across runs."""
    blob = json.dumps(dataclasses.asdict(config), sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def _injector(chaos):
    """A ``FaultInjector`` from an injector or a spec (None: none)."""
    if chaos is None:
        return None
    from tuplewise_tpu_torch.testing.chaos import FaultInjector

    if isinstance(chaos, FaultInjector):
        return chaos
    return FaultInjector.from_spec(chaos)


def replay(scores, labels, config: Optional[ServingConfig] = None,
           score_every: int = 0, query_every: int = 0,
           chunk: int = 1, warmup: bool = False,
           max_inflight: Optional[int] = None,
           flight_out: Optional[str] = None,
           run_id: Optional[str] = None, chaos=None, tracer=None,
           trace_out: Optional[str] = None,
           metrics_out: Optional[str] = None,
           profile_dir: Optional[str] = None, slo_spec=None,
           controller_spec=None, prof=None,
           prof_out: Optional[str] = None, **overrides) -> dict:
    """Drive the engine with one request per event (or per ``chunk``
    events) and return the measurement record.

    ``score_every`` / ``query_every``: interleave a score / query
    request every k requests (0 = never). ``max_inflight``: bound the
    outstanding requests (the submitter waits for the oldest future past
    the bound), so latency percentiles measure per-event cost, not
    backlog. ``warmup=True`` replays the stream once through a throwaway
    engine first, so the timed run measures the steady state (the
    kernel library's first load, the allocator's first blocks).
    ``flight_out``: dump the engine's flight recorder after the run.
    ``run_id``: a caller-chosen identity stamped into the record.

    ``chaos``: a ``testing.chaos.FaultInjector`` (or a spec
    ``FaultInjector.from_spec`` takes) threaded through the engine's hook
    points; its ``poison`` schedule corrupts the stream at the scheduled
    event positions before submission (the engine's edge validation
    rejects them). The record then carries a ``faults`` block with the
    recovery counters, and the oracle check runs over the admitted events
    only. The warmup run stays chaos-free.

    Span tracing (``tracer``, ``trace_out``), metrics export
    (``metrics_out``), profiling (``profile_dir``, ``prof``,
    ``prof_out``), SLOs and the control plane (``slo_spec``,
    ``controller_spec``) are not ported yet: anything but None raises
    ``NotImplementedError``.
    """
    unported = dict(tracer=tracer, trace_out=trace_out,
                    metrics_out=metrics_out, profile_dir=profile_dir,
                    slo_spec=slo_spec, controller_spec=controller_spec,
                    prof=prof, prof_out=prof_out)
    named = sorted(k for k, v in unported.items() if v not in (None, False))
    if named:
        raise NotImplementedError(
            f"replay options not ported to tuplewise_tpu_torch yet: {named}")
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n = len(scores)
    cfg = config or ServingConfig(**overrides)
    injector = _injector(chaos)
    if warmup:
        replay(scores, labels, config=cfg, score_every=score_every,
               query_every=query_every, chunk=chunk, warmup=False,
               max_inflight=max_inflight)
    rejected = 0
    poison_rejected = 0
    admitted = np.ones(n, dtype=bool)
    futures = []
    with MicroBatchEngine(cfg, chaos=injector) as eng:
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            j = min(i + chunk, n)
            sub = scores[i:j]
            if injector is not None:
                sub, _ = injector.poison_batch(i, sub)
            try:
                futures.append(eng.insert(sub, labels[i:j]))
            except PoisonEventError:
                poison_rejected += j - i
                admitted[i:j] = False
            except BackpressureError:
                rejected += j - i
                admitted[i:j] = False
            if max_inflight and len(futures) >= max_inflight:
                try:
                    futures[len(futures) - max_inflight].result(
                        timeout=60.0)
                except BackpressureError:
                    pass    # counted in the final wait below
            if score_every and (i // chunk) % score_every \
                    == score_every - 1:
                try:
                    futures.append(eng.score(scores[i:j]))
                except BackpressureError:
                    pass
            if query_every and (i // chunk) % query_every \
                    == query_every - 1:
                try:
                    futures.append(eng.query())
                except BackpressureError:
                    pass
        # wait for everything admitted (dropped futures raise)
        dropped = 0
        for f in futures:
            try:
                f.result(timeout=60.0)
            except BackpressureError:
                dropped += 1
        wall = time.perf_counter() - t0
        if eng.index is not None and cfg.bg_compact:
            # settle in-flight background builds outside the timed window
            eng.index.wait_idle()
        stats = eng.stats()
    flight_counts = eng.flight.counts()
    if flight_out:
        eng.flight.dump_to(flight_out)

    m = stats["metrics"]
    lat = m["request_latency_s"]
    ins = m.get("insert_latency_s", {})
    pause = m.get("compaction_pause_s", {})
    cbytes = m.get("compaction_bytes", {})
    major = m.get("major_merge_s", {})
    fill = m["batch_fill"]
    applied = m["events_total"]["value"]

    def _ms(snap, q):
        v = snap.get(q)
        return None if v is None else v * 1e3

    rec = {
        "n_events": n,
        "events_applied": int(applied),
        "events_rejected": int(rejected),
        "events_poison_rejected": int(poison_rejected),
        "requests_dropped": int(dropped),
        "wall_s": wall,
        "events_per_s": applied / wall if wall > 0 else None,
        "latency_p50_ms": _ms(lat, "p50"),
        "latency_p99_ms": _ms(lat, "p99"),
        "insert_latency_p50_ms": _ms(ins, "p50"),
        "insert_latency_p95_ms": _ms(ins, "p95"),
        "insert_latency_p99_ms": _ms(ins, "p99"),
        "insert_latency_max_ms": _ms(ins, "max"),
        "compactions": pause.get("count", 0),
        "compaction_pause_p99_ms": _ms(pause, "p99"),
        "compaction_pause_max_ms": _ms(pause, "max"),
        "bytes_h2d": m.get("bytes_h2d", {}).get("value", 0),
        "bytes_h2d_saved": m.get("bytes_h2d_saved", {}).get("value", 0),
        "bytes_per_compaction": cbytes.get("mean"),
        "major_merges": m.get("major_merges_total", {}).get("value", 0),
        "major_merge_fallbacks": m.get(
            "major_merge_fallbacks", {}).get("value", 0),
        "major_merge_p99_ms": _ms(major, "p99"),
        "batches": m["batches_total"]["value"],
        "mean_batch_fill": fill["mean"],
        "insert_stage_p99_ms": stage_p99_ms(m),
        "stage_attribution": stage_attribution(m),
        "flight_events": flight_counts,
        "auc_exact": stats.get("auc_exact"),
        "estimate_incomplete": stats["estimate_incomplete"],
        "incomplete_pairs": m["incomplete_pairs_total"]["value"],
        "index": stats.get("index"),
        "config": {
            "kernel": cfg.kernel, "budget": cfg.budget,
            "reservoir": cfg.reservoir, "design": cfg.design,
            "window": cfg.window, "max_batch": cfg.max_batch,
            "flush_timeout_s": cfg.flush_timeout_s,
            "queue_size": cfg.queue_size, "policy": cfg.policy,
            "engine": cfg.engine, "chunk": chunk,
            "mesh_shards": cfg.mesh_shards, "bg_compact": cfg.bg_compact,
            "count_kernel": cfg.count_kernel, "device": cfg.device,
        },
        "config_digest": config_digest(cfg),
    }
    if run_id is not None:
        rec["run_id"] = run_id
    rec["report"] = service_report(m)
    rec["host_tax"] = rec["report"]["host_tax"]
    if injector is not None:
        rec["faults"] = dict(recovery_counters(m),
                             chaos=injector.snapshot())
        rec["n_admitted"] = int(admitted.sum())
        rec["shed_events"] = np.nonzero(~admitted)[0].tolist()

    # oracle parity of the final exact estimate (windowed: the oracle of
    # the retained suffix of the admitted events)
    if (cfg.kernel == "auc" and rejected == 0 and dropped == 0
            and rec["auc_exact"] is not None):
        adm_s, adm_l = scores[admitted], labels[admitted]
        w = cfg.window
        tail_s = adm_s if w is None else adm_s[-w:]
        tail_l = adm_l if w is None else adm_l[-w:]
        dt = np.float32 if cfg.engine == "torch" else np.float64
        rec["auc_oracle"] = auc_score(np.asarray(tail_s[tail_l], dtype=dt),
                                      np.asarray(tail_s[~tail_l], dtype=dt))
        rec["auc_abs_err"] = abs(rec["auc_exact"] - rec["auc_oracle"])
    return rec


def replay_fleet(scores, labels, tenants,
                 config: Optional[ServingConfig] = None, tenancy=None,
                 chunk: int = 1, max_inflight: Optional[int] = None,
                 run_id: Optional[str] = None, warmup: bool = False,
                 oracle_check: bool = True, chaos=None, slo_spec=None,
                 controller_spec=None, metrics_out: Optional[str] = None,
                 flight_out: Optional[str] = None, **overrides) -> dict:
    """Replay a tenant-assigned stream through a ``MultiTenantEngine``
    and return the fleet measurement record.

    One insert request per ``chunk`` consecutive events, cut at tenant
    boundaries so every request is single-tenant; ``max_inflight`` bounds
    the outstanding requests; ``warmup=True`` replays once through a
    throwaway engine first. Admission sheds (``TenantRejectedError``,
    ``TenantThrottledError``, backpressure, poison) are counted and left
    out of the oracle. With ``oracle_check`` and nothing shed, every
    tenant's final exact AUC is compared with the float32 batch oracle of
    its own admitted (windowed) events: ``tenant_auc_max_abs_err``.
    ``chaos``: as in :func:`replay` (the fleet engine's points, the
    stream's poison schedule, a ``faults`` block in the record).

    SLOs and the control plane (``slo_spec``, ``controller_spec``),
    metrics export (``metrics_out``) and the flight dump (``flight_out``)
    are not ported yet: anything but None raises ``NotImplementedError``.
    """
    from tuplewise_tpu_torch.serving.tenancy import (
        MultiTenantEngine, TenancyConfig, TenantRejectedError,
        TenantThrottledError,
    )

    unported = dict(slo_spec=slo_spec, controller_spec=controller_spec,
                    metrics_out=metrics_out, flight_out=flight_out)
    named = sorted(k for k, v in unported.items() if v is not None)
    if named:
        raise NotImplementedError(
            f"replay_fleet options not ported to tuplewise_tpu_torch yet: "
            f"{named}")
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    tenants = np.asarray(tenants).ravel()
    n = len(scores)
    if len(tenants) != n:
        raise ValueError(
            f"tenants/scores length mismatch: {len(tenants)} vs {n}")
    cfg = config or ServingConfig(**overrides)
    ten_cfg = tenancy if tenancy is not None else TenancyConfig()
    injector = _injector(chaos)
    if warmup:
        replay_fleet(scores, labels, tenants, config=cfg, tenancy=ten_cfg,
                     chunk=chunk, max_inflight=max_inflight,
                     oracle_check=False)
    admitted = np.ones(n, dtype=bool)
    rejected = poison_rejected = tenant_rejected = tenant_throttled = 0
    futures = []
    with MultiTenantEngine(cfg, ten_cfg, chaos=injector) as eng:
        t0 = time.perf_counter()
        i = 0
        while i < n:
            # a request is single-tenant: cut the chunk at the next
            # tenant boundary (the engine coalesces across tenants)
            j = min(i + chunk, n)
            tid = tenants[i]
            while j > i + 1 and not np.all(tenants[i:j] == tid):
                j -= 1
            sub = scores[i:j]
            if injector is not None:
                sub, _ = injector.poison_batch(i, sub)
            try:
                futures.append(eng.insert(tid, sub, labels[i:j]))
            except PoisonEventError:
                poison_rejected += j - i
                admitted[i:j] = False
            except TenantThrottledError:
                tenant_throttled += j - i
                admitted[i:j] = False
            except TenantRejectedError:
                tenant_rejected += j - i
                admitted[i:j] = False
            except BackpressureError:
                rejected += j - i
                admitted[i:j] = False
            if max_inflight and len(futures) >= max_inflight:
                try:
                    futures[len(futures) - max_inflight].result(
                        timeout=60.0)
                except (BackpressureError, EngineClosedError):
                    pass
            i = j
        dropped = 0
        for f in futures:
            try:
                f.result(timeout=60.0)
            except BackpressureError:
                dropped += 1
        wall = time.perf_counter() - t0
        if cfg.bg_compact:
            # settle in-flight background builds outside the timed window
            eng.fleet.wait_idle()
        stats = eng.stats()
        tenant_stats = {t: eng.tenant_stats(t) for t in eng.fleet.tenants()}
    flight_counts = eng.flight.counts()

    m = stats["metrics"]
    ins = m.get("insert_latency_s", {})
    applied = m["events_total"]["value"]

    def _ms(snap, q):
        v = snap.get(q)
        return None if v is None else v * 1e3

    def _val(name):
        return m.get(name, {}).get("value", 0)

    # per-tenant insert p99 from the labeled histograms
    tenant_p99 = {}
    for key, snap in m.items():
        base, lab = parse_labeled_name(key)
        if base == "insert_latency_s" and lab and "tenant" in lab:
            p = snap.get("p99")
            if p is not None:
                tenant_p99[lab["tenant"]] = p * 1e3
    p99s = sorted(tenant_p99.values())
    rec = {
        "n_events": n,
        "n_tenants": int(len(np.unique(tenants))),
        "tenants_live": stats["tenants_live"],
        "events_applied": int(applied),
        "events_rejected": int(rejected),
        "events_tenant_rejected": int(tenant_rejected),
        "events_tenant_throttled": int(tenant_throttled),
        "events_poison_rejected": int(poison_rejected),
        "requests_dropped": int(dropped),
        "wall_s": wall,
        "events_per_s": applied / wall if wall > 0 else None,
        "insert_latency_p50_ms": _ms(ins, "p50"),
        "insert_latency_p95_ms": _ms(ins, "p95"),
        "insert_latency_p99_ms": _ms(ins, "p99"),
        "tenant_insert_p99_ms": (tenant_p99 if len(tenant_p99) <= 64
                                 else None),
        "tenant_insert_p99_max_ms": p99s[-1] if p99s else None,
        "tenant_insert_p99_median_ms": (p99s[len(p99s) // 2]
                                        if p99s else None),
        "admission": {
            "tenant_rejected_total": _val("tenant_rejected_total"),
            "tenant_throttled_total": _val("tenant_throttled_total"),
            "rejected_total": _val("rejected_total"),
            "dropped_total": _val("dropped_total"),
            "tenants_created_total": _val("tenants_created_total"),
            "tenants_evicted_total": _val("tenants_evicted_total"),
        },
        "batches": m["batches_total"]["value"],
        "fleet_count_calls": _val("fleet_count_calls_total"),
        "bytes_h2d": _val("bytes_h2d"),
        "bytes_h2d_saved": _val("bytes_h2d_saved"),
        "pack_replaces": _val("pack_replaces_total"),
        "pack_full_replaces": _val("pack_full_replaces_total"),
        "whale_promotions": _val("fleet_whale_promotions"),
        "whale_demotions": _val("fleet_whale_demotions"),
        "flight_events": flight_counts,
        "fleet": stats["fleet"],
        "config": {
            "budget": cfg.budget, "window": cfg.window,
            "max_batch": cfg.max_batch, "queue_size": cfg.queue_size,
            "policy": cfg.policy, "mesh_shards": cfg.mesh_shards,
            "chunk": chunk, "max_tenants": ten_cfg.max_tenants,
            "tenant_quota": ten_cfg.tenant_quota,
            "weight": ten_cfg.weight, "bg_compact": cfg.bg_compact,
            "whale_threshold": ten_cfg.whale_threshold,
            "tenant_metric_cap": ten_cfg.tenant_metric_cap,
            "count_kernel": cfg.count_kernel, "device": cfg.device,
        },
        "config_digest": config_digest(cfg),
    }
    if run_id is not None:
        rec["run_id"] = run_id
    rec["report"] = service_report(m)
    rec["host_tax"] = rec["report"]["host_tax"]
    if injector is not None:
        rec["faults"] = dict(recovery_counters(m),
                             chaos=injector.snapshot())

    # per-tenant oracle parity: each tenant's exact AUC against the batch
    # oracle of its own admitted (windowed) events
    if oracle_check and rejected == 0 and dropped == 0 \
            and tenant_rejected == 0:
        worst = 0.0
        for tid in np.unique(tenants):
            mask = admitted & (tenants == tid)
            ts_, tl_ = scores[mask], labels[mask]
            if cfg.window is not None:
                ts_, tl_ = ts_[-cfg.window:], tl_[-cfg.window:]
            got = (tenant_stats.get(str(tid)) or {}).get("auc_exact")
            if got is None or not tl_.any() or tl_.all():
                continue
            want = auc_score(np.asarray(ts_[tl_], dtype=np.float32),
                             np.asarray(ts_[~tl_], dtype=np.float32))
            worst = max(worst, abs(got - want))
        rec["tenant_auc_max_abs_err"] = worst
    return rec
