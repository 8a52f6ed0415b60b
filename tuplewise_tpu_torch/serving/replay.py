"""Replay a scored event stream through the micro-batch engine.

The single-tenant counterpart of ``tuplewise_tpu.serving.replay``: make
(or accept) a stream of (score, label) events, submit them as
individual requests (the engine's batcher does the coalescing), and
report sustained events/s, latency percentiles, batch fill, backpressure
counts, the host-tax split and exact-AUC parity against the batch
oracle. The record carries the JAX record's keys.
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
    service_report, stage_attribution, stage_p99_ms,
)
from tuplewise_tpu_torch.serving.engine import (
    BackpressureError, MicroBatchEngine, PoisonEventError, ServingConfig,
)


def make_stream(n_events: int, pos_frac: float = 0.5,
                separation: float = 1.0, seed: int = 0):
    """Shuffled Gaussian score stream: positives ~ N(separation, 1),
    negatives ~ N(0, 1), labels i.i.d. Bernoulli(pos_frac). The same
    draws as the JAX package's ``make_stream``."""
    rng = np.random.default_rng(seed)
    labels = rng.random(n_events) < pos_frac
    scores = rng.standard_normal(n_events) + separation * labels
    return scores, labels


def config_digest(config) -> str:
    """Short stable digest of a config: the key that joins records of
    one configuration across runs."""
    blob = json.dumps(dataclasses.asdict(config), sort_keys=True,
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


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

    Fault injection (``chaos``), span tracing (``tracer``,
    ``trace_out``), metrics export (``metrics_out``), profiling
    (``profile_dir``, ``prof``, ``prof_out``), SLOs and the control plane
    (``slo_spec``, ``controller_spec``) are not ported yet: anything but
    None raises ``NotImplementedError``.
    """
    unported = dict(chaos=chaos, tracer=tracer, trace_out=trace_out,
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
    if warmup:
        replay(scores, labels, config=cfg, score_every=score_every,
               query_every=query_every, chunk=chunk, warmup=False,
               max_inflight=max_inflight)
    rejected = 0
    poison_rejected = 0
    admitted = np.ones(n, dtype=bool)
    futures = []
    with MicroBatchEngine(cfg) as eng:
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            j = min(i + chunk, n)
            try:
                futures.append(eng.insert(scores[i:j], labels[i:j]))
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
