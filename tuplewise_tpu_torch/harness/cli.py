"""L6 — the experiment and serving CLI of the PyTorch port.

The counterpart of ``tuplewise_tpu.harness.cli``, installed as
``tuplewise-torch`` and runnable as ``python -m
tuplewise_tpu_torch.harness.cli``::

    tuplewise-torch variance --scheme repartitioned --n-rounds 4
    tuplewise-torch tradeoff-rounds --n-reps 200 --out results.jsonl
    tuplewise-torch tradeoff-pairs
    tuplewise-torch tradeoff-workers --workers 8 1000 125000
    tuplewise-torch triplet --n 2000
    tuplewise-torch train --dataset adult --steps 100
    tuplewise-torch train --checkpoint ck.npz --resume
    tuplewise-torch train-triplet --steps 50
    tuplewise-torch learning --n-workers 128 --repartition-every 25
    tuplewise-torch replay --n-events 20000 --budget 64
    echo '{"op":"insert","score":1.2,"label":1}' | tuplewise-torch serve
    tuplewise-torch doctor --dir run/

Every subcommand runs on the card unless ``--device cpu`` (or another
torch device) is given; with no card and no ``--device`` it exits with
status 2 and says so, and never carries on on the CPU. ``--backend``
defaults to ``torch``. Each command prints JSON to stdout, its last line
the JSON the reference's command prints, and can append JSONL via
``--out``. ``serve`` is the online service loop (JSONL request/response
over stdin/stdout); ``replay`` is its benchmark twin
(``serving/replay.py``); ``doctor`` diagnoses a run's artifacts
(``obs/doctor.py``). The reference's ``check`` (the static analysis) has
no counterpart yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from tuplewise_tpu_torch.harness.variance import (
    VarianceConfig,
    run_variance_experiment,
    tradeoff_vs_pairs,
    tradeoff_vs_rounds,
    tradeoff_vs_workers,
    write_jsonl,
)
from tuplewise_tpu_torch.utils.device import resolve_device


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "without one, pass --device cpu to run the plain "
                        "versions on the CPU)")


def _add_robustness_flags(p: argparse.ArgumentParser) -> None:
    """The batch path's fault-tolerance flags, shared by every
    long-running subcommand: checkpoint cadence, explicit resume, and
    deterministic chaos injection."""
    p.add_argument("--checkpoint", type=str, default=None,
                   help="atomic progress checkpoint (.npz); written "
                        "every --checkpoint-every units of progress")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from an existing --checkpoint file "
                        "(bit-identical to the uninterrupted run); "
                        "without this flag a stale checkpoint is "
                        "removed and the run starts fresh")
    p.add_argument("--chaos-spec", type=str, default=None,
                   help="deterministic fault schedule (JSON inline, "
                        "@file, or *.json path) injected into the "
                        "batch-path hook points (train_step / mc_chunk "
                        "/ mesh_mc / checkpoint / estimator; action "
                        "'sigkill' at a checkpoint models preemption)")


def _chaos_from(args):
    spec = getattr(args, "chaos_spec", None)
    if not spec:
        return None
    from tuplewise_tpu_torch.testing.chaos import FaultInjector

    return FaultInjector.from_spec(spec)


def _add_batch_obs_flags(p: argparse.ArgumentParser) -> None:
    """Observability flags of the batch subcommands: span tracing of
    chunks and checkpoints, and live metric snapshots."""
    p.add_argument("--trace-out", type=str, default=None,
                   help="export the span trace (train.chunk / "
                        "train.checkpoint / heal spans) here: *.jsonl "
                        "= span JSONL, else Chrome trace JSON")
    p.add_argument("--metrics-out", type=str, default=None,
                   help="append periodic registry snapshots (live "
                        "train_step/train_loss_last gauges + recovery "
                        "counters) as JSONL here while training")
    p.add_argument("--metrics-every", type=float, default=1.0,
                   help="seconds between --metrics-out snapshots")


def _batch_obs_from(args):
    """(tracer, registry, flusher) for a batch subcommand, all None when
    the flags are absent. ``_finish_batch_obs`` stops the flusher and
    exports the tracer."""
    tracer = registry = flusher = None
    if getattr(args, "trace_out", None):
        from tuplewise_tpu_torch.obs.tracing import Tracer

        tracer = Tracer()
    if getattr(args, "metrics_out", None):
        from tuplewise_tpu_torch.obs import MetricsFlusher
        from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

        registry = MetricsRegistry()
        flusher = MetricsFlusher(
            registry, args.metrics_out, every_s=args.metrics_every,
            meta={"stage": args.cmd}).start()
    return tracer, registry, flusher


def _finish_batch_obs(args, tracer, flusher) -> None:
    if flusher is not None:
        flusher.stop()
    if tracer is not None:
        if args.trace_out.endswith(".jsonl"):
            tracer.export_jsonl(args.trace_out)
        else:
            tracer.export_chrome(args.trace_out)


def _add_budget_flags(p: argparse.ArgumentParser) -> None:
    """The per-step budget and recording flags shared by the learning and
    train subcommands."""
    p.add_argument("--pairs-per-worker", type=int, default=None)
    p.add_argument("--pair-design", default="swr",
                   choices=["swr", "swor", "bernoulli"],
                   help="per-step pair-budget design (ops.device_design)")
    p.add_argument("--loss-every", type=int, default=1,
                   help="record the surrogate loss every k steps; "
                        "0 = loss-free (grad-only kernel off step 0)")


def _add_variance_args(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(VarianceConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type is int or f.type == "int":
            p.add_argument(flag, type=int, default=f.default)
        elif f.type is float or f.type == "float":
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=str, default=f.default)


def _cfg_from_args(args) -> VarianceConfig:
    names = {f.name for f in dataclasses.fields(VarianceConfig)}
    return VarianceConfig(
        **{k: v for k, v in vars(args).items() if k in names}
    )


def _emit(results, out):
    if isinstance(results, dict):
        results = [results]
    for r in results:
        print(json.dumps(r))
    if out:
        write_jsonl(results, out)


def _serve_stdin(cfg, chaos=None, obs=None, tenancy=None) -> int:
    """The ``serve`` loop: one JSONL request per stdin line, one JSONL
    response per stdout line (same order); the exit summary and the
    final metrics to stderr.

    ``obs``: the argparse namespace of the observability flags: span
    tracing (``--trace-out``), live metrics export (``--metrics-out`` /
    ``--metrics-every``), SLOs (``--slo-spec``), the control plane
    (``--controller-spec``), the sampling profiler (``--prof`` /
    ``--prof-out``), a ``torch.profiler`` trace (``--profile-dir``) and
    the flight-recorder dump (``--flight-out``).

    ``tenancy``: a ``TenancyConfig`` switches the loop onto the
    multi-tenant fleet engine: requests carry a ``"tenant"`` field
    (default tenant ``"default"``), admission rejections come back
    typed, and the exit summary gains the fleet block.
    """
    from tuplewise_tpu_torch.obs import service_report
    from tuplewise_tpu_torch.obs.tracing import Tracer
    from tuplewise_tpu_torch.serving import (
        BackpressureError, DeadlineExceededError, EngineClosedError,
        MicroBatchEngine, MultiTenantEngine, PoisonEventError,
        TenantRejectedError, TenantThrottledError,
    )
    from tuplewise_tpu_torch.serving.replay import _slo_flusher
    from tuplewise_tpu_torch.utils.profiling import trace

    tracer = Tracer() if obs is not None and obs.trace_out else None
    slo_monitor = controller = flusher = None
    if tenancy is not None:
        engine_cm = MultiTenantEngine(cfg, tenancy, chaos=chaos,
                                      tracer=tracer)
    else:
        engine_cm = MicroBatchEngine(cfg, chaos=chaos, tracer=tracer)
    with engine_cm as eng:
        if obs is not None:
            # live SLO evaluation on the metrics flusher (observer-only
            # without --metrics-out), the controller on its signals
            slo_monitor, controller, flusher = _slo_flusher(
                eng, cfg, obs.slo_spec, obs.controller_spec,
                obs.metrics_out, obs.metrics_every, "serve")
        profiler = None
        if obs is not None and (getattr(obs, "prof", False)
                                or getattr(obs, "prof_out", None)):
            # the host-tax sampling profiler: off unless asked for
            from tuplewise_tpu_torch.obs.prof import SamplingProfiler

            profiler = SamplingProfiler(metrics=eng.metrics).start()
        with trace(obs.profile_dir if obs is not None else None):
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    op = req["op"]
                    if tenancy is not None:
                        tid = str(req.get("tenant", "default"))
                        if op == "insert":
                            fut = eng.insert(tid, req["score"],
                                             req["label"])
                            resp = {"ok": True, "tenant": tid,
                                    "inserted": int(fut.result(30.0))}
                        elif op == "score":
                            ranks = eng.score(
                                tid, req["score"]).result(30.0)
                            resp = {"ok": True, "tenant": tid,
                                    "rank": [None if np.isnan(r)
                                             else float(r)
                                             for r in np.atleast_1d(
                                                 ranks)]}
                        elif op == "query":
                            snap = eng.query(tid).result(30.0)
                            resp = {"ok": True, "tenant": tid,
                                    "auc_exact": snap.get("auc_exact"),
                                    "estimate_incomplete":
                                        snap.get("estimate_incomplete"),
                                    "state": snap}
                        elif op == "tenants":
                            resp = {"ok": True,
                                    "tenants": eng.fleet.tenants(),
                                    "fleet": eng.fleet.state()}
                        else:
                            resp = {"ok": False,
                                    "error": f"unknown op {op!r}"}
                    elif op == "insert":
                        fut = eng.insert(req["score"], req["label"])
                        resp = {"ok": True,
                                "inserted": int(fut.result(30.0))}
                    elif op == "score":
                        fut = eng.score(req["score"])
                        ranks = fut.result(30.0)
                        resp = {"ok": True,
                                "rank": [None if np.isnan(r) else float(r)
                                         for r in np.atleast_1d(ranks)]}
                    elif op == "query":
                        snap = eng.query().result(30.0)
                        resp = {"ok": True,
                                "auc_exact": snap.get("auc_exact"),
                                "estimate_incomplete":
                                    snap["estimate_incomplete"],
                                "state": snap.get("index")}
                    else:
                        resp = {"ok": False, "error": f"unknown op {op!r}"}
                except TenantThrottledError as e:
                    # a control-plane shed: typed, with the retry hint in
                    # the wire protocol, so a client can back off
                    resp = {"ok": False, "tenant": e.tenant,
                            "retry_after_s": e.retry_after_s,
                            "error": f"tenant_throttled: {e}"}
                except TenantRejectedError as e:
                    resp = {"ok": False, "tenant": e.tenant,
                            "error": f"tenant_rejected: {e}"}
                except PoisonEventError as e:
                    resp = {"ok": False, "error": f"poison: {e}"}
                except BackpressureError as e:
                    resp = {"ok": False, "error": f"backpressure: {e}"}
                except DeadlineExceededError as e:
                    resp = {"ok": False, "error": f"deadline: {e}"}
                except EngineClosedError as e:
                    resp = {"ok": False, "error": f"closed: {e}"}
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    resp = {"ok": False, "error": f"bad request: {e}"}
                print(json.dumps(resp), flush=True)
        if profiler is not None:
            profiler.stop()
        if flusher is not None:
            flusher.stop()
        stats = eng.stats()
        flight = eng.flight
    # dump after close, so the file carries engine_closed and the final
    # snapshot's lifecycle events
    if obs is not None and obs.flight_out:
        flight.dump_to(obs.flight_out)
    m = stats["metrics"]
    if tracer is not None:
        if obs.trace_out.endswith(".jsonl"):
            tracer.export_jsonl(obs.trace_out)
        else:
            tracer.export_chrome(obs.trace_out)

    # the exit summary: load shedding, pauses and recovery first, built
    # by the same report builder replay records use
    summary = service_report(m, chaos=chaos, flight=flight,
                             slo=slo_monitor)
    if controller is not None:
        summary["controller"] = controller.state()
    if profiler is not None:
        from tuplewise_tpu_torch.obs.prof import export_profile

        summary["prof_out"] = export_profile(
            profiler, getattr(obs, "prof_out", None))
        summary["prof_samples"] = profiler.samples
        summary["prof_overhead_fraction"] = profiler.overhead_fraction()
    print(json.dumps({"exit_summary": summary}), file=sys.stderr)
    print(json.dumps({"final_stats": m}), file=sys.stderr)
    return 0


def _add_serving_flags(p: argparse.ArgumentParser) -> None:
    """ServingConfig knobs shared by serve and replay."""
    p.add_argument("--kernel", default="auc")
    p.add_argument("--budget", type=int, default=64,
                   help="incomplete-U pairs per arrival")
    p.add_argument("--reservoir", type=int, default=4096)
    p.add_argument("--design", default="swr", choices=["swr", "swor"])
    p.add_argument("--window", type=int, default=None,
                   help="sliding window (arrivals); default unbounded")
    p.add_argument("--compact-every", type=int, default=512)
    p.add_argument("--engine", default="torch", choices=["torch", "numpy"],
                   help="exact-index count/compaction engine")
    p.add_argument("--mesh-shards", type=int, default=None,
                   help="shard the exact index's base runs over a mesh of "
                        "N workers (the card's worker axis); default one "
                        "device")
    p.add_argument("--bg-compact", action="store_true",
                   help="compact the exact index on a side thread "
                        "(double-buffered base run; no sort pause on the "
                        "request path)")
    p.add_argument("--delta-fraction", type=float, default=0.25,
                   help="sharded index delta compaction: minor "
                        "compactions ship O(buffer) delta runs and an "
                        "on-mesh major merge folds them into the base once "
                        "their mass exceeds this fraction of it; 0 "
                        "restores the full host merge and re-placement")
    p.add_argument("--max-delta-runs", type=int, default=64,
                   help="fold the delta run into the base after this many "
                        "minor compactions merged into it, regardless of "
                        "its size (a safety bound; --delta-fraction "
                        "normally rules)")
    p.add_argument("--count-kernel", action="store_true",
                   help="run the count hot loop as one launch of the "
                        "count kernel per micro-batch (csrc/"
                        "signed_count.cu; the fleet's csrc/"
                        "tenant_count.cu); the same integer counts. On "
                        "the CPU the plain comparison count runs")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--flush-timeout-ms", type=float, default=2.0)
    p.add_argument("--queue-size", type=int, default=1024)
    p.add_argument("--policy", default="reject",
                   choices=["reject", "drop_oldest", "block"])
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="fail requests older than this at dispatch "
                        "(typed DeadlineExceededError)")
    p.add_argument("--chaos-spec", type=str, default=None,
                   help="deterministic fault schedule (JSON inline, "
                        "@file, or *.json path) injected into the serving "
                        "stack's hook points (testing.chaos.FaultInjector)")
    p.add_argument("--snapshot-dir", type=str, default=None,
                   help="crash-safe recovery directory: periodic atomic "
                        "index snapshots + an event-tail WAL")
    p.add_argument("--snapshot-every", type=int, default=4096,
                   help="events between snapshots")
    p.add_argument("--recover", action="store_true",
                   help="restore --snapshot-dir state (snapshot + WAL "
                        "tail) before serving")
    p.add_argument("--wal-fsync", default="snapshot",
                   choices=["snapshot", "batch"],
                   help="WAL durability: 'snapshot' (default) flushes per "
                        "batch and fsyncs only at snapshots (survives "
                        "SIGKILL; power loss can drop the tail), 'batch' "
                        "fsyncs every append")
    p.add_argument("--trace-out", type=str, default=None,
                   help="export the span trace here: *.jsonl = span "
                        "JSONL, anything else = Chrome trace-event JSON")
    p.add_argument("--metrics-out", type=str, default=None,
                   help="append periodic whole-registry metric snapshots "
                        "(JSONL) here while serving")
    p.add_argument("--metrics-every", type=float, default=1.0,
                   help="seconds between --metrics-out snapshots")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="bracket the run in a torch.profiler trace "
                        "written here")
    p.add_argument("--flight-recorder-size", type=int, default=4096,
                   help="lifecycle-event ring capacity (the dump lands "
                        "next to --snapshot-dir snapshots and/or at "
                        "--flight-out)")
    p.add_argument("--flight-out", type=str, default=None,
                   help="dump the flight recorder (JSONL) here on exit")
    p.add_argument("--tail-exemplar-ms", type=float, default=None,
                   help="an insert whose measured latency reaches this "
                        "threshold captures its host-tax ledger and trace "
                        "id as a tail_exemplar flight event; default: "
                        "never")
    p.add_argument("--prof", action="store_true",
                   help="host-tax sampling profiler: periodic folded "
                        "Python stacks of every thread, overhead guarded "
                        "at 5%%; off without this flag")
    p.add_argument("--prof-out", type=str, default=None,
                   help="write the profile here (implies --prof): "
                        "*.collapsed/*.txt = folded stacks, anything else "
                        "= speedscope JSON")
    p.add_argument("--slo-spec", type=str, default=None,
                   help="declarative SLO objectives (JSON inline, @file, "
                        "or *.json; the obs.slo spec schema) evaluated "
                        "live against the metrics snapshots; breaches "
                        "emit slo_breach flight events and slo_* gauges, "
                        "verdicts land in the exit summary or the replay "
                        "record. Label wildcards "
                        "(insert_latency_s{tenant=*}) judge each tenant "
                        "of a fleet separately")
    p.add_argument("--controller-spec", type=str, default=None,
                   help="the control plane: a serving.control."
                        "ControllerConfig spec (JSON inline, @file, "
                        "*.json, or '{}' for defaults); a FleetController "
                        "rides the --slo-spec monitor's signals: typed "
                        "per-tenant throttling before a breach, flush "
                        "window and micro-batch widening, DRR weight "
                        "rebalance, mesh grow/shrink, slope-based whale "
                        "promotion, each actuation hysteretic, rate-"
                        "limited, budgeted, reversible and flight-evented "
                        "with its triggering signal. Requires --slo-spec")
    p.add_argument("--tenants", type=int, default=1,
                   help="replay: synthetic tenants in the generated "
                        "stream (> 1 routes through the MultiTenantEngine "
                        "fleet path); serve: ignored, pass --max-tenants")
    p.add_argument("--tenant-skew", type=float, default=1.0,
                   help="replay: Zipf exponent of the tenant assignment "
                        "(0 = uniform; 1 = classic heavy tail)")
    p.add_argument("--max-tenants", type=int, default=None,
                   help="serve: run the multi-tenant fleet engine with "
                        'this tenant cap; requests carry a "tenant" '
                        "field. replay: fleet tenant cap (default 1024)")
    p.add_argument("--tenant-quota", type=int, default=64,
                   help="fleet: max queued requests per tenant "
                        "(TenantRejectedError past it)")
    p.add_argument("--tenant-weight", type=int, default=8,
                   help="fleet: requests per tenant per fair-scheduling "
                        "round (deficit round-robin quantum)")
    p.add_argument("--idle-evict-s", type=float, default=None,
                   help="fleet: drop tenants idle longer than this "
                        "(default: never)")
    p.add_argument("--whale-threshold", type=int, default=None,
                   help="fleet: promote a tenant to its own ExactAucIndex "
                        "once its live event count reaches this (demotes "
                        "on shrink; bit-identical either way). Default: "
                        "never promote")
    p.add_argument("--tenant-metric-cap", type=int, default=None,
                   help="fleet: at most this many tenants get their own "
                        "labeled metric series; later tenants collapse "
                        "into one {tenant=__other__} series. Default: "
                        "unbounded")
    p.add_argument("--seed", type=int, default=0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tuplewise-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name in ("variance", "tradeoff-rounds", "tradeoff-pairs",
                 "tradeoff-workers"):
        p = sub.add_parser(name)
        _add_variance_args(p)
        p.add_argument("--out", type=str, default=None)
        if name == "variance":
            _add_robustness_flags(p)
            p.add_argument("--trace-dir", type=str, default=None,
                           help="write a torch.profiler trace here")
        if name == "tradeoff-rounds":
            p.add_argument("--rounds", type=int, nargs="+",
                           default=[1, 2, 4, 8, 16])
        if name == "tradeoff-pairs":
            p.add_argument("--pairs", type=int, nargs="+",
                           default=[100, 1000, 10_000, 100_000])
        if name == "tradeoff-workers":
            p.add_argument("--workers", type=int, nargs="+",
                           default=[2, 8, 32, 128])

    p = sub.add_parser("triplet")
    p.add_argument("--kernel", default="triplet_indicator")
    p.add_argument("--backend", default="torch")
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--n-pairs", type=int, default=20_000,
                   help="sampled triplets a class (the incomplete "
                        "statistic); 0 = the complete statistic (the "
                        "triplet kernel on the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    _add_robustness_flags(p)

    p = sub.add_parser(
        "learning",
        help="one learning-trade-off cell: simulated-N distributed SGD "
             "with Monte-Carlo seeds and held-out AUC curves",
    )
    p.add_argument("--dataset", choices=["gaussians", "adult"],
                   default="gaussians")
    p.add_argument("--kernel", default="hinge")
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--n-workers", type=int, default=32)
    p.add_argument("--repartition-every", type=int, default=10,
                   help="0 = never repartition")
    _add_budget_flags(p)
    p.add_argument("--n-seeds", type=int, default=8)
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--n", type=int, default=1024,
                   help="gaussians: train rows per class; adult: total")
    p.add_argument("--n-test", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)

    p = sub.add_parser("train")
    p.add_argument("--dataset", choices=["gaussians", "adult"],
                   default="adult")
    p.add_argument("--kernel", default="hinge")
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--n-workers", type=int, default=1)
    p.add_argument("--repartition-every", type=int, default=10,
                   help="0 = never repartition")
    _add_budget_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=8000)
    p.add_argument("--out", type=str, default=None)
    _add_robustness_flags(p)
    _add_batch_obs_flags(p)

    p = sub.add_parser(
        "train-triplet",
        help="degree-3 metric-learning SGD on synthetic Gaussian classes "
             "(models.triplet_sgd) with checkpoint/resume and chaos",
    )
    p.add_argument("--n", type=int, default=512,
                   help="rows per class (anchors/positives vs negatives)")
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--n-workers", type=int, default=1)
    p.add_argument("--repartition-every", type=int, default=10)
    p.add_argument("--triplets-per-worker", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    _add_robustness_flags(p)
    _add_batch_obs_flags(p)

    p = sub.add_parser(
        "serve",
        help="online service loop: JSONL requests on stdin "
             '({"op":"insert","score":s,"label":l} | {"op":"score",'
             '"score":s} | {"op":"query"}), JSONL responses on stdout',
    )
    _add_serving_flags(p)

    p = sub.add_parser(
        "doctor",
        help="post-hoc diagnosis of a run's observability artifacts "
             "(metrics.jsonl + flight.jsonl + span export): SLO and "
             "health verdicts, fault and actuation attribution, top "
             "self-time spans; the last stdout line is one machine-"
             "readable verdict JSON (exit 0 = healthy/recovered, 2 = "
             "degraded)",
    )
    p.add_argument("--dir", type=str, default=None,
                   help="artifact directory (e.g. a --snapshot-dir after "
                        "SIGKILL): default filenames are probed for "
                        "anything not given explicitly")
    p.add_argument("--metrics", type=str, default=None,
                   help="metrics.jsonl (MetricsFlusher output)")
    p.add_argument("--flight", type=str, default=None,
                   help="flight-recorder dump (flight.jsonl)")
    p.add_argument("--spans", type=str, default=None,
                   help="span export (*.jsonl span JSONL or Chrome trace "
                        "JSON)")
    p.add_argument("--slo-spec", type=str, default=None,
                   help="SLO spec to re-evaluate over the metrics history "
                        "(default: the conservative built-in doctor spec: "
                        "no heal exhaustion, an availability budget)")
    p.add_argument("--top-spans", type=int, default=10)
    p.add_argument("--out", type=str, default=None,
                   help="also write the full report JSON here")
    p.add_argument("--quiet", action="store_true",
                   help="print only the one-line machine verdict")

    p = sub.add_parser(
        "replay",
        help="replay a synthetic Gaussian stream through the micro-batch "
             "engine; report events/s + latency percentiles",
    )
    _add_serving_flags(p)
    p.add_argument("--n-events", type=int, default=20_000)
    p.add_argument("--pos-frac", type=float, default=0.5)
    p.add_argument("--separation", type=float, default=1.0)
    p.add_argument("--chunk", type=int, default=1,
                   help="events per insert request (1 = per-event)")
    p.add_argument("--score-every", type=int, default=0)
    p.add_argument("--query-every", type=int, default=0)
    p.add_argument("--out", type=str, default=None)

    for p in sub.choices.values():
        _add_device_flag(p)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print(f"tuplewise-torch {args.cmd}: no CUDA device is available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    if args.cmd == "doctor":
        from tuplewise_tpu_torch.obs.doctor import main as doctor_main

        return doctor_main(args)

    if args.cmd in ("serve", "replay"):
        from tuplewise_tpu_torch.serving import ServingConfig

        cfg = ServingConfig(
            kernel=args.kernel, budget=args.budget,
            reservoir=args.reservoir, design=args.design,
            window=args.window, compact_every=args.compact_every,
            engine=args.engine, device=str(device),
            mesh_shards=args.mesh_shards,
            bg_compact=args.bg_compact,
            delta_fraction=args.delta_fraction,
            max_delta_runs=args.max_delta_runs,
            count_kernel=args.count_kernel,
            max_batch=args.max_batch,
            flush_timeout_s=args.flush_timeout_ms / 1e3,
            queue_size=args.queue_size, policy=args.policy,
            deadline_s=(args.deadline_ms / 1e3
                        if args.deadline_ms is not None else None),
            snapshot_dir=args.snapshot_dir,
            snapshot_every=args.snapshot_every, recover=args.recover,
            wal_fsync=args.wal_fsync,
            flight_recorder_size=args.flight_recorder_size,
            tail_exemplar_ms=args.tail_exemplar_ms,
            seed=args.seed,
        )
        chaos = _chaos_from(args)
        tenancy = None
        if (args.max_tenants
                or (args.cmd == "replay" and args.tenants > 1)):
            from tuplewise_tpu_torch.serving import TenancyConfig

            tenancy = TenancyConfig(
                max_tenants=args.max_tenants or 1024,
                tenant_quota=args.tenant_quota,
                weight=args.tenant_weight,
                idle_evict_s=args.idle_evict_s,
                whale_threshold=args.whale_threshold,
                tenant_metric_cap=args.tenant_metric_cap)
        if args.cmd == "replay":
            if args.tenants > 1:
                # fleet load: a Zipf tenant assignment through the
                # MultiTenantEngine
                from tuplewise_tpu_torch.serving import (
                    make_tenant_stream, replay_fleet,
                )

                scores, labels, tenants = make_tenant_stream(
                    args.n_events, args.tenants, skew=args.tenant_skew,
                    pos_frac=args.pos_frac,
                    separation=args.separation, seed=args.seed)
                _emit(
                    replay_fleet(scores, labels, tenants, config=cfg,
                                 tenancy=tenancy, chunk=args.chunk,
                                 chaos=chaos,
                                 metrics_out=args.metrics_out,
                                 metrics_every_s=args.metrics_every,
                                 flight_out=args.flight_out,
                                 slo_spec=args.slo_spec,
                                 controller_spec=args.controller_spec),
                    args.out,
                )
                return 0
            from tuplewise_tpu_torch.serving import make_stream, replay

            scores, labels = make_stream(
                args.n_events, pos_frac=args.pos_frac,
                separation=args.separation, seed=args.seed)
            _emit(
                replay(scores, labels, config=cfg, chunk=args.chunk,
                       score_every=args.score_every,
                       query_every=args.query_every, chaos=chaos,
                       trace_out=args.trace_out,
                       metrics_out=args.metrics_out,
                       metrics_every_s=args.metrics_every,
                       profile_dir=args.profile_dir,
                       flight_out=args.flight_out,
                       slo_spec=args.slo_spec,
                       controller_spec=args.controller_spec,
                       prof=args.prof or None,
                       prof_out=args.prof_out),
                args.out,
            )
            return 0
        return _serve_stdin(cfg, chaos=chaos, obs=args, tenancy=tenancy)

    if args.cmd == "variance":
        from tuplewise_tpu_torch.utils.checkpoint import prepare_resume

        prepare_resume(args.checkpoint, args.resume)
        _emit(
            run_variance_experiment(
                _cfg_from_args(args),
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                trace_dir=args.trace_dir,
                chaos=_chaos_from(args),
                device=device,
            ),
            args.out,
        )
    elif args.cmd == "tradeoff-rounds":
        _emit(tradeoff_vs_rounds(_cfg_from_args(args), args.rounds,
                                 device=device), args.out)
    elif args.cmd == "tradeoff-pairs":
        _emit(tradeoff_vs_pairs(_cfg_from_args(args), args.pairs,
                                device=device), args.out)
    elif args.cmd == "tradeoff-workers":
        _emit(tradeoff_vs_workers(_cfg_from_args(args), args.workers,
                                  device=device), args.out)
    elif args.cmd == "triplet":
        from tuplewise_tpu_torch.harness.triplet_experiment import (
            triplet_mnist_statistic,
        )
        from tuplewise_tpu_torch.utils.checkpoint import prepare_resume

        prepare_resume(args.checkpoint, args.resume)
        _emit(
            triplet_mnist_statistic(
                kernel=args.kernel, backend=args.backend, n=args.n,
                n_pairs=args.n_pairs or None, seed=args.seed,
                checkpoint_path=args.checkpoint,
                chaos=_chaos_from(args), device=device,
            ),
            args.out,
        )
    elif args.cmd == "learning":
        from tuplewise_tpu_torch.data import (
            load_adult_splits, make_gaussian_splits,
        )
        from tuplewise_tpu_torch.models.pairwise_sgd import (
            TrainConfig, split_by_label,
        )
        from tuplewise_tpu_torch.models.scorers import LinearScorer
        from tuplewise_tpu_torch.models.sim_learner import (
            NEVER, curve_record, train_curves,
        )

        if args.dataset == "adult":
            X, y, Xte, yte, meta = load_adult_splits(
                n=args.n, seed=args.seed
            )
            Xp, Xn = split_by_label(X, y)
            Xp_te, Xn_te = split_by_label(Xte, yte)
        else:
            Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(
                args.n, args.n_test, dim=10, separation=0.8,
                seed=args.seed,
            )
            meta = {"synthetic": True, "source": "gaussians"}
        scorer = LinearScorer(dim=Xp.shape[1])
        cfg = TrainConfig(
            kernel=args.kernel, lr=args.lr, steps=args.steps,
            n_workers=args.n_workers,
            repartition_every=args.repartition_every or NEVER,
            pairs_per_worker=args.pairs_per_worker,
            pair_design=args.pair_design,
            loss_every=args.loss_every or NEVER, seed=args.seed,
        )
        out = train_curves(
            scorer, scorer.init(args.seed), Xp, Xn, Xp_te, Xn_te, cfg,
            n_seeds=args.n_seeds, eval_every=args.eval_every,
            device=device,
        )
        _emit(
            dict(
                curve_record(cfg, out, args.n_seeds),
                config=dataclasses.asdict(cfg),
                dataset=args.dataset,
                data_meta=meta,
            ),
            args.out,
        )
    elif args.cmd == "train":
        from tuplewise_tpu_torch.data import (
            load_adult_splits, make_gaussian_splits,
        )
        from tuplewise_tpu_torch.models.pairwise_sgd import (
            TrainConfig, evaluate_auc, split_by_label, train_pairwise,
        )
        from tuplewise_tpu_torch.models.scorers import LinearScorer
        from tuplewise_tpu_torch.models.sim_learner import (
            NEVER, last_recorded_loss,
        )
        from tuplewise_tpu_torch.utils.checkpoint import (
            params_digest, prepare_resume,
        )

        if args.dataset == "adult":
            X, y, Xte, yte, meta = load_adult_splits(
                n=args.n, seed=args.seed
            )
            Xp, Xn = split_by_label(X, y)
            Xp_te, Xn_te = split_by_label(Xte, yte)
        else:
            Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(
                args.n // 2, max(args.n // 8, 64), dim=5,
                separation=1.0, seed=args.seed,
            )
            meta = {"synthetic": True, "source": "gaussians",
                    "split": "fresh_draw"}
        scorer = LinearScorer(dim=Xp.shape[1])
        p0 = scorer.init(args.seed)
        cfg = TrainConfig(
            kernel=args.kernel, lr=args.lr, steps=args.steps,
            n_workers=args.n_workers,
            repartition_every=args.repartition_every or NEVER,
            pairs_per_worker=args.pairs_per_worker,
            pair_design=args.pair_design,
            loss_every=args.loss_every or NEVER, seed=args.seed,
        )
        prepare_resume(args.checkpoint, args.resume)
        tracer, registry, flusher = _batch_obs_from(args)
        params, hist = train_pairwise(
            scorer, p0, Xp, Xn, cfg,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            chaos=_chaos_from(args),
            tracer=tracer, metrics=registry, device=device,
        )
        _finish_batch_obs(args, tracer, flusher)

        def auc(p, A, B):
            return evaluate_auc(scorer, p, A, B, device=device)

        _emit(
            {
                "config": dataclasses.asdict(cfg),
                "dataset": args.dataset,
                "data_meta": meta,
                "auc_train_before": auc(p0, Xp, Xn),
                "auc_train": auc(params, Xp, Xn),
                "auc_test_before": auc(p0, Xp_te, Xn_te),
                "auc_test": auc(params, Xp_te, Xn_te),
                # the last RECORDED loss (None: never recorded past step
                # 0, or diverged; never a NaN literal, and never an
                # earlier finite value masking divergence)
                "loss_first": float(hist["loss"][0]),
                "loss_last": last_recorded_loss(
                    hist["loss"], cfg.loss_every
                ),
                # the bit-identity witness of resume and preemption
                # parity across processes
                "params_sha256": params_digest(params),
                "recovery": hist.get("recovery"),
            },
            args.out,
        )
    elif args.cmd == "train-triplet":
        from tuplewise_tpu_torch.data import make_gaussians
        from tuplewise_tpu_torch.models.triplet_sgd import (
            TripletTrainConfig, evaluate_triplet_accuracy, init_embed,
            train_triplet,
        )
        from tuplewise_tpu_torch.utils.checkpoint import (
            params_digest, prepare_resume,
        )

        Xc, Xo = make_gaussians(args.n, args.n, dim=args.dim,
                                separation=1.0, seed=args.seed)
        cfg = TripletTrainConfig(
            embed_dim=args.embed_dim, lr=args.lr, steps=args.steps,
            n_workers=args.n_workers,
            repartition_every=args.repartition_every,
            triplets_per_worker=args.triplets_per_worker,
            seed=args.seed,
        )
        prepare_resume(args.checkpoint, args.resume)
        tracer, registry, flusher = _batch_obs_from(args)
        params, hist = train_triplet(
            init_embed(args.dim, args.embed_dim, args.seed), Xc, Xo,
            cfg, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            chaos=_chaos_from(args),
            tracer=tracer, metrics=registry, device=device,
        )
        _finish_batch_obs(args, tracer, flusher)
        _emit(
            {
                "config": dataclasses.asdict(cfg),
                "dataset": "gaussians",
                "loss_first": float(hist["loss"][0]),
                "loss_last": float(hist["loss"][-1]),
                "triplet_acc": evaluate_triplet_accuracy(
                    params, Xc, Xo, n_triplets=4096, seed=args.seed,
                    device=device),
                "params_sha256": params_digest(params),
                "recovery": hist.get("recovery"),
            },
            args.out,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
