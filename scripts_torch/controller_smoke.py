#!/usr/bin/env python
"""SLO-driven control-plane smoke of the port (the counterpart of the JAX
package's ``scripts/controller_smoke.py``): a Zipf flash crowd at T = 32
over S = 2 workers of the card's worker axis, served twice from the same
schedule:

* **controlled**: a ``FleetController`` rides the live SLO monitor (the
  ``MetricsFlusher`` observer wiring of ``serve --controller-spec``). It
  must throttle the flooding tenant typed (``TenantThrottledError`` with
  a retry hint) before the breach, so the run ends with the SLO verdict
  **healthy**, zero hard rejects for in-quota tenants, and per-tenant
  wins2 bit-identical to independent single-tenant indexes over the
  admitted events;
* **uncontrolled twin**: the same schedule with no controller must
  **breach** (queue saturation and/or hard rejects), proving the scenario
  needs defending.

Then the port's doctor (``obs.doctor.diagnose``) runs over the controlled
run's artifacts (metrics.jsonl and flight.jsonl) and must attribute 100 %
of the actuations to the signal that caused them, with a non-degraded
verdict.

Appends the row to ``<results>/controller_smoke.jsonl``; the controlled
run's artifacts live in a temporary directory under ``<results>`` that is
removed at the end.

Usage: python scripts_torch/controller_smoke.py [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR, default
``results/torch/``.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device,
)
from tuplewise_tpu_torch.obs.doctor import diagnose  # noqa: E402
from tuplewise_tpu_torch.obs.metrics_export import (  # noqa: E402
    MetricsFlusher,
)
from tuplewise_tpu_torch.obs.slo import SloMonitor  # noqa: E402
from tuplewise_tpu_torch.serving import (  # noqa: E402
    BackpressureError, ExactAucIndex, FleetController,
    MultiTenantEngine, ServingConfig, TenancyConfig,
    TenantThrottledError,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

T = 32
SHARDS = 2
QUEUE = 128
BURST = 256
ROUNDS = 4
# the wedge: one polite insert of WEDGE events that occupies the batcher
# while t0 floods
WEDGE = 100_000
DEVICE = None   # set by main()

SLO_SPEC = {"objectives": [
    {"name": "queue_sat", "type": "saturation",
     "metric": "queue_depth_live", "capacity": "queue_size",
     "max_fraction": 0.8},
    {"name": "no_hard_rejects", "type": "counter_max",
     "metric": "rejected_total", "max": 0},
]}

# throttle_s is deliberately long: a submitting thread can stall for
# seconds mid-burst on a loaded host, and a short throttle that expired
# inside such a stall would let the flood through between two
# checkpoints; the calm release clears throttles as soon as pressure
# subsides. The budgets are sized for the run: with the 20 ms cooldown a
# sustained-pressure run spends ~50 shed steps/s, and a budget exhausted
# mid-scenario would let the tail of the flood through.
CTL_SPEC = {"knobs": ["shed", "flush"], "cooldown_s": 0.02,
            "up_ticks": 1, "down_ticks": 8, "throttle_s": 5.0,
            "shed_budget": 2048, "flush_budget": 64}


def run(controlled, artifact_dir=None):
    rng = np.random.default_rng(31)
    cfg = ServingConfig(queue_size=QUEUE, policy="reject",
                        flush_timeout_s=0.001, max_batch=32,
                        mesh_shards=SHARDS, device=str(DEVICE))
    admitted = {}
    metrics_path = (os.path.join(artifact_dir, "metrics.jsonl")
                    if artifact_dir else None)
    with MultiTenantEngine(cfg, TenancyConfig(
            max_tenants=T + 8, tenant_quota=8192)) as eng:
        mon = SloMonitor(SLO_SPEC, registry=eng.metrics,
                         flight=eng.flight,
                         context=dataclasses.asdict(cfg))
        if controlled:
            FleetController(eng, CTL_SPEC).attach(mon)
        flusher = MetricsFlusher(
            eng.metrics, metrics_path, every_s=0.02,
            meta={"stage": "controller_smoke"}, config=cfg,
            observers=[mon.observe_row]).start()
        shed = rejected = 0
        for _ in range(ROUNDS):
            # steady state: every tenant a small resolved batch
            futs = []
            for k in range(1, T):
                s = rng.standard_normal(8)
                l = rng.random(8) < 0.5
                futs.append((f"t{k}", s, l,
                             eng.insert(f"t{k}", s, l)))
                if len(futs) >= 32:
                    for tid, s_, l_, f in futs:
                        f.result(30.0)
                        admitted.setdefault(tid, []).append((s_, l_))
                    futs = []
            for tid, s_, l_, f in futs:
                f.result(30.0)
                admitted.setdefault(tid, []).append((s_, l_))
            # the wedge: one big polite insert occupies the batcher
            ws = rng.standard_normal(WEDGE)
            wl = rng.random(WEDGE) < 0.5
            wedge = eng.insert(f"t{T - 1}", ws, wl)
            admitted.setdefault(f"t{T - 1}", []).append((ws, wl))
            # the flash crowd: t0 floods while the batcher is busy. The
            # monitor is also pumped at burst checkpoints, so the control
            # decision does not hinge on a 20 ms timer landing inside the
            # warn window
            for i in range(BURST):
                s = rng.standard_normal(1)
                l = rng.random(1) < 0.5
                try:
                    eng.insert("t0", s, l)
                    admitted.setdefault("t0", []).append((s, l))
                except TenantThrottledError:
                    shed += 1
                except BackpressureError:
                    rejected += 1
                if (i + 1) % 20 == 0:
                    mon.observe(eng.metrics.snapshot(),
                                time.perf_counter())
                    time.sleep(0.005)
            wedge.result(120.0)
            eng.flush(timeout=120.0)
            time.sleep(0.1)
        flusher.stop()
        slo = mon.report()
        m = eng.metrics.snapshot()
        wins = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        flight = eng.flight
        acts = flight.events("actuation")
        if artifact_dir:
            flight.dump_to(os.path.join(artifact_dir, "flight.jsonl"))
    oracle = {}
    for tid, batches in admitted.items():
        idx = ExactAucIndex(device=DEVICE)
        idx.insert_batch(np.concatenate([s for s, _ in batches]),
                         np.concatenate([l for _, l in batches]))
        oracle[tid] = idx._wins2
        idx.close()
    return {
        "slo_healthy": slo["healthy"],
        "slo": slo,
        "shed": shed,
        "rejected": rejected,
        "rejected_total": m["rejected_total"]["value"],
        "tenant_rejected_total": m["tenant_rejected_total"]["value"],
        "tenant_throttled_total": m["tenant_throttled_total"]["value"],
        "actuations": len(acts),
        "actuation_signals_nonnull": sum(1 for a in acts
                                         if a.get("signal")),
        "parity": wins == oracle,
        "wins_mismatch": sorted(t for t in wins
                                if wins[t] != oracle.get(t))[:5],
    }


def check_controlled(c):
    """The controlled run's promises."""
    assert c["slo_healthy"], \
        f"controlled fleet breached its SLO: {c['slo']}"
    assert c["rejected_total"] == 0, \
        "controlled fleet hard-rejected in-quota traffic"
    assert c["tenant_rejected_total"] == 0
    assert c["tenant_throttled_total"] > 0, \
        "controller never shed: the scenario did not exercise it"
    assert c["actuations"] > 0
    assert c["actuation_signals_nonnull"] == c["actuations"], \
        "actuation without a triggering signal"
    assert c["parity"], \
        f"wins2 diverged from independents: {c['wins_mismatch']}"


def check_doctor(report, c):
    """The doctor attributes every actuation, and does not call the run
    degraded."""
    acts = report.get("actuations") or {}
    assert acts.get("total", 0) == c["actuations"], (acts, c["actuations"])
    assert acts["attributed"] == acts["total"], \
        f"doctor could not attribute every actuation: {acts}"
    assert not report["verdict"].startswith("degraded"), report["verdict"]


def check_uncontrolled(u):
    assert not u["slo_healthy"], \
        "uncontrolled twin did not breach: the scenario is vacuous"
    assert u["parity"], "parity must hold even while breaching"


def main(argv=None, *, results: str | None = None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    DEVICE = driver_device(ap, args.device)
    results = results or RESULTS
    out = os.path.join(results, "controller_smoke.jsonl")
    os.makedirs(results, exist_ok=True)

    rec = {"stage": "controller_smoke", "tenants": T,
           "mesh_shards": SHARDS, "queue_size": QUEUE, "burst": BURST,
           "card": card_of(DEVICE)}
    try:
        with tempfile.TemporaryDirectory(dir=results) as art:
            c = run(controlled=True, artifact_dir=art)
            rec["controlled"] = {k: v for k, v in c.items() if k != "slo"}
            print(f"[controller_smoke] controlled: healthy="
                  f"{c['slo_healthy']} throttled="
                  f"{c['tenant_throttled_total']} rejects="
                  f"{c['rejected_total']} actuations={c['actuations']}",
                  file=sys.stderr)
            check_controlled(c)
            # doctor attribution over the controlled run's artifacts
            report = diagnose(run_dir=art, slo_spec=SLO_SPEC,
                              context={"queue_size": QUEUE})
            acts = report.get("actuations") or {}
            rec["doctor"] = {"verdict": report["verdict"],
                             "actuations": acts.get("total", 0),
                             "attributed": acts.get("attributed", 0)}
            print(f"[controller_smoke] doctor: {rec['doctor']}",
                  file=sys.stderr)
            check_doctor(report, c)

        u = run(controlled=False)
        rec["uncontrolled"] = {k: v for k, v in u.items() if k != "slo"}
        print(f"[controller_smoke] uncontrolled twin: healthy="
              f"{u['slo_healthy']} rejects={u['rejected_total']}",
              file=sys.stderr)
        check_uncontrolled(u)
    except AssertionError as e:
        print(f"CONTROLLER SMOKE FAIL: {e}", file=sys.stderr)
        return 1

    with open(out, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
