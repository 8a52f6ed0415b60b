#!/usr/bin/env python
"""Multi-tenant fleet smoke of the port (the counterpart of the JAX
package's ``scripts/multitenant_smoke.py``): T = 32 tenants over S = 2
workers of the card's worker axis, driven end to end through the
``MultiTenantEngine``.

Asserts the properties the fleet exists for:

1. **Independence parity**: every tenant's wins2 and AUC from the fleet
   index equal a dedicated single-tenant ``ExactAucIndex`` fed the same
   events, bit for bit (T = 32, S = 2, coalesced multi-tenant batches).
2. **One count per coalesced batch**: ``fleet_count_calls`` is at most
   the number of micro-batches, not events or tenants.
3. **Per-tenant SLO verdict**: a label-wildcard objective
   (``insert_latency_s{tenant=*}``) evaluated live yields a healthy
   verdict with one series per tenant.
4. **Admission control**: a quota-busting flood is shed typed
   (``TenantRejectedError``) without touching other tenants' results.
5. **Whale promotion and dirty-row placement**: one tenant at ~20x the
   median crosses ``whale_threshold`` and promotes to its own index,
   parity holds through the promotion, and the pack re-places ship less
   than half the full ``[S, T_bucket, cap]`` block.

With ``--count-kernel`` the parity leg runs again through kernel 7 over
the worker axis (``csrc/tenant_count.cu``; the plain comparison count on
the CPU), bit for bit, with at least one kernel call.

Appends the row to ``<results>/multitenant_smoke.jsonl``.

Usage: python scripts_torch/multitenant_smoke.py [--count-kernel]
           [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR, default
``results/torch/``.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device,
)
from tuplewise_tpu_torch.serving import (  # noqa: E402
    ExactAucIndex, MultiTenantEngine, ServingConfig, TenancyConfig,
    TenantFleetIndex, TenantRejectedError, make_tenant_stream,
    replay_fleet,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

T = 32
SHARDS = 2
N_EVENTS = 4000
# the whale leg: T_SMALL tenants of PER_ROUND events a round beside one
# tenant at 20x that, for ROUNDS rounds
WHALE_T_SMALL, WHALE_PER_ROUND, WHALE_ROUNDS = 15, 4, 20
DEVICE = None   # set by main()


def fleet_vs_independent(count_kernel=False):
    """Direct index parity: the fleet against T dedicated indexes. With
    ``count_kernel`` the fleet counts run through kernel 7 over the worker
    axis."""
    scores, labels, tenants = make_tenant_stream(
        N_EVENTS, T, skew=1.0, seed=7)
    fleet = TenantFleetIndex(window=256, compact_every=64, device=DEVICE,
                             shards=SHARDS, count_kernel=count_kernel)
    singles = {}
    # coalesced multi-tenant batches: chunk the stream, group by tenant
    chunk = 97
    for i in range(0, N_EVENTS, chunk):
        sl = slice(i, min(i + chunk, N_EVENTS))
        items = []
        for tid in np.unique(tenants[sl]):
            m = tenants[sl] == tid
            items.append((str(tid), scores[sl][m], labels[sl][m]))
            if tid not in singles:
                singles[tid] = ExactAucIndex(window=256, compact_every=64,
                                             device=DEVICE)
        fleet.apply_inserts(items)
        for tid, s, l in items:
            singles[tid].insert_batch(s, l)
    mismatches = []
    for tid, idx in singles.items():
        if fleet.wins2(str(tid)) != idx._wins2 \
                or fleet.auc(str(tid)) != idx.auc():
            mismatches.append(str(tid))
        idx.close()
    assert not mismatches, f"fleet/independent mismatch: {mismatches}"
    out = {"tenants": len(singles),
           "count_calls": fleet.state()["count_calls"],
           "parity": "bit-identical"}
    if count_kernel:
        # no fallback counter: a CUDA tensor launches the kernel or raises
        calls = fleet.metrics.snapshot()["count_kernel_calls_total"][
            "value"]
        assert calls >= 1, "count kernel never dispatched"
        out["kernel_calls"] = int(calls)
    fleet.close()
    return out


def engine_leg():
    """Engine-level run with live per-tenant SLO and the one-call
    witness."""
    scores, labels, tenants = make_tenant_stream(
        N_EVENTS, T, skew=1.0, seed=11)
    slo = {"objectives": [
        {"name": "tenant_insert_p99", "type": "latency",
         "metric": "insert_latency_s{tenant=*}",
         "quantile": "p99", "threshold_ms": 10_000},
        {"name": "no_tenant_rejects", "type": "counter_max",
         "metric": "tenant_rejected_total", "max": 0},
    ]}
    rec = replay_fleet(
        scores, labels, tenants,
        config=ServingConfig(window=512, compact_every=128,
                             max_batch=256, policy="block",
                             flush_timeout_s=0.001,
                             mesh_shards=SHARDS, device=str(DEVICE)),
        tenancy=TenancyConfig(max_tenants=64, tenant_quota=4096),
        chunk=2, max_inflight=128, slo_spec=slo)
    assert rec["events_applied"] == N_EVENTS, rec["events_applied"]
    err = rec["tenant_auc_max_abs_err"]
    assert err < 1e-6, f"per-tenant oracle parity broke: {err}"
    calls, batches = rec["fleet_count_calls"], rec["batches"]
    assert 0 < calls <= batches, (calls, batches)
    assert rec["slo"]["healthy"], rec["slo"]
    series = rec["slo"]["objectives"]["tenant_insert_p99"]["last"][
        "series"]
    assert len(series) == T, (len(series), T)
    return {
        "events_per_s": round(rec["events_per_s"], 1),
        "insert_p99_ms": rec["insert_latency_p99_ms"],
        "tenant_insert_p99_max_ms": rec["tenant_insert_p99_max_ms"],
        "fleet_count_calls": calls,
        "batches": batches,
        "tenant_auc_max_abs_err": err,
        "slo_healthy": rec["slo"]["healthy"],
        "slo_series": len(series),
        "tenancy_report": rec["report"].get("tenancy"),
    }


def admission_leg():
    """Quota shedding is typed and tenant-attributed."""
    rejected = None
    with MultiTenantEngine(
            ServingConfig(max_batch=16, flush_timeout_s=0.5,
                          device=str(DEVICE)),
            TenancyConfig(max_tenants=4, tenant_quota=2)) as eng:
        futs = []
        try:
            for i in range(64):
                futs.append(eng.insert("flood", float(i), i % 2))
        except TenantRejectedError as e:
            rejected = e.tenant
        ok = eng.insert("calm", 1.0, 1)
        assert ok.result(10.0) == 1
        for f in futs:
            f.result(10.0)
    assert rejected == "flood", rejected
    return {"rejected_tenant": rejected}


def whale_leg():
    """One tenant at ~20x the median: promotion fires, the fleet stays
    bit-identical to independents through it, and the dirty-row path
    ships less than half the full pack per re-place."""
    rng = np.random.default_rng(21)
    whale_per_round = WHALE_PER_ROUND * 20      # 20x the median tenant
    fleet = TenantFleetIndex(compact_every=64, shards=SHARDS,
                             whale_threshold=400, device=DEVICE)
    singles = {}

    def batch(tid, k):
        labels = rng.random(k) < 0.5
        scores = rng.standard_normal(k) + 0.8 * labels
        if tid not in singles:
            singles[tid] = ExactAucIndex(compact_every=64, device=DEVICE)
        singles[tid].insert_batch(scores, labels)
        return (tid, scores, labels)

    for _ in range(WHALE_ROUNDS):
        items = [batch("whale", whale_per_round)]
        items += [batch(f"s{k}", WHALE_PER_ROUND)
                  for k in range(WHALE_T_SMALL)]
        fleet.apply_inserts(items)
    m = fleet.metrics.snapshot()
    promotions = m["fleet_whale_promotions"]["value"]
    assert promotions >= 1, "whale never promoted"
    assert fleet.is_whale("whale")
    mismatches = [t for t in singles
                  if fleet.wins2(t) != singles[t]._wins2
                  or fleet.auc(t) != singles[t].auc()]
    assert not mismatches, f"parity broke through promotion: " \
                           f"{mismatches}"
    for idx in singles.values():
        idx.close()
    # geometry-stable re-places ship only dirty rows, so partial re-places
    # dominate and every one of them credits saved bytes
    replaces = m["pack_replaces_total"]["value"]
    full = m["pack_full_replaces_total"]["value"]
    saved = m["bytes_h2d_saved"]["value"]
    assert replaces - full > 0, (replaces, full)
    assert saved > 0, "dirty-row placement saved nothing"
    shipped = m["bytes_h2d"]["value"]
    frac = shipped / (shipped + saved)
    assert frac < 0.5, f"re-places shipped {frac:.0%} of full cost"
    fleet.close()
    return {"promotions": int(promotions),
            "tenants": len(singles),
            "pack_replaces": int(replaces),
            "pack_partial_replaces": int(replaces - full),
            "bytes_h2d": int(shipped), "bytes_h2d_saved": int(saved),
            "shipped_fraction_of_full": round(frac, 4),
            "parity": "bit-identical"}


def main(argv=None, *, results: str | None = None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count-kernel", action="store_true",
                    help="add the fused counts leg: re-run the fleet-vs-"
                         "independents parity with count_kernel=True and "
                         "assert bit-identical wins2/AUC")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    DEVICE = driver_device(ap, args.device)
    out = os.path.join(results or RESULTS, "multitenant_smoke.jsonl")

    rec = {"stage": "multitenant_smoke", "tenants": T,
           "mesh_shards": SHARDS, "n_events": N_EVENTS,
           "card": card_of(DEVICE)}
    try:
        rec["independent_parity"] = fleet_vs_independent()
        print(f"[multitenant_smoke] index parity OK "
              f"({rec['independent_parity']})", file=sys.stderr)
        if args.count_kernel:
            rec["count_kernel"] = fleet_vs_independent(count_kernel=True)
            print(f"[multitenant_smoke] count-kernel leg OK "
                  f"({rec['count_kernel']})", file=sys.stderr)
        rec["engine"] = engine_leg()
        print(f"[multitenant_smoke] engine leg OK ({rec['engine']})",
              file=sys.stderr)
        rec["admission"] = admission_leg()
        print(f"[multitenant_smoke] admission OK ({rec['admission']})",
              file=sys.stderr)
        rec["whale"] = whale_leg()
        print(f"[multitenant_smoke] whale leg OK ({rec['whale']})",
              file=sys.stderr)
    except AssertionError as e:
        print(f"MULTITENANT SMOKE FAIL: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
