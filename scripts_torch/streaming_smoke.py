"""Streaming-latency smoke of the port (the counterpart of the JAX
package's ``scripts/streaming_smoke.py``).

A fast end-to-end check of the serving path on the card: replay a small
stream through the micro-batch engine with background compaction on,
assert the latency-percentile fields are present and the exact estimate
matches the batch oracle, and write the row (stage "ci_smoke") to
``<results>/serving_smoke.jsonl``.

With ``--mesh-shards`` the smoke exercises the SHARDED index's delta
compaction instead, on the card's worker axis (``parallel.mesh``): the
same stream replays in delta mode and in the host-merge mode, and the
run fails unless (1) both modes' exact AUC is bit-identical (and a
directly-driven delta index matches the single-device index's wins2
exactly), and (2) the delta mode shipped strictly fewer host->device
bytes per minor compaction. With ``--count-kernel`` a third index rides
the same stream through kernel 6 over the worker axis
(``csrc/signed_count.cu``; the plain comparison count on the CPU) and
must match wins2 at every step with at least one kernel call. That row
goes to ``<results>/serving_smoke_sharded.jsonl``.

Usage: python scripts_torch/streaming_smoke.py [--n-events 4000]
           [--mesh-shards 2] [--delta-fraction 0.25] [--count-kernel]
           [--out PATH] [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR, default
``results/torch/``.) Exits nonzero on any missing field, parity breach or
byte regression.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ExactAucIndex, ServingConfig, make_stream, replay,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

REQUIRED_FIELDS = (
    "events_per_s",
    "insert_latency_p50_ms",
    "insert_latency_p95_ms",
    "insert_latency_p99_ms",
    "compaction_pause_p99_ms",
    "compactions",
    "auc_abs_err",
)
# the sharded leg's floor on the stream: below ~6k events the host
# path's re-placed block is still only a bucket or two, and the per-minor
# byte margin needs the base to dwarf a delta chunk
SHARDED_MIN_EVENTS = 6_000
# events per insert_batch of the directly-driven indexes
DIRECT_CHUNK = 173


def _check_common(rec) -> int:
    failures = [f for f in REQUIRED_FIELDS if rec.get(f) is None]
    if failures:
        print(f"SMOKE FAIL: missing/None fields {failures}",
              file=sys.stderr)
        return 1
    if rec["compactions"] < 1:
        print("SMOKE FAIL: stream never crossed a compaction",
              file=sys.stderr)
        return 1
    # exact-index parity vs the batch oracle
    if rec["auc_abs_err"] > 1e-6:
        print(f"SMOKE FAIL: auc_abs_err={rec['auc_abs_err']}",
              file=sys.stderr)
        return 1
    return 0


def _write(rec, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(json.dumps(rec) + "\n")


def _sharded_delta_leg(args, device, out) -> int:
    """Delta-compaction smoke on an S-worker mesh of the device."""
    n_events = max(args.n_events, SHARDED_MIN_EVENTS)
    scores, labels = make_stream(n_events, pos_frac=0.5,
                                 separation=1.0, seed=0)
    recs = {}
    for mode, frac in (("delta", args.delta_fraction),
                       ("host_merge", 0.0)):
        cfg = ServingConfig(policy="block", flush_timeout_s=0.002,
                            compact_every=256, bg_compact=True,
                            mesh_shards=args.mesh_shards,
                            delta_fraction=frac,
                            max_delta_runs=args.max_delta_runs,
                            device=str(device))
        recs[mode] = replay(scores, labels, config=cfg,
                            max_inflight=256)
        recs[mode]["stage"] = f"ci_smoke_sharded_{mode}"
        rc = _check_common(recs[mode])
        if rc:
            return rc
    delta, host = recs["delta"], recs["host_merge"]
    # the two compaction engines agree to the bit on the exact statistic
    if delta["auc_exact"] != host["auc_exact"]:
        print(f"SMOKE FAIL: delta vs host-merge AUC mismatch "
              f"{delta['auc_exact']} != {host['auc_exact']}",
              file=sys.stderr)
        return 1
    # a directly-driven delta index matches the single-device index's
    # integer win count exactly (windowed: tombstones, deltas and a major
    # merge all run); with --count-kernel a third index rides the same
    # stream through kernel 6 over the worker axis, bit for bit at every
    # step
    sc32 = scores.astype(np.float32)
    w = max(256, n_events // 3)
    sharded = ExactAucIndex(compact_every=128, window=w, device=device,
                            shards=args.mesh_shards,
                            delta_fraction=args.delta_fraction,
                            max_delta_runs=args.max_delta_runs)
    single = ExactAucIndex(compact_every=128, window=w, device=device)
    kernel = None
    if args.count_kernel:
        kernel = ExactAucIndex(compact_every=128, window=w, device=device,
                               shards=args.mesh_shards,
                               delta_fraction=args.delta_fraction,
                               max_delta_runs=args.max_delta_runs,
                               count_kernel=True)
    for i in range(0, len(sc32), DIRECT_CHUNK):
        j = min(i + DIRECT_CHUNK, len(sc32))
        sharded.insert_batch(sc32[i:j], labels[i:j])
        single.insert_batch(sc32[i:j], labels[i:j])
        if sharded._wins2 != single._wins2:
            print(f"SMOKE FAIL: wins2 diverged at event {j}",
                  file=sys.stderr)
            return 1
        if kernel is not None:
            kernel.insert_batch(sc32[i:j], labels[i:j])
            if kernel._wins2 != single._wins2:
                print(f"SMOKE FAIL: count-kernel wins2 diverged at "
                      f"event {j}", file=sys.stderr)
                return 1
    for idx in (sharded, single):
        idx.close()
    if kernel is not None:
        # the port has no fallback counter: a CUDA tensor launches the
        # kernel or raises, so the calls alone say the kernel ran
        calls = kernel.metrics.snapshot()["count_kernel_calls_total"][
            "value"]
        kernel.close()
        if calls < 1:
            print(f"SMOKE FAIL: count kernel calls={calls} (expected an "
                  f"active kernel)", file=sys.stderr)
            return 1
        delta["count_kernel"] = {"calls": int(calls),
                                 "parity": "bit-identical"}
        print(f"count-kernel leg OK: {calls} fused dispatches, wins2 "
              f"bit-identical", file=sys.stderr)
    # the byte saving the tier exists for
    if not delta["bytes_h2d"]:
        print("SMOKE FAIL: delta mode recorded zero bytes_h2d",
              file=sys.stderr)
        return 1
    if not (delta["bytes_per_compaction"]
            and host["bytes_per_compaction"]
            and delta["bytes_per_compaction"]
            < host["bytes_per_compaction"]):
        print(f"SMOKE FAIL: no byte saving per minor compaction "
              f"(delta {delta['bytes_per_compaction']} vs host "
              f"{host['bytes_per_compaction']})", file=sys.stderr)
        return 1
    delta["card"] = card_of(device)
    _write(delta, out)
    print(
        f"sharded delta smoke OK (S={args.mesh_shards}): "
        f"{delta['bytes_per_compaction']:.0f} B/minor vs host "
        f"{host['bytes_per_compaction']:.0f} B "
        f"({host['bytes_per_compaction'] / delta['bytes_per_compaction']:.0f}x), "
        f"major_merges={delta['major_merges']}, "
        f"auc_abs_err={delta['auc_abs_err']:.1e} -> {out}",
        file=sys.stderr,
    )
    return 0


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-events", type=int, default=4_000)
    ap.add_argument("--mesh-shards", type=int, default=None,
                    help="run the sharded delta-compaction leg on an "
                         "N-worker mesh instead of the plain smoke")
    ap.add_argument("--delta-fraction", type=float, default=0.25)
    ap.add_argument("--max-delta-runs", type=int, default=64)
    ap.add_argument("--count-kernel", action="store_true",
                    help="also drive the fused count kernel and assert "
                         "bit-identical wins2 (sharded leg) or AUC (plain "
                         "leg) against the searchsorted route")
    ap.add_argument("--out", type=str, default=None,
                    help="the row's file (default <results>/"
                         "serving_smoke.jsonl, with --mesh-shards "
                         "serving_smoke_sharded.jsonl)")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    results = results or RESULTS
    out = args.out or os.path.join(
        results, "serving_smoke_sharded.jsonl" if args.mesh_shards
        else "serving_smoke.jsonl")

    if args.mesh_shards:
        return _sharded_delta_leg(args, device, out)

    scores, labels = make_stream(args.n_events, pos_frac=0.5,
                                 separation=1.0, seed=0)
    cfg = ServingConfig(policy="block", flush_timeout_s=0.002,
                        compact_every=256, bg_compact=True,
                        device=str(device))
    rec = replay(scores, labels, config=cfg, max_inflight=256)
    rec["stage"] = "ci_smoke"

    rc = _check_common(rec)
    if rc:
        return rc
    if args.count_kernel:
        # the same stream through the engine with the fused count path on:
        # the exact statistic is bit-identical (integer counts)
        krec = replay(scores, labels,
                      config=dataclasses.replace(cfg, count_kernel=True),
                      max_inflight=256)
        if krec["auc_exact"] != rec["auc_exact"]:
            print(f"SMOKE FAIL: count-kernel AUC mismatch "
                  f"{krec['auc_exact']} != {rec['auc_exact']}",
                  file=sys.stderr)
            return 1
        rec["count_kernel"] = {"parity": "bit-identical"}
        print("count-kernel leg OK: engine AUC bit-identical",
              file=sys.stderr)
    rec["card"] = card_of(device)
    _write(rec, out)
    print(
        f"streaming smoke OK: {rec['events_per_s']:.0f} ev/s, insert "
        f"p99={rec['insert_latency_p99_ms']:.2f}ms, "
        f"{rec['compactions']} compactions, "
        f"auc_abs_err={rec['auc_abs_err']:.1e} -> {out}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
