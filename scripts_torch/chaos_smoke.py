"""Chaos smoke of the port (the counterpart of the JAX package's
``scripts/chaos_smoke.py``).

Replays a seeded fault schedule (one shard death, one compactor crash,
one batcher crash and injected poison events) through
``serving.replay`` and asserts the two properties the fault-tolerance
layer promises:

1. the run COMPLETES (self-heal, watchdog restart, supervisor restart
   and edge rejection all did their jobs), with the recovery counters
   > 0 proving each path fired;
2. the final AUC is bit-identical to a fault-free run over the same
   admitted events: recovery repaired state, it did not corrupt it.

Unlike the reference, which drops the shard death where JAX sees fewer
than two devices, the port always runs it: its mesh is the card's worker
axis (``parallel.mesh``), so two workers always exist, and the run fails
unless ``reshard_events`` > 0.

Writes the row (stage "chaos_smoke") to ``<results>/chaos_smoke.jsonl``.

Usage: python scripts_torch/chaos_smoke.py [--n-events 3000] [--out PATH]
           [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR, default
``results/torch/``.) Exits nonzero on any missed counter or parity
breach.
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
    ServingConfig, make_stream, replay,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

SHARDS = 2
# on_call must be safely below the worst-case count: with full 256-event
# coalescing a 3000-event stream still issues ~20+ sharded count queries
# once the base is placed, so 12 fires however the batcher coalesces
FAULTS = [
    {"point": "compactor_build", "on_call": 1, "action": "error"},
    {"point": "batcher", "on_call": 5, "action": "error"},
    {"point": "poison", "at_events": [137, 1500, 1501], "value": "nan"},
    {"point": "sharded_count", "on_call": 12, "action": "error",
     "dropped": [1]},
]


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-events", type=int, default=3_000)
    ap.add_argument("--out", type=str, default=None,
                    help="the row's file (default <results>/"
                         "chaos_smoke.jsonl)")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    out = args.out or os.path.join(results or RESULTS, "chaos_smoke.jsonl")

    spec = {"faults": FAULTS}
    cfg = ServingConfig(policy="block", flush_timeout_s=0.002,
                        compact_every=128, bg_compact=True,
                        mesh_shards=SHARDS, device=str(device))
    scores, labels = make_stream(args.n_events, pos_frac=0.5,
                                 separation=1.0, seed=0)
    rec = replay(scores, labels, config=cfg, max_inflight=256, chaos=spec)
    rec["stage"] = "chaos_smoke"

    f = rec["faults"]
    missing = [k for k in ("bg_compactor_restarts", "batcher_restarts",
                           "poison_rejects", "reshard_events")
               if not f.get(k)]
    if missing:
        print(f"CHAOS SMOKE FAIL: recovery counters never fired: "
              f"{missing} (faults={f})", file=sys.stderr)
        return 1

    # parity: a fault-free run over the same admitted events gives the
    # bit-identical exact AUC (recovery must not corrupt wins2)
    admitted = np.ones(args.n_events, dtype=bool)
    admitted[rec["shed_events"]] = False
    ref = replay(scores[admitted], labels[admitted],
                 config=ServingConfig(policy="block", compact_every=128,
                                      bg_compact=True, device=str(device)),
                 max_inflight=256)
    if rec["auc_exact"] != ref["auc_exact"]:
        print(f"CHAOS SMOKE FAIL: auc under faults {rec['auc_exact']!r}"
              f" != fault-free {ref['auc_exact']!r}", file=sys.stderr)
        return 1
    rec["auc_fault_free"] = ref["auc_exact"]
    rec["card"] = card_of(device)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        fh.write(json.dumps(rec) + "\n")
    print(
        f"chaos smoke OK: shards={SHARDS} "
        f"reshard={f['reshard_events']} "
        f"bg_restarts={f['bg_compactor_restarts']} "
        f"batcher_restarts={f['batcher_restarts']} "
        f"poison={f['poison_rejects']} "
        f"auc bit-identical to fault-free -> {out}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
