"""Preemption smoke of the port (the counterpart of the JAX package's
``scripts/preemption_smoke.py``).

The batch path's acceptance cycle, end to end through the port's CLI
(``python -m tuplewise_tpu_torch.harness.cli``), each run a child
process on the device:

1. run a short pairwise-SGD job uninterrupted and record its params
   digest;
2. rerun it with a chaos schedule that SIGKILLs the process right after
   its 2nd checkpoint lands (the process dies mid-run, uncatchably);
3. rerun with ``--resume`` and assert the final params digest, test AUC
   and last loss equal the uninterrupted run's bit for bit;
4. the same cycle for the mesh Monte-Carlo sweep (``variance --backend
   mesh``), asserting mean and variance equal bit for bit.

Appends the row (stage "preemption_smoke") to
``<results>/preemption_smoke.jsonl``; the checkpoints live in a temporary
directory under ``<results>`` that is removed at the end. Exits nonzero
on a missed kill, a missing checkpoint or any parity breach.

Usage: python scripts_torch/preemption_smoke.py [--out PATH]
           [--device cpu]
(``--device``: the torch device of this process and of the children,
default the card; without a card and without it, exit 2.
``main(argv, results=DIR)`` writes into DIR, default ``results/torch/``.)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

_KILL_SPEC = json.dumps({"faults": [
    {"point": "checkpoint", "on_call": 2, "action": "sigkill"}]})
CHILD_TIMEOUT_S = 300
# (name, CLI arguments, checkpoint file, fields equal bit for bit)
CYCLES = (
    ("pairwise_sgd",
     ["train", "--dataset", "gaussians", "--n", "256", "--steps", "8",
      "--n-workers", "2"],
     "sgd.npz", ("params_sha256", "auc_test", "loss_last")),
    ("mesh_mc",
     ["variance", "--backend", "mesh", "--scheme", "local",
      "--n-pos", "128", "--n-neg", "128", "--n-workers", "2",
      "--n-reps", "6", "--seed", "3"],
     "mc.npz", ("mean", "variance")),
)


class PreemptionFailure(RuntimeError):
    pass


def _cli(args, device, expect_kill=False):
    p = subprocess.run(
        [sys.executable, "-m", "tuplewise_tpu_torch.harness.cli"] + args
        + ["--device", str(device)],
        capture_output=True, text=True, env=dict(os.environ), cwd=REPO,
        timeout=CHILD_TIMEOUT_S)
    if expect_kill:
        if p.returncode != -signal.SIGKILL:
            raise PreemptionFailure(
                f"expected SIGKILL death, got rc={p.returncode}:\n"
                f"{p.stderr[-2000:]}")
        return None
    if p.returncode != 0:
        raise PreemptionFailure(
            f"{args[0]} returned {p.returncode}:\n{p.stderr[-2000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def _cycle(name, args, ck, fields, device):
    """straight -> killed -> resumed; returns the parity record."""
    ref = _cli(list(args), device)
    _cli(args + ["--checkpoint", ck, "--checkpoint-every", "2",
                 "--chaos-spec", _KILL_SPEC], device, expect_kill=True)
    if not os.path.exists(ck):
        raise PreemptionFailure(f"{name}: no checkpoint survived the kill")
    res = _cli(args + ["--checkpoint", ck, "--checkpoint-every", "2",
                       "--resume"], device)
    rec = {"resumed_from": res["recovery"]["resumed_from"]}
    if not rec["resumed_from"] > 0:
        raise PreemptionFailure(f"{name}: resume started from 0")
    for f in fields:
        if res[f] != ref[f]:
            raise PreemptionFailure(
                f"{name}: {f} diverged after SIGKILL+resume: "
                f"{res[f]!r} != {ref[f]!r}")
        rec[f] = res[f]
    print(f"[preemption_smoke] {name}: bit-identical after "
          f"SIGKILL@step{rec['resumed_from']} + --resume",
          file=sys.stderr)
    return rec


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="the row's file (default <results>/"
                         "preemption_smoke.jsonl)")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    results = results or RESULTS
    out = args.out or os.path.join(results, "preemption_smoke.jsonl")
    os.makedirs(results, exist_ok=True)

    row = {"stage": "preemption_smoke", "ok": True,
           "card": card_of(device)}
    try:
        with tempfile.TemporaryDirectory(dir=results) as tmp:
            for name, cli_args, ck, fields in CYCLES:
                row[name] = _cycle(name, list(cli_args),
                                   os.path.join(tmp, ck), fields, device)
    except PreemptionFailure as e:
        print(f"PREEMPTION SMOKE FAIL: {e}", file=sys.stderr)
        return 1

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a", encoding="utf-8") as f:
        f.write(json.dumps(row) + "\n")
    print(f"[preemption_smoke] OK -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
