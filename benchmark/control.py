#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... --seconds <s> [--out <file.jsonl>]

For each of ``--seeds`` it runs the cell as ``run.py`` does (set-up, a
window of ``--seconds``, the reference's check) and records each number
compared: the lower readings. For each of ``--control-seeds`` and each
variant of the cell's job (``VARIANTS``: the reference computed in the
next lower precision, and faults the cell can have) it puts that
variant in the program's place at the cell's own size and records the
same numbers: the upper readings. One JSON line a reading, on standard
output and appended to ``--out``. It needs the card, as ``run.py`` does;
the benchmark's own runs never run it.
"""

import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def readings(workload: str, seeds, control_seeds, seconds: float,
             device="cuda", overrides=None):
    """Yields one dict a reading: {"side", "seed", "numbers"}."""
    from benchmark import manifest, run

    man = manifest.load()
    cell = manifest.cell(man, workload)
    config = {**manifest.config(man, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    for seed in seeds:
        res = run.run_cell(workload, seed, seconds, False, device=device,
                           overrides=overrides)
        yield {"side": "program", "seed": seed, "correct": res["correct"],
               "numbers": {k: v["value"] for k, v in res["checks"].items()}}
    job = importlib.import_module(f"benchmark.jobs.{config['entry']}")
    for seed in control_seeds:
        for variant, gaps in job.controls(config, traffic, seed,
                                          device).items():
            yield {"side": variant, "seed": seed,
                   "numbers": {k: max(v) for k, v in gaps.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.seeds, args.control_seeds,
                      args.seconds):
        line = json.dumps({"workload": args.workload, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
