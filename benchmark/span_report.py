#!/usr/bin/env python3
"""Runs one cell once as ``run.py --trace 1`` does and reads the
program's spans in its window (``spans.py``); prints run.py's result
with a ``spans`` key added as the last line of standard output.

    python3 benchmark/span_report.py --workload <cell> --seed <n> \
        --seconds <s>

``spans`` holds the reduction (``spans.reduce``), the window's counts of
the port's ``obs.tracing.COUNTS``, the span metrics of the cell's unit
(``readings``), the share of the window's device time that program spans
launched (``coverage_pct``) and the reduction's seconds, also printed as
``[spans] reduced in X s`` on standard error. run.py runs as it is: this
script reads the profiler run.py stops, just before run.py reduces it,
and takes the counts from the window's first call on.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def readings(reading: dict, counts: dict, unit: str, units: int) -> dict:
    """The span metrics of a unit of work (ms or counts a rep or a step),
    those the window has something to read for."""
    if not units:
        return {}
    spans, busy = reading["spans"], reading["device_us"] > 0

    def device_ms(name):
        us = spans.get(name, {}).get("device_us")
        return us / 1e3 / units if us else None

    def idle_ms(*prefixes):
        if not busy:
            return None
        return sum(us for name, us in reading["idle_us"].items()
                   if name.startswith(prefixes)) / 1e3 / units

    if unit == "reps":
        reads = counts.get("host_read[mc.read]")
        out = {"mc_draw_ms_per_rep.mc": device_ms("mc.draw"),
               "host_reads_per_rep.mc": reads / units if reads else None,
               "runner_idle_ms_per_rep.mc": idle_ms("mc."),
               "mesh_idle_ms_per_rep.mc": idle_ms("mesh.", "ring."),
               "mesh_partition_ms_per_rep.mc": device_ms("mesh.partition"),
               "mesh_regather_ms_per_rep.mc": device_ms("mesh.regather")}
    else:
        step = spans.get("train.step")
        out = {"train_place_ms_per_step.train": device_ms("train.place"),
               "train_step_host_ms.train":
                   step["host_us"] / 1e3 / units if step else None}
    return {k: v for k, v in out.items() if v is not None}


def report(workload: str, seed: int, seconds: float, **kw) -> dict:
    """run.py's result of one traced run of the cell, with the ``spans``
    key; ``kw`` goes to ``run.run_cell`` (the CPU tests' device and
    sizes)."""
    from benchmark import manifest, run, spans, trace

    run.T_START = T_START
    run.import_port()
    from tuplewise_tpu_torch.obs.tracing import COUNTS

    man = manifest.load()
    config = manifest.config(man, manifest.cell(man, workload)["config"])
    job = importlib.import_module(f"benchmark.jobs.{config['entry']}").Job
    state = {"units": 0}
    step, split = job.step, trace.split_events

    def counted_step(self):
        state.setdefault("before", dict(COUNTS))
        n = step(self)
        state["units"] += n
        return n

    def split_and_read(prof):
        # run.py splits its trace once, after the window's calls: any
        # other order would read the wrong window or the wrong counts
        if not state["units"] or "reading" in state:
            raise RuntimeError("run.py split its trace before the window's "
                               "calls or more than once: span_report no "
                               "longer reads the window")
        t0 = time.perf_counter()
        before = state["before"]
        state["counts"] = {k: v - before.get(k, 0) for k, v in COUNTS.items()
                           if v - before.get(k, 0)}
        state["reading"] = spans.reduce(*spans.split_events(prof))
        state["reduce_s"] = time.perf_counter() - t0
        print(f"[spans] reduced in {state['reduce_s']:.1f} s",
              file=sys.stderr)
        return split(prof)

    job.step, trace.split_events = counted_step, split_and_read
    try:
        result = run.run_cell(workload, seed, seconds, True, **kw)
    finally:
        job.step, trace.split_events = step, split
    reading = state["reading"]
    dev = reading["device_us"]
    result["spans"] = {
        "readings": readings(reading, state["counts"], job.unit,
                             state["units"]),
        "coverage_pct": (100.0 * (1.0 - reading["unspanned_device_us"] / dev)
                         if dev else None),
        "units": state["units"], "counts": state["counts"],
        "reduce_s": state["reduce_s"], "reduction": reading}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    print(json.dumps(report(args.workload, args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
