#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once, on the card, and prints its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout that holds the port
(``tuplewise_tpu_torch``). Set-up (imports, the CUDA context, loading or
building the kernels, making the inputs from the seed, warming up) runs
from the process start to the first timed call; the window then calls
the cell's entry until ``--seconds`` have passed and the last call has
returned. With ``--trace 1`` a fresh ``torch.profiler`` scope covers the
window and the cell's per-layer metrics are read from it; with
``--trace 0`` its end-to-end metrics are read from the host clock. After
the window the program's state is freed and the plain reference checks
the answers (``correct``); each number compared is printed beside its
limit, last on standard error and last in the result.

Without a CUDA card, with fewer cards than the cell asks for, without
the port in the checkout, or with JAX or the JAX package loaded after
the window, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root, in place of this script's folder: the port and
    # the ``benchmark`` package import from it, and no file here shadows
    # a module
    sys.path[0] = str(ROOT)

PORT = "tuplewise_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "tuplewise_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_port():
    """The port, from this checkout and nowhere else."""
    port = importlib.import_module(PORT)
    path = pathlib.Path(port.__file__).resolve()
    if ROOT not in path.parents:
        raise RuntimeError(f"{PORT} was imported from {path}, not from the "
                           f"checkout at {ROOT}")
    return port


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def judge(gaps: dict, limits: dict, answers) -> dict:
    """The numbers compared, each the widest gap of its name beside its
    limit; ``correct`` only when every one is within its limit and every
    answer of the window is finite."""
    checks, failed = {}, 0
    for name, limit in limits.items():
        vals = gaps.get(name, [])
        worst = (float("nan") if not vals or any(map(math.isnan, vals))
                 else max(vals))
        checks[name] = {"value": worst, "limit": limit}
        failed += sum(not v <= limit for v in vals) + (not vals)
    nonfinite = sum(not math.isfinite(v) for v in answers)
    correct = failed == 0 and nonfinite == 0
    return {"correct": correct, "failed": failed + nonfinite,
            "checks": checks, "nonfinite": nonfinite}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides=None) -> dict:
    """One run of the cell: the result's dict (see the module docstring).
    ``device`` "cpu" and ``overrides`` of the configuration's sizes are
    for the CPU tests, which drive a run without the card."""
    import torch

    from benchmark import manifest, roofline
    from benchmark import trace as tr

    man = manifest.load()
    cell = manifest.cell(man, workload)
    config = {**manifest.config(man, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(workload)["limits"]
    import_port()
    from tuplewise_tpu_torch.ops import _build
    from tuplewise_tpu_torch.ops.pair_kernels import LAUNCHES

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    job_mod = importlib.import_module(f"benchmark.jobs.{config['entry']}")
    imports_s = time.perf_counter() - T_START
    job = job_mod.Job(config, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - T_START

    before = dict(LAUNCHES)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    calls, units = [], 0
    with torch.profiler.record_function(tr.WINDOW_SPAN):
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            with torch.profiler.record_function(tr.CALL_SPAN):
                units += job.step()
            now = time.perf_counter()
            calls.append(now - c0)
            if now - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    if prof is not None:
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        stop_s = time.perf_counter() - t_stop
    order = sorted(calls)
    print(f"[window] {units} {job.unit} in {window_s:.3f} s, {len(calls)} "
          f"calls: first {calls[0]:.4f} s, median {order[len(order) // 2]:.4f}"
          f" s, longest {order[-1]:.4f} s; set-up {setup_s:.3f} s, of it "
          f"imports {imports_s:.3f} s", file=sys.stderr)
    print(f"[window] kernels built in this process: "
          f"{dict(_build.BUILD_SECONDS)}",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                if v - before.get(k, 0)}

    ctx = {"unit": job.unit, "units": units, "window_s": window_s,
           "setup_s": setup_s, "launches": launches,
           "launch_shapes": job.launch_shapes(), "step_ops": job.step_ops(),
           "peak": roofline.peaks(kind), "trace": None}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        t_reduce = time.perf_counter()
        ctx["trace"] = tr.reduce(*tr.split_events(prof),
                                 tr.load_name_table(workload))
        prof = None
        device_info["busy_s"] = ctx["trace"]["busy_us"] * 1e-6
        device_info["window_s"] = ctx["trace"]["window_us"] * 1e-6
        breakdown = {
            "device_ops": [[n, us * 1e-6]
                           for n, us in ctx["trace"]["device_ops"]],
            "idle_gaps": [[n, us * 1e-6]
                          for n, us in ctx["trace"]["idle_gaps"]]}
        print(f"[trace] stopped in {stop_s:.1f} s, reduced in "
              f"{time.perf_counter() - t_reduce:.1f} s",
              file=sys.stderr)

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(man, workload, kind_key):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    answers = job.answers()
    job.finish()
    t_check = time.perf_counter()
    verdict = judge(job.check(), limits, answers)
    print(f"[check] reference in {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    del job
    result = {"correct": verdict["correct"], "attempted": len(answers),
              "failed": verdict["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    checks = {**verdict["checks"],
              "nonfinite_answers": {"value": verdict["nonfinite"],
                                    "limit": 0}}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import manifest

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"run.py: the cell {args.workload} needs {chips} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
