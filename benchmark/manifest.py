"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` its entry names (``configs/``);
* a traffic mix: ``workloads/<traffic>.json``;
* a cell's limits for ``correct``: ``limits/<cell>.json``;
* a metric, end to end or per layer: its reader ``metrics/<name>.py``,
  whose ``read(ctx)`` returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
