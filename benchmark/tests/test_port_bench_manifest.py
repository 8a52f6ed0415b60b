"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to the files the harness finds it by."""

import importlib
import json
import pathlib
import re

import pytest

from benchmark import manifest, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(map(_line, MAN["command"]))
    seconds = MAN["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_names_only_files_under_paths():
    for word in MAN["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / word).is_file()


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for x in MAN["configs"] + MAN["workloads"] + METRICS:
        assert NAME.match(x["name"]), x["name"]
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(m):
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    assert m["moves"] in e2e
    assert "workloads" in m
    moved = e2e[m["moves"]].get("workloads", CELLS)
    assert set(m["workloads"]) <= set(moved)


@pytest.mark.parametrize("layer", sorted({m["layer"]
                                          for m in MAN["per_layer"]}))
def test_layer_names_match_perf_md_list_of_layers(layer):
    perf = (ROOT / "PERF.md").read_text()
    section = perf.split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    assert f"| {layer} |" in section


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert _line(c["source"]) and _line(c["why"])
    assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["name"] == c["name"] and data["source"] == c["source"]
    assert sorted(data["reduced"]) == sorted(c["reduced"])
    assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
    # a width is never cut
    assert not any(k.endswith(("_dim", "_rank")) or k == "dim"
                   for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    files = [x["file"] for x in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = manifest.cell(MAN, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    config = manifest.config(MAN, w["config"])
    traffic = manifest.traffic(w["traffic"])
    limits = manifest.limits(cell)["limits"]
    assert limits and all(isinstance(v, (int, float)) and v >= 0
                          for v in limits.values())
    job = importlib.import_module(f"benchmark.jobs.{config['entry']}")
    assert hasattr(job, "Job") and job.VARIANTS
    assert traffic
    pairs = [(x["config"], x["traffic"]) for x in MAN["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in manifest.metrics_of(MAN, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(MAN, cell, "per_layer")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(manifest.reader(m["name"]))


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_name_table_compiles_and_names_every_layer_a_reader_reads():
    for cell in CELLS:
        table = trace.load_name_table(cell)
        assert {"draw", "rotation", "pair_kernels", "grad_kernels"} <= {
            key for key, _ in table}
