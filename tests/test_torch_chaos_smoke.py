"""scripts_torch/chaos_smoke.py against the JAX package's
scripts/chaos_smoke.py on the CPU.

The port runs the reference's fault schedule with the shard death always
in it (two workers of the CPU's worker axis). Its AUC under faults equals
the reference replay's fault-free AUC over the same admitted events, bit
for bit, and the heal fired. Without the shard death the port's smoke
fails: it never falls back to a single-host schedule.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from tuplewise_tpu.serving import ServingConfig as RefServingConfig
from tuplewise_tpu.serving.replay import replay as ref_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("scripts_torch/chaos_smoke.py", "port_chaos_smoke")


def test_auc_under_faults_equals_the_reference_fault_free(port, tmp_path):
    with contextlib.redirect_stderr(io.StringIO()):
        assert port.main(["--device", "cpu"], results=str(tmp_path)) == 0
    assert os.listdir(tmp_path) == ["chaos_smoke.jsonl"]
    with open(tmp_path / "chaos_smoke.jsonl") as f:
        (row,) = [json.loads(x) for x in f]
    f = row["faults"]
    assert f["reshard_events"] > 0
    assert f["bg_compactor_restarts"] and f["batcher_restarts"]
    # the three poison events are the shed ones
    assert f["poison_rejects"] == 3 and row["shed_events"] == [137, 1500,
                                                               1501]
    scores, labels = port.make_stream(3000, pos_frac=0.5, separation=1.0,
                                      seed=0)
    admitted = np.ones(3000, dtype=bool)
    admitted[row["shed_events"]] = False
    ref = ref_replay(scores[admitted], labels[admitted],
                     config=RefServingConfig(policy="block",
                                             compact_every=128,
                                             bg_compact=True),
                     max_inflight=256)
    assert row["auc_exact"] == row["auc_fault_free"] == ref["auc_exact"]
    assert row["stage"] == "chaos_smoke" and row["card"] is None


def test_the_schedule_is_the_reference_one_with_the_shard_death(
        port, tmp_path, monkeypatch):
    """The reference's schedule where it sees two devices (it does here:
    8 virtual CPU devices), read from the spec it hands to replay."""
    # the module (the package's attribute of that name is the function)
    ref_replay_mod = importlib.import_module("tuplewise_tpu.serving.replay")

    specs = []

    def capture(scores, labels, **kw):
        specs.append(kw["chaos"])
        return {"faults": {}}    # no counter fired: the reference exits

    monkeypatch.setattr(ref_replay_mod, "replay", capture)
    ref = _load("scripts/chaos_smoke.py", "ref_chaos_smoke")
    with contextlib.redirect_stderr(io.StringIO()):
        assert ref.main(["--out", str(tmp_path / "ref.jsonl")]) == 1
    (spec,) = specs
    assert port.FAULTS == spec["faults"]
    assert port.FAULTS[-1]["point"] == "sharded_count"


def test_without_the_shard_death_the_smoke_fails(port, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(port, "FAULTS", port.FAULTS[:-1])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--n-events", "1600", "--device", "cpu"],
                       results=str(tmp_path))
    assert rc == 1 and "['reshard_events']" in err.getvalue()
    assert not os.listdir(tmp_path)
