"""scripts_torch/config_suite.py against the JAX package's
scripts/config_suite.py, configs 1, 3 and 4 at --quick sizes on the CPU.

Config 1's numpy and cpp estimates (the host oracles, the same numpy
Gaussians) equal the reference's bit for bit, and the port's torch
estimate equals numpy's within the JAX-vs-NumPy complete-U tolerance
(1e-6, tests/test_jax_backend.py); config 4's numpy row equals the
reference's; every row has the reference's keys, with "torch" where it
has "jax", plus the card stamp. Both write into tmp_path (the module
RESULTS of the reference, results= of the port), never into results/.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path) as f:
        return {str(r["config"]): r for r in map(json.loads, f)}


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    ref = _load("scripts/config_suite.py", "ref_config_suite")
    port = _load("scripts_torch/config_suite.py", "port_config_suite")
    d_ref = tmp_path_factory.mktemp("ref")
    d_port = tmp_path_factory.mktemp("port")
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "RESULTS", str(d_ref))
    mp.setattr(sys, "argv", ["config_suite.py", "--quick", "--configs",
                             "1,3,4"])
    with contextlib.redirect_stderr(io.StringIO()):
        ref.main()
        rc = port.main(["--quick", "--configs", "1,3,4", "--device", "cpu"],
                       results=str(d_port))
    mp.undo()
    assert rc == 0
    assert not os.path.exists(os.path.join(ROOT, "results", "torch",
                                           "configs_quick.jsonl"))
    return (_rows(d_ref / "configs_quick.jsonl"),
            _rows(d_port / "configs_quick.jsonl"), d_ref, d_port)


def _renamed(keys):
    return {k.replace("jax", "torch") for k in keys}


@pytest.mark.parametrize("config", ["1", "3", "4"])
def test_row_keys_are_the_reference_keys(suites, config):
    ref, port, _, _ = suites
    assert set(port[config]) == _renamed(ref[config]) | {"card"}
    assert port[config]["card"] is None and port[config]["quick"]


def test_config1_estimates(suites):
    ref, port, _, _ = suites
    want, got = ref["1"]["estimates"], port["1"]["estimates"]
    assert got["numpy"] == want["numpy"]
    if "cpp" in want:
        assert got["cpp"] == want["cpp"]
    assert abs(got["torch"] - got["numpy"]) < 1e-6
    assert set(port["1"]["pairs_per_s"]) == _renamed(ref["1"]["pairs_per_s"])


def test_config3_estimate(suites):
    ref, port, _, _ = suites
    for k in ("n_pos", "n_neg", "B"):
        assert port["3"][k] == ref["3"][k]
    # B = 10^4 sampled pairs from different generators: within 4 se of
    # their difference (AUC near 0.76, se ~ 0.0043 each)
    assert abs(port["3"]["estimate"] - ref["3"]["estimate"]) < 4 * 0.0061


def test_config4_rows(suites):
    ref, port, d_ref, d_port = suites
    assert port["4"]["numpy"] == ref["4"]["numpy"]
    assert port["4"]["torch"] == dict(ref["4"]["jax"], backend="torch")
    assert port["4"]["complete_throughput_shape"] == \
        ref["4"]["complete_throughput_shape"]
    with open(d_ref / "triplet_scaling_quick.jsonl") as f:
        want = [json.loads(x) for x in f]
    with open(d_port / "triplet_scaling_quick.jsonl") as f:
        got = [json.loads(x) for x in f]
    assert [set(r) for r in got] == [set(r) | {"card"} for r in want]


def test_failures_exit_nonzero_and_keep_error_rows(tmp_path, monkeypatch):
    """A config that fails leaves its error row, the suite goes on, and
    main returns 1; only the host oracles may be unavailable."""
    port = _load("scripts_torch/config_suite.py", "port_config_suite_f")

    def boom(out, q):
        raise RuntimeError("card lost")

    monkeypatch.setitem(port.config3.__globals__, "config3", boom)
    with contextlib.redirect_stderr(io.StringIO()):
        rc = port.main(["--quick", "--configs", "1,3", "--device", "cpu"],
                       results=str(tmp_path))
    rows = _rows(tmp_path / "configs_quick.jsonl")
    assert rc == 1 and "error" in rows["3"] and "estimates" in rows["1"]


def test_cpp_unavailable_is_reported_not_raised(tmp_path, monkeypatch):
    from tuplewise_tpu_torch import native

    port = _load("scripts_torch/config_suite.py", "port_config_suite_c")
    monkeypatch.setattr(native, "load_pair_lib", lambda: None)
    with contextlib.redirect_stderr(io.StringIO()):
        rc = port.main(["--quick", "--configs", "1", "--device", "cpu"],
                       results=str(tmp_path))
    est = _rows(tmp_path / "configs_quick.jsonl")["1"]["estimates"]
    assert rc == 0 and set(est) == {"numpy", "torch"}


def test_the_card_is_the_default(tmp_path, monkeypatch):
    port = _load("scripts_torch/config_suite.py", "port_config_suite_d")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            port.main(["--quick", "--configs", "1"], results=str(tmp_path))
    assert e.value.code == 2
    assert not os.listdir(tmp_path)
