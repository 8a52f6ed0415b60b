"""The port's chaos injector (tuplewise_tpu_torch.testing.chaos) against
the reference's (tuplewise_tpu.testing.chaos): the same spec gives the
same schedule, the same raises at the same calls, the same declared
dead-worker sets and the same ``snapshot()``; ``random(seed)`` gives the
reference's schedule and poison positions for every seed.
"""

import json

import numpy as np
import pytest

from tuplewise_tpu.testing import chaos as jchaos
from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.tracing import Tracer
from tuplewise_tpu_torch.testing import (
    FaultInjector, InjectedDeviceError, InjectedFault,
)
from tuplewise_tpu_torch.testing import chaos

SPEC = {"faults": [
    {"point": "estimator", "on_call": 2, "action": "error", "dropped": [3]},
    {"point": "train_step", "on_call": 1, "action": "error"},
    {"point": "mc_chunk", "on_call": 3, "action": "delay",
     "seconds": 0.001},
    {"point": "checkpoint", "on_call": 2, "action": "error"},
    {"point": "batcher", "on_call": 1, "action": "error"},
    {"point": "mesh_mc", "on_call": 1, "action": "error", "dropped": [0, 2]},
    {"point": "poison", "at_events": [4, 9], "value": "inf"},
]}


def _schedule(inj):
    return [(f.point, f.on_call, f.action, f.seconds, f.dropped)
            for f in inj._faults]


def _drive(inj, calls):
    """Fire the points in order: each call's outcome (the exception's
    class name or None) and the dead set it leaves pending."""
    out = []
    for point in calls:
        try:
            inj.fire(point)
            raised = None
        except Exception as e:  # noqa: BLE001 — compared below
            raised = type(e).__name__
        out.append((point, raised, inj.take_dropped()))
    return out


def test_points_and_actions_are_the_reference_s():
    assert chaos._POINTS == jchaos._POINTS
    assert chaos._ACTIONS == jchaos._ACTIONS
    assert issubclass(InjectedDeviceError, InjectedFault)


@pytest.mark.parametrize("form", ["dict", "json", "at_path", "json_path"])
def test_from_spec_equals_reference(form, tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(SPEC))
    spec = {"dict": SPEC, "json": json.dumps(SPEC),
            "at_path": f"@{path}", "json_path": str(path)}[form]
    got, want = FaultInjector.from_spec(spec), jchaos.FaultInjector.from_spec(
        spec)
    assert _schedule(got) == _schedule(want)
    assert got.poison_at == want.poison_at == frozenset({4, 9})
    assert got.poison_value == want.poison_value == float("inf")
    assert FaultInjector.from_spec(got) is got


def test_fire_counts_and_snapshot_equal_reference():
    calls = (["estimator"] * 3 + ["train_step"] * 2 + ["mc_chunk"] * 4
             + ["checkpoint"] * 3 + ["batcher", "mesh_mc", "mesh_mc",
                                     "dist_init"])
    got = FaultInjector.from_spec(SPEC)
    want = jchaos.FaultInjector.from_spec(SPEC)
    trace = _drive(got, calls)
    assert trace == _drive(want, calls)
    assert ("estimator", "InjectedDeviceError", (3,)) in trace
    assert ("checkpoint", "InjectedFault", None) in trace
    assert ("mesh_mc", "InjectedDeviceError", (0, 2)) in trace
    assert got.snapshot() == want.snapshot()
    snap = got.snapshot()
    assert snap["fired"] == {"estimator": 1, "train_step": 1,
                             "mc_chunk": 1, "checkpoint": 1, "batcher": 1,
                             "mesh_mc": 1}
    assert snap["unfired"] == 0 and snap["calls"]["mc_chunk"] == 4


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2024])
@pytest.mark.parametrize("n_events", [2, 50, 10_000])
def test_random_schedule_equals_reference(seed, n_events):
    got = FaultInjector.random(seed, n_events)
    want = jchaos.FaultInjector.random(seed, n_events)
    assert _schedule(got) == _schedule(want)
    assert got.poison_at == want.poison_at


def test_poison_batch_equals_reference():
    got = FaultInjector.from_spec(SPEC)
    want = jchaos.FaultInjector.from_spec(SPEC)
    scores = np.linspace(0, 1, 6)
    for start in (0, 6, 12):
        a, na = got.poison_batch(start, scores)
        b, nb = want.poison_batch(start, scores)
        np.testing.assert_array_equal(a, b)
        assert na == nb
    assert got.poisoned == want.poisoned == 2
    assert scores[4] != float("inf")            # the input is not mutated


def test_take_dropped_is_consumed_once():
    inj = FaultInjector.from_spec({"faults": [
        {"point": "estimator", "on_call": 1, "dropped": [1]}]})
    assert inj.take_dropped() is None
    with pytest.raises(InjectedDeviceError, match="call #1"):
        inj.fire("estimator")
    assert inj.take_dropped() == (1,)
    assert inj.take_dropped() is None
    inj.fire("estimator")                       # one-shot: no second fault


@pytest.mark.parametrize("bad,match", [
    ({"point": "nowhere"}, "unknown fault point"),
    ({"point": "estimator", "action": "explode"}, "unknown fault action"),
    ({"point": "estimator", "on_call": 0}, "1-based"),
])
def test_bad_specs_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        FaultInjector.from_spec({"faults": [bad]})
    with pytest.raises(ValueError, match="dict"):
        FaultInjector.from_spec("[1, 2]")


def test_flight_recorder_witnesses_faults_and_tracer_is_not_ported():
    flight = FlightRecorder()
    inj = FaultInjector.from_spec(SPEC)
    inj.attach(flight=flight)
    with pytest.raises(InjectedDeviceError):
        inj.fire("train_step")
    inj.poison_batch(0, np.zeros(10))
    kinds = [e["kind"] for e in flight.events()]
    assert kinds == ["chaos_inject", "chaos_poison"]
    ev = flight.events("chaos_inject")[0]
    assert (ev["point"], ev["action"], ev["on_call"]) == (
        "train_step", "error", 1)
    assert ev["trace_id"] is None       # no tracer attached
    # tracing is ported: an attached tracer correlates the injection
    # with the active span, or a fresh trace outside any span
    tr = Tracer()
    inj2 = FaultInjector.from_spec(SPEC)
    inj2.attach(flight=flight, tracer=tr)
    with tr.span("outer") as sp:
        with pytest.raises(InjectedDeviceError):
            inj2.fire("train_step")
    assert flight.events("chaos_inject")[-1]["trace_id"] == sp.trace_id
    with pytest.raises(TypeError, match="Tracer"):
        inj.attach(tracer=object())
