"""The hot paths' spans and counters: ``utils.profiling.annotate`` (the
shared no-op without a profiler, a host range under one),
``obs.tracing.COUNTS``, and the spans the Monte-Carlo runner, the mesh
backend, the ring and the trainer open, as a CPU profiler records them.
Pass 3 of the static analysis counts ``annotate("name")`` as a span
producer."""

import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tuplewise_tpu_torch.analysis import telemetry_xref
from tuplewise_tpu_torch.analysis.core import ModuleSet
from tuplewise_tpu_torch.harness.mesh_mc import make_mesh_mc_runner
from tuplewise_tpu_torch.harness.variance import VarianceConfig
from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig, train_pairwise
from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.obs.tracing import _NULL_SPAN, COUNTS
from tuplewise_tpu_torch.utils import profiling

PROGRAM = ("mc.", "mesh.", "ring.", "train.")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spy(monkeypatch):
    from torch._C._profiler import _RecordFunctionFast as real

    made = []

    def spy(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_range", spy)
    return made


def test_annotate_is_the_shared_no_op_without_a_profiler(monkeypatch):
    made = _spy(monkeypatch)
    for _ in range(3):
        span = profiling.annotate("mc.rep")
        assert span is _NULL_SPAN
        with span:
            pass
    assert made == []


def test_the_port_imports_and_spans_off_without_torch_s_private_range():
    code = (
        "import torch._C._profiler as p\n"
        "del p._RecordFunctionFast\n"
        "import tuplewise_tpu_torch.harness.mesh_mc\n"
        "import tuplewise_tpu_torch.models.pairwise_sgd\n"
        "from tuplewise_tpu_torch.obs.tracing import _NULL_SPAN\n"
        "from tuplewise_tpu_torch.utils import profiling\n"
        "assert profiling.annotate('mc.rep') is _NULL_SPAN\n"
        "assert profiling._range is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_annotate_records_a_host_operation_under_a_profiler(monkeypatch):
    made = _spy(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("mc.rep"):
            torch.ones(4).sum()
    assert made == ["mc.rep"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "mc.rep"]
    assert len(events) == 1
    # an operation, not a user annotation: the device timeline keeps no
    # copy of it
    assert not events[0].is_user_annotation()


def _host_spans(fn):
    """(fn's value, [(name, start, end)] of the program spans it opened
    under a CPU profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PROGRAM):
            spans.append((e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns()))
    return out, spans


def _inside(spans, name, outer):
    """How many ``name`` spans each ``outer`` span holds, all ``name``
    spans lying in one."""
    outers = [(s, e) for n, s, e in spans if n == outer]
    per = collections.Counter()
    for n, s, e in spans:
        if n != name:
            continue
        hits = [i for i, (os_, oe) in enumerate(outers)
                if os_ <= s and e <= oe]
        assert hits, f"a {name} span outside every {outer}"
        per[hits[-1]] += 1
    return [per[i] for i in range(len(outers))]


MC_CASES = {
    # scheme fields, class sizes, {span: count a rep}, host reads a rep
    "complete": ({"scheme": "complete"}, (64, 48),
                 {"mc.draw": 1, "mc.read": 1, "ring.stop": 8,
                  "ring.rotate": 8}, 2),
    "complete_ragged": ({"scheme": "complete"}, (67, 43),
                        {"mc.draw": 1, "mc.read": 1, "ring.stop": 8,
                         "ring.rotate": 8}, 2),
    "repartitioned": ({"scheme": "repartitioned", "n_rounds": 3}, (64, 48),
                      {"mc.draw": 1, "mc.read": 3, "mesh.round": 3}, 3),
    "local": ({"scheme": "local"}, (64, 48),
              {"mc.draw": 1, "mc.read": 1, "mesh.round": 1}, 1),
    "incomplete": ({"scheme": "incomplete", "n_pairs": 200}, (64, 48),
                   {"mc.draw": 1, "mc.read": 1}, 1),
}


@pytest.mark.parametrize("case", sorted(MC_CASES))
def test_mesh_mc_spans_nest_a_call_a_rep(case):
    fields, (n1, n2), per_rep, reads = MC_CASES[case]
    cfg = VarianceConfig(kernel="auc", backend="mesh", n_pos=n1, n_neg=n2,
                         n_workers=8, seed=5, **fields)
    run = make_mesh_mc_runner(cfg, device="cpu")
    reps = range(3, 6)
    plain = run(reps)
    c0 = COUNTS["host_read[mc.read]"]
    traced, spans = _host_spans(lambda: run(reps))
    # the spans change no value; the host reads count with or without a
    # profiler
    np.testing.assert_array_equal(traced, plain)
    assert COUNTS["host_read[mc.read]"] - c0 == reads * len(reps)
    names = collections.Counter(n for n, _, _ in spans)
    assert names["mc.run"] == 1
    assert _inside(spans, "mc.rep", "mc.run") == [len(reps)]
    for name, k in per_rep.items():
        assert _inside(spans, name, "mc.rep") == [k] * len(reps), name
    if "mesh.round" in per_rep:
        # one draw and one regather a class a round, the means once
        for name, k in (("mesh.partition", 2), ("mesh.regather", 2),
                        ("mesh.block_means", 1)):
            assert (_inside(spans, name, "mesh.round")
                    == [k] * names["mesh.round"]), name
    else:
        assert not any(n.startswith("mesh.") for n in names)


@pytest.mark.parametrize("steps,every,boundaries", [(5, 2, 3), (6, 10, 1)])
def test_train_pairwise_spans_a_call_a_step_a_boundary(steps, every,
                                                       boundaries):
    rng = np.random.default_rng(0)
    Xp = rng.normal(size=(40, 3)).astype(np.float32) + 0.5
    Xn = rng.normal(size=(56, 3)).astype(np.float32)
    cfg = TrainConfig(kernel="logistic", lr=0.1, steps=steps, n_workers=4,
                      repartition_every=every, seed=2)
    scorer = LinearScorer(dim=3)

    def fit():
        return train_pairwise(scorer, None, Xp, Xn, cfg, device="cpu")

    plain, _ = fit()
    c0 = dict(COUNTS)
    (traced, hist), spans = _host_spans(fit)
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k])
    assert len(hist["loss"]) == steps
    names = collections.Counter(n for n, _, _ in spans)
    assert names == {"train.place": 1, "train.step": steps,
                     "train.regather": boundaries, "train.read": 1}
    # the read is the ``train.read`` span's count; the trainer counts
    # nothing in ``COUNTS``
    assert dict(COUNTS) == c0


def test_pass3_counts_annotate_as_a_span_producer():
    src = '''
from tuplewise_tpu_torch.utils import profiling
from tuplewise_tpu_torch.utils.profiling import annotate


def f(ax, i):
    with annotate("mc.run"):
        pass
    with profiling.annotate(f"mesh.round{i}"):
        pass
    ax.annotate("T=1", (0, 0))
'''
    ms = ModuleSet.from_sources({"tuplewise_tpu_torch/fixture.py": src})
    _, _, spans, _ = telemetry_xref.collect_producers(ms)
    assert spans == {"mc.run", "mesh.round*"}
