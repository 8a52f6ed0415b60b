"""The port's sampling profiler on the JAX package's cases
(``tests/test_prof.py``): folded-stack capture, collapsed and speedscope
exports, and the <= 5% guarded-overhead throttle law."""

import json
import threading
import time

import pytest

from tuplewise_tpu_torch.obs.prof import SamplingProfiler, export_profile
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


def _busy(stop_ev):
    # a recognizable frame to find in the folded stacks
    while not stop_ev.wait(0.0005):
        sum(i * i for i in range(200))


class TestSampling:
    def test_captures_named_thread_stacks(self):
        stop_ev = threading.Event()
        t = threading.Thread(target=_busy, args=(stop_ev,),
                             name="busy-victim", daemon=True)
        t.start()
        try:
            prof = SamplingProfiler(hz=500.0)
            with prof:
                time.sleep(0.15)
        finally:
            stop_ev.set()
            t.join()
        folded = prof.folded()
        assert prof.samples > 0 and folded
        stacks = list(folded)
        # root frame is the thread name; the victim appears
        assert any(st[0] == "thread:busy-victim" for st in stacks)
        assert any("test_torch_prof.py:_busy" in fr
                   for st in stacks for fr in st)
        # the sampler never samples itself
        assert not any(st[0] == "thread:tuplewise-prof"
                       for st in stacks)

    def test_hard_off_without_start(self):
        prof = SamplingProfiler()
        time.sleep(0.02)
        assert prof.samples == 0 and not prof.folded()
        assert prof.overhead_fraction() == 0.0

    def test_validation(self):
        with pytest.raises(ValueError):
            SamplingProfiler(hz=0)
        with pytest.raises(ValueError):
            SamplingProfiler(max_overhead=0.0)


class TestOverheadGuard:
    def test_throttle_doubles_interval_past_cap(self):
        prof = SamplingProfiler(hz=100.0, max_overhead=0.05)
        i0 = prof._interval
        # a sample costing 10x the cap must throttle
        prof._note_cost(10 * prof.max_overhead * i0)
        assert prof._interval == pytest.approx(2 * i0)
        assert prof.throttles == 1

    def test_cheap_samples_do_not_throttle(self):
        prof = SamplingProfiler(hz=100.0, max_overhead=0.05)
        i0 = prof._interval
        for _ in range(20):
            prof._note_cost(0.1 * prof.max_overhead * i0)
        assert prof._interval == i0 and prof.throttles == 0

    def test_interval_capped_at_one_second(self):
        prof = SamplingProfiler(hz=2.0, max_overhead=0.01)
        for _ in range(10):
            prof._note_cost(10.0)
        assert prof._interval == 1.0

    def test_metrics_exported(self):
        reg = MetricsRegistry()
        prof = SamplingProfiler(hz=1000.0, metrics=reg)
        prof.sample_once()
        prof._note_cost(1.0)   # force a throttle
        snap = reg.snapshot()
        assert snap["prof_samples_total"]["value"] == 1
        assert snap["prof_throttles_total"]["value"] == 1
        assert "prof_overhead_fraction" in snap


class TestExports:
    @pytest.fixture()
    def sampled(self):
        stop_ev = threading.Event()
        t = threading.Thread(target=_busy, args=(stop_ev,),
                             name="export-victim", daemon=True)
        t.start()
        prof = SamplingProfiler(hz=500.0)
        with prof:
            time.sleep(0.1)
        stop_ev.set()
        t.join()
        assert prof.folded()
        return prof

    def test_collapsed_roundtrip(self, sampled, tmp_path):
        p = str(tmp_path / "prof.collapsed")
        n = sampled.export_collapsed(p)
        assert n == len(sampled.folded())
        from scripts.trace_summary import load_collapsed

        back = dict(load_collapsed(p))
        assert back == {tuple(k): v for k, v in sampled.folded().items()}

    def test_speedscope_schema(self, sampled, tmp_path):
        p = str(tmp_path / "prof.speedscope.json")
        n = sampled.export_speedscope(p)
        with open(p, "r", encoding="utf-8") as f:
            doc = json.load(f)
        assert "speedscope" in doc["$schema"]
        prof = doc["profiles"][0]
        assert prof["type"] == "sampled"
        assert len(prof["samples"]) == n == len(prof["weights"])
        nf = len(doc["shared"]["frames"])
        assert all(0 <= i < nf for s in prof["samples"] for i in s)
        assert sum(prof["weights"]) == pytest.approx(
            prof["endValue"], abs=1e-9)

    def test_export_profile_suffix_dispatch(self, sampled, tmp_path):
        c = str(tmp_path / "x.collapsed")
        s = str(tmp_path / "x.speedscope.json")
        assert export_profile(sampled, c) == c
        assert export_profile(sampled, s) == s
        assert export_profile(None, c) is None
        assert export_profile(sampled, None) is None
        with open(c, encoding="utf-8") as f:
            line = f.readline().strip()
        stack, _, count = line.rpartition(" ")
        assert ";" in stack and int(count) >= 1
