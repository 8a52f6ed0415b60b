"""The reduction of the program's spans (``spans.py``) on made-up event
lists: device time to the spans open where it was launched, idle
stretches to the span open at their middle."""

import pytest

from benchmark import spans

W = ("bench.window", 1, 0.0, 100.0, 1)


def _host(*rows):
    return [W] + [tuple(r) for r in rows]


def test_device_time_goes_to_the_spans_open_on_the_launching_thread():
    host = _host(
        # thread 1: a rep holding a draw and a stop; thread 2: a regather
        # that overlaps the stop in time
        ("mc.rep", 1, 10.0, 60.0, 2),
        ("mc.draw", 1, 12.0, 20.0, 3),
        ("aten::randn", 1, 13.0, 14.0, 4),
        ("ring.stop", 1, 30.0, 50.0, 5),
        ("mesh.regather", 2, 28.0, 55.0, 6),
        ("aten::index", 2, 40.0, 41.0, 7),
    )
    device = [("normal", 14.0, 18.0, 4),          # by randn: draw, rep
              ("auc_count", 31.0, 45.0, 5),       # by the stop itself
              ("index_kernel", 45.0, 47.0, 7)]    # thread 2's regather
    r = spans.reduce(device, host)
    s = r["spans"]
    assert s["mc.draw"]["device_us"] == 4.0
    assert s["ring.stop"]["device_us"] == 14.0
    assert s["mc.rep"]["device_us"] == 18.0
    assert s["mesh.regather"]["device_us"] == 2.0
    assert r["device_us"] == 20.0 and r["unspanned_device_us"] == 0.0
    assert s["mc.rep"]["count"] == 1
    assert s["mc.rep"]["host_us"] == 50.0
    # self: the rep less its draw and its stop
    assert s["mc.rep"]["self_us"] == 50.0 - 8.0 - 20.0


def test_a_thread_with_no_span_open_takes_the_window_thread_s():
    # the autograd engine's thread runs a backward while the window's
    # thread waits in its step
    host = _host(("train.step", 1, 10.0, 40.0, 2),
                 ("aten::mm", 7, 20.0, 22.0, 3))
    r = spans.reduce([("gemv", 21.0, 25.0, 3)], host)
    assert r["spans"]["train.step"]["device_us"] == 4.0
    assert r["unspanned_device_us"] == 0.0


def test_bench_spans_and_unlinked_operations_are_unspanned():
    host = _host(("bench.call", 1, 5.0, 95.0, 2),
                 ("aten::copy_", 1, 6.0, 7.0, 3),
                 ("mc.run", 1, 10.0, 90.0, 4))
    device = [("memcpy", 7.0, 9.0, 3),       # launched outside mc.run
              ("kernel", 20.0, 30.0, 0),     # no link
              ("kernel", 30.0, 40.0, 99),    # a link to no host event
              ("kernel", 50.0, 60.0, 4)]
    r = spans.reduce(device, host)
    assert r["unspanned_device_us"] == 22.0
    assert r["device_us"] == 32.0
    assert r["spans"] == {"mc.run": {"count": 1, "host_us": 80.0,
                                     "self_us": 80.0, "device_us": 10.0}}


def test_idle_goes_to_the_innermost_span_open_at_the_gap_s_middle():
    host = _host(("mc.rep", 1, 10.0, 90.0, 2),
                 ("mc.read", 1, 40.0, 70.0, 3),
                 ("mc.draw", 1, 75.0, 80.0, 4))
    device = [("k", 0.0, 30.0, 2), ("k", 60.0, 100.0, 2)]
    r = spans.reduce(device, host)
    # the one gap [30, 60): middle 45, inside the read
    assert r["idle_us"] == {"mc.read": 30.0}
    assert r["unspanned_idle_us"] == 0.0
    # a gap with no program span open
    r = spans.reduce([("k", 0.0, 95.0, 2)], host)
    assert r["idle_us"] == {} and r["unspanned_idle_us"] == 5.0


def test_only_the_window_counts():
    host = [("mc.rep", 1, 0.0, 5.0, 2), ("bench.window", 1, 10.0, 50.0, 1),
            ("mc.rep", 1, 20.0, 30.0, 3)]
    device = [("k", 2.0, 12.0, 2), ("k", 21.0, 29.0, 3)]
    r = spans.reduce(device, host)
    assert r["spans"]["mc.rep"]["count"] == 1
    # the first rep's kernel runs 2 us into the window
    assert r["spans"]["mc.rep"]["device_us"] == 10.0
    assert r["device_us"] == 10.0


def test_no_window_raises():
    with pytest.raises(RuntimeError, match="bench.window"):
        spans.reduce([], [("mc.rep", 1, 0.0, 1.0, 2)])


class _Ev:
    """A raw profiler event: the methods ``split_events`` calls."""

    def __init__(self, name, kind, start, dur, corr=0, linked=0, thread=1,
                 annotation=False):
        self._v = (name, kind, start, dur, corr, linked, thread, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2] * 1000

    def duration_ns(self):
        return self._v[3] * 1000

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_split_events_drops_annotation_copies_and_runtime_calls():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    prof = _Prof([
        _Ev("bench.window", cpu, 0, 100, corr=1, annotation=True),
        _Ev("mc.rep", cpu, 10, 50, corr=2),
        _Ev("cudaLaunchKernel", cpu, 11, 1, corr=77, linked=2),
        _Ev("auc_count", cuda, 12, 20, corr=77, linked=2),
        # the device timeline's copies of host annotations
        _Ev("bench.window", cuda, 12, 20, corr=1, annotation=True),
        _Ev("some.range", cuda, 12, 20, corr=9, annotation=True),
    ])
    device, host = spans.split_events(prof)
    assert device == [("auc_count", 12.0, 32.0, 2)]
    assert [h[0] for h in host] == ["bench.window", "mc.rep"]
    r = spans.reduce(device, host)
    assert r["spans"]["mc.rep"]["device_us"] == 20.0


SIZES = {"auc_gauss_1e7_w8": {"n_pos": 4000, "n_neg": 4000},
         "sgd_adult14_1e6_w8": {"n_pos": 480, "n_neg": 1520}}
READS = {"auc_gauss_1e7_w8.complete": 2, "auc_gauss_1e7_w8.repart_t4": 4,
         "auc_gauss_1e7_w8.complete_ragged": 2}


@pytest.mark.parametrize("cell", sorted(READS) + [
    "sgd_adult14_1e6_w8.logistic_full"])
def test_a_cpu_run_reads_the_counts_and_no_device_time(cell):
    from benchmark import manifest, span_report

    config = manifest.cell(manifest.load(), cell)["config"]
    r = span_report.report(cell, 2**31 + 5, 0.3, device="cpu",
                           overrides=SIZES[config])
    assert r["correct"], r["checks"]
    sp = r["spans"]
    assert sp["units"] > 0 and sp["coverage_pct"] is None
    if cell in READS:
        # the counter, exact; no device time or idle stretch to read
        assert sp["readings"] == {"host_reads_per_rep.mc": READS[cell]}
        assert sp["reduction"]["spans"]["mc.rep"]["count"] == sp["units"]
    else:
        assert list(sp["readings"]) == ["train_step_host_ms.train"]
        assert sp["counts"] == {}
        assert sp["reduction"]["spans"]["train.read"]["count"] > 0
        assert (sp["reduction"]["spans"]["train.step"]["count"]
                == sp["units"])


def test_without_the_flag_the_benchmark_s_own_copies_are_dropped():
    import torch

    class Old(_Ev):
        is_user_annotation = None

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    prof = _Prof([Old("bench.window", cpu, 0, 100, corr=1),
                  Old("bench.call", cuda, 5, 10, corr=2),
                  Old("kernel", cuda, 5, 10, corr=3, linked=1)])
    device, _ = spans.split_events(prof)
    assert [d[0] for d in device] == ["kernel"]
