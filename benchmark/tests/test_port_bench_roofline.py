"""The yardstick's arithmetic: least times, shares and the reduction of
a trace, against hand-worked values."""

import math

import pytest

from benchmark import readlib, roofline, trace

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_table():
    assert H100 == {"fp32_ops_per_s": 67e12, "bytes_per_s": 3.35e12}
    assert roofline.peaks("some other card") is None


def test_kernel3_least_time_at_the_learners_shape():
    # 8 workers x 30000 x 95000 pairs x 13 operations / 67 TFLOP/s
    s = roofline.grad_least_s("logistic", "pair_loss_grad", 8, 30000, 95000, H100)
    assert s == pytest.approx(8 * 30000 * 95000 * 13 / 67e12)
    assert s * 1e3 == pytest.approx(4.4239, abs=1e-4)
    # without the loss: 7 a pair
    s7 = roofline.grad_least_s("logistic", "pair_grad_sums", 8, 30000, 95000, H100)
    assert s7 == pytest.approx(8 * 30000 * 95000 * 7 / 67e12)


def test_grad_least_time_is_bytes_bound_on_a_tiny_grid():
    # 1 x 1 pairs: 13 operations against 16 bytes of scores, row and col
    # and 8 of the loss
    s = roofline.grad_least_s("logistic", "pair_loss_grad", 1, 1, 1, H100)
    assert s == pytest.approx(24 / 3.35e12)


def test_ring_stop_least_time():
    # one stop of config 5: 8 workers' 1.25e6 + 1.25e6 float32 scores read
    # once, 8 float64 sums written once: 80 MB
    s = roofline.pair_sum_least_s(8, 1_250_000, 1_250_000, False, H100)
    assert s == pytest.approx((80_000_000 + 64) / 3.35e12)
    assert s * 1e6 == pytest.approx(23.88, abs=0.01)
    masked = roofline.pair_sum_least_s(8, 1_250_001, 1_250_000, True, H100)
    assert masked == pytest.approx(
        (4 * 8 * 2_500_001 * 2 + 64) / 3.35e12)


def test_linear_step_operations():
    ops = roofline.linear_sgd_step_ops("logistic", 8, 30000, 95000, 14, True)
    assert ops == 8 * 30000 * 95000 * 13 + 4 * 14 * 8 * 125000 + 2 * 15


def _ctx(**kw):
    ctx = {"unit": "reps", "units": 100, "window_s": 4.0, "setup_s": 7.5,
           "call_s": [], "launches": {}, "launch_shapes": {},
           "step_ops": None, "peak": H100, "trace": None}
    ctx.update(kw)
    return ctx


def _trace(**kw):
    t = {"window_us": 4e6, "busy_us": 3.8e6, "layer_us": {},
         "name_us": {}, "device_ops": [], "idle_gaps": []}
    t.update(kw)
    return t


def test_rates_and_per_unit_times():
    assert readlib.rate(_ctx(), "reps") == 25.0
    assert readlib.rate(_ctx(), "steps") is None
    ctx = _ctx(trace=_trace(layer_us={"draw": 12_000.0}))
    assert readlib.ms_per_unit(ctx, "draw", "reps") == pytest.approx(0.12)
    assert readlib.ms_per_unit(ctx, "rotation", "reps") is None
    assert readlib.ms_per_unit(_ctx(), "draw", "reps") is None
    assert readlib.idle_share(ctx, "reps") == pytest.approx(5.0)


def test_pair_kernel_roofline_of_a_complete_rep():
    # 100 reps of 8 stops, each 4.07 ms of device time
    shape = (8, 1_250_000, 1_250_000, False)
    ctx = _ctx(launches={"pair_sum[auc]": 800, "pair_loss_grad[x]": 3},
               launch_shapes={"pair_sum[auc]": shape},
               trace=_trace(layer_us={"pair_kernels": 800 * 4070.0}))
    share = readlib.launch_roofline(ctx, "pair_kernels",
                                    readlib.PAIR_SUM_COUNTERS,
                                    readlib.pair_sum_least)
    least = roofline.pair_sum_least_s(*shape, H100)
    assert share == pytest.approx(100 * least / 4.07e-3)
    assert 0.5 < share < 0.7


def test_roofline_is_silent_without_launches_device_time_or_peaks():
    shape = (8, 10, 10, False)
    base = dict(launches={"pair_sum[auc]": 5},
                launch_shapes={"pair_sum[auc]": shape},
                trace=_trace(layer_us={"pair_kernels": 100.0}))
    args = ("pair_kernels", readlib.PAIR_SUM_COUNTERS, readlib.pair_sum_least)
    assert readlib.launch_roofline(_ctx(**base), *args) is not None
    for change in ({"launches": {}}, {"peak": None},
                   {"trace": _trace(layer_us={})}, {"launch_shapes": {}}):
        ctx = _ctx(**{**base, **change})
        assert readlib.launch_roofline(ctx, *args) is None


def test_grad_kernel_roofline_and_step_mfu():
    shape = (8, 30000, 95000)
    ctx = _ctx(unit="steps", units=300, window_s=9.0,
               launches={"pair_loss_grad[logistic]": 300},
               launch_shapes={"pair_loss_grad[logistic]": shape},
               step_ops=roofline.linear_sgd_step_ops("logistic", *shape, 14,
                                                    True),
               trace=_trace(layer_us={"grad_kernels": 300 * 28_900.0}))
    share = readlib.launch_roofline(ctx, "grad_kernels",
                                    readlib.GRAD_COUNTERS, readlib.grad_least)
    assert share == pytest.approx(100 * 4.42388e-3 / 28.9e-3, rel=1e-4)
    mfu = readlib.step_mfu(ctx, "steps")
    assert mfu == pytest.approx(100 * ctx["step_ops"] * 300 / 9.0 / 67e12)
    assert mfu < share < 100



def test_hinge_gradient_counts_bytes_only():
    # the hinge gradient is a sort-and-search: its scores read and its
    # sums written once, as the pair sums count
    s = roofline.grad_least_s("hinge", "pair_loss_grad", 8, 30000, 95000,
                              H100)
    assert s == pytest.approx((4 * 2 * 8 * 125000 + 8 * 8) / 3.35e12)
    ctx = _ctx(unit="steps", units=10,
               launches={"pair_loss_grad[hinge]": 10},
               launch_shapes={"pair_loss_grad[hinge]": (8, 30000, 95000)},
               trace=_trace(layer_us={"grad_kernels": 10 * 350.0}))
    share = readlib.launch_roofline(ctx, "grad_kernels",
                                    readlib.GRAD_COUNTERS, readlib.grad_least)
    assert share == pytest.approx(100 * s / 350e-6)
    assert roofline.linear_sgd_step_ops("hinge", 8, 30000, 95000, 14,
                                        True) == 4 * 14 * 8 * 125000 + 30


def test_interval_merge_on_hand_made_intervals():
    assert trace.busy_us([]) == 0.0
    assert trace.busy_us([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert trace.busy_us([(5, 6), (0, 10)]) == 10.0
    assert trace.busy_us([(0, 1), (1, 2)]) == 2.0
    assert trace.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 10) == [
        (0, 1), (3, 5), (6, 10)]
    assert trace.idle_gaps([(0, 10)], 2, 8) == []
    assert trace.clip([("k", -1, 3), ("j", 9, 12), ("x", 20, 30)], 0, 10) \
        == [("k", 0, 3), ("j", 9, 10)]


def test_host_label_takes_the_innermost_operation():
    host = [("bench.call", 0, 100), ("aten::item", 40, 60),
            ("cudaStreamSynchronize", 45, 59)]
    assert trace.host_label(host, 50) == "cudaStreamSynchronize"
    assert trace.host_label(host, 20) == "bench.call"
    assert trace.host_label(host, 200) == "host idle"


def test_reduce_a_hand_made_trace():
    table = trace.load_name_table("auc_gauss_1e7_w8.complete")
    k1 = "void (anonymous namespace)::auc_count_kernel<14>(float const*)"
    roll = "void at::native::roll_cuda_kernel<float>(float const*)"
    reduce_torch = "void at::native::reduce_kernel<512, 1>(x)"
    device = [(k1, 10, 50), (roll, 50, 52), (reduce_torch, 60, 70),
              (k1, 90, 130)]
    host = [(trace.WINDOW_SPAN, 0, 100), (trace.CALL_SPAN, 1, 99),
            ("aten::item", 70, 90)]
    r = trace.reduce(device, host, table)
    assert r["window_us"] == 100
    assert r["busy_us"] == 40 + 2 + 10 + 10
    assert r["layer_us"] == {"pair_kernels": 50, "rotation": 2}
    assert r["device_ops"][0] == (k1, 50)
    assert r["idle_gaps"][0] == ("aten::item", 20)
    assert r["idle_gaps"][1] == ("bench.call", 10)
    with pytest.raises(RuntimeError):
        trace.reduce(device, host[1:], table)


class _Ev:
    # a raw event of the profiler, times in nanoseconds
    def __init__(self, name, dev, s, e):
        import torch

        self._name, self._s, self._d = name, s * 1000, (e - s) * 1000
        self._dev = getattr(torch.autograd.DeviceType, dev)

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_split_events_drops_the_device_copies_of_the_benchmarks_spans():
    events = [_Ev(trace.WINDOW_SPAN, "CPU", 0, 10),
              _Ev(trace.CALL_SPAN, "CUDA", 0, 10), _Ev("k", "CUDA", 2, 3)]
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events":
                                                  lambda self: events})()
    device, host = trace.split_events(prof)
    assert device == [("k", 2.0, 3.0)]
    assert host == [(trace.WINDOW_SPAN, 0.0, 10.0)]


def test_split_events_of_a_real_profile():
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            torch.ones(4).sum()
    device, host = trace.split_events(prof)
    spans = [h for h in host if h[0] == trace.WINDOW_SPAN]
    assert device == [] and len(spans) == 1
    ops = [h for h in host if h[0] == "aten::sum"]
    assert ops and spans[0][1] <= ops[0][1] <= ops[0][2] <= spans[0][2]


def test_a_cells_own_name_file_comes_first(tmp_path):
    import json

    (tmp_path / "port.json").write_text(json.dumps(
        {"layers": {"pair_kernels": ["grad_finish_kernel"]}}))
    (tmp_path / "hinge.json").write_text(json.dumps(
        {"workloads": ["x.hinge_full"],
         "layers": {"grad_kernels": ["grad_finish_kernel"]}}))
    name = "void (anonymous namespace)::grad_finish_kernel(float*)"
    own = trace.load_name_table("x.hinge_full", tmp_path)
    other = trace.load_name_table("x.complete", tmp_path)
    assert trace.layer_of(name, own) == "grad_kernels"
    assert trace.layer_of(name, other) == "pair_kernels"


@pytest.mark.parametrize("name,layer", [
    ("void (anonymous namespace)::sort_tiles_kernel<1024, 16>(float const*)",
     "pair_kernels"),
    ("void (anonymous namespace)::masked_search_kernel<14, false>(float)",
     "pair_kernels"),
    ("void (anonymous namespace)::logistic_grad_kernel<true>(float const*)",
     "grad_kernels"),
    ("(anonymous namespace)::reduce_kernel(float const*, float const*)",
     "grad_kernels"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     None),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int>", None),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid"
     "_stride_kernel<float, 4, at::native::templates::cuda::normal_and_"
     "transform<float>", "draw"),
    ("void at::native::roll_cuda_kernel<float>(float const*)", "rotation"),
])
def test_name_table(name, layer):
    for cell in ("auc_gauss_1e7_w8.complete",
                 "sgd_adult14_1e6_w8.logistic_full"):
        assert trace.layer_of(name, trace.load_name_table(cell)) == layer


def test_shares_never_pass_100_for_real_device_times():
    # the least time is a lower bound of any launch: a share over 100 %
    # means the counts are too high
    s = roofline.grad_least_s("logistic", "pair_loss_grad", 8, 30000, 95000, H100)
    assert 100 * s / 28.9e-3 < 100
    assert math.isfinite(s)
