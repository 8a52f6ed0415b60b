"""What the metric readers (``metrics/<name>.py``) share: each takes the
run's context (``run.run_cell``'s ``ctx``) and returns the metric, or
None where the run has nothing to read for it. None leaves the metric
out of the result; a share of a roofline or a peak is never 0 for want
of a reading."""

from __future__ import annotations

from benchmark import roofline


def rate(ctx, unit: str):
    """Units completed over the whole window, a second."""
    if ctx["unit"] != unit or not ctx["units"]:
        return None
    return ctx["units"] / ctx["window_s"]


def ms_per_unit(ctx, layer: str, unit: str):
    """Device milliseconds of a layer's operations, a unit of work."""
    t = ctx["trace"]
    if t is None or ctx["unit"] != unit or not ctx["units"]:
        return None
    us = t["layer_us"].get(layer)
    return None if not us else us / 1e3 / ctx["units"]


def idle_share(ctx, unit: str):
    """Percent of the traced window with no operation on the device."""
    t = ctx["trace"]
    if t is None or ctx["unit"] != unit or not t["busy_us"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


#: the launch counters (``ops/pair_kernels.py`` ``LAUNCHES``) of each
#: roofline's launches
PAIR_SUM_COUNTERS = ("pair_sum[auc]", "masked_pair_sum[auc]",
                     "pair_sum[hinge]", "masked_pair_sum[hinge]")
GRAD_COUNTERS = ("pair_loss_grad[logistic]", "pair_grad_sums[logistic]",
                 "pair_loss_grad[hinge]", "pair_grad_sums[hinge]")


def launch_roofline(ctx, layer: str, counters, least_s):
    """Percent: the least times of the launches counted under
    ``counters`` over the device time of the layer's kernels.
    ``least_s(counter, shape, peak)`` gives one launch's least time; a
    counted launch whose shape the job does not give leaves the metric
    out."""
    t, peak = ctx["trace"], ctx["peak"]
    if t is None or peak is None:
        return None
    total, counted = 0.0, 0
    for counter, n in ctx["launches"].items():
        if counter not in counters:
            continue
        shape = ctx["launch_shapes"].get(counter)
        if shape is None:
            return None
        total += n * least_s(counter, shape, peak)
        counted += n
    us = t["layer_us"].get(layer)
    if not us or not counted:
        return None
    return 100.0 * total / (us * 1e-6)


def pair_sum_least(counter, shape, peak):
    W, n1, n2, masked = shape
    return roofline.pair_sum_least_s(W, n1, n2, masked, peak)


def grad_least(counter, shape, peak):
    wrapper, _, surrogate = counter.rstrip("]").partition("[")
    return roofline.grad_least_s(surrogate, wrapper, *shape, peak)


def step_mfu(ctx, unit: str):
    """Percent of the float32 peak: a unit's operations times the units,
    over the window."""
    if (ctx["trace"] is None or ctx["unit"] != unit or ctx["peak"] is None
            or ctx["step_ops"] is None or not ctx["units"]):
        return None
    return (100.0 * ctx["step_ops"] * ctx["units"]
            / (ctx["window_s"] * ctx["peak"]["fp32_ops_per_s"]))
