"""Percent: the pair-sum launches' least times (bytes only) over their
kernels' device time."""

from benchmark import readlib


def read(ctx):
    return readlib.launch_roofline(ctx, "pair_kernels",
                                   readlib.PAIR_SUM_COUNTERS,
                                   readlib.pair_sum_least)
