"""Percent: the logistic gradient launches' least times over their kernels'
device time."""

from benchmark import readlib


def read(ctx):
    return readlib.launch_roofline(ctx, "grad_kernels",
                                   readlib.GRAD_COUNTERS,
                                   readlib.grad_least)
