"""Percent of the float32 peak: a whole step's operations over the traced
window's time a step."""

from benchmark import readlib


def read(ctx):
    return readlib.step_mfu(ctx, "steps")
