"""Percent of the traced window with no operation on the device, in the
learner's cells."""

from benchmark import readlib


def read(ctx):
    return readlib.idle_share(ctx, "steps")
