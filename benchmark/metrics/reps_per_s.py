"""Monte-Carlo repetitions completed over the whole window, a second."""

from benchmark import readlib


def read(ctx):
    return readlib.rate(ctx, "reps")
