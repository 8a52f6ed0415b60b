"""Device ms of the normal-draw kernels (the runner's worker draws), a rep."""

from benchmark import readlib


def read(ctx):
    return readlib.ms_per_unit(ctx, "draw", "reps")
