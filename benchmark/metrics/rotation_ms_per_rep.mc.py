"""Device ms of the ring's rotations of the visiting blocks, a rep."""

from benchmark import readlib


def read(ctx):
    return readlib.ms_per_unit(ctx, "rotation", "reps")
