"""Device ms of the port's own pair-sum kernels (kernels 1-2), a rep."""

from benchmark import readlib


def read(ctx):
    return readlib.ms_per_unit(ctx, "pair_kernels", "reps")
