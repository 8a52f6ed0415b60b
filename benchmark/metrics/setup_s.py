"""Seconds from the process start to the first timed call: imports, the
CUDA context, loading (or building) the kernels, making the inputs,
warm-up."""


def read(ctx):
    return ctx["setup_s"]
