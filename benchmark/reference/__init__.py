"""Plain PyTorch references of the benchmark's cells.

Nothing here imports the port (``tuplewise_tpu_torch``), the JAX package
or JAX. Each reference works out again, from the run's seed, what the
port derives for itself (rows, partitions, parameters), and computes the
statistic or the training steps in the plainest form, so that
``correct`` compares the port's outputs with an independent answer.
"""
