"""The benchmark of the PyTorch port (``tuplewise_tpu_torch``) on one
NVIDIA H100. ``run.py`` runs one cell of ``BENCHMARK.json`` once; the
README says how cells, metrics and references are found by name."""
