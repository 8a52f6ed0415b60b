"""Subpackage of tuplewise_tpu_torch (see the package docstring)."""
