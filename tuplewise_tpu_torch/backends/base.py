"""The Estimator(backend=...) boundary: a registry of execution backends.

A backend owns execution (how pair sums are tiled or launched, where
randomness comes from, how per-worker results are aggregated); the
estimator semantics live above it. The port's backends:

* ``torch`` — single device, PyTorch with hand-written CUDA pair kernels.
* ``mesh`` — a mesh of workers: the worker axis of one device, or one
  worker per ``torch.distributed`` rank (``parallel.mesh``).
* ``numpy`` — the host oracle: serial, blockwise, float64 numpy.
* ``cpp`` — the same oracle with its innermost pair reduction in the
  compiled host C++ of ``native/pair_sum.cpp``.
"""

from __future__ import annotations

from typing import Callable, Dict

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    def deco(cls):
        _BACKENDS[name] = cls
        return cls
    return deco


_LAZY = {
    "torch": "tuplewise_tpu_torch.backends.torch_backend",
    "mesh": "tuplewise_tpu_torch.backends.mesh_backend",
    "numpy": "tuplewise_tpu_torch.backends.numpy_backend",
    "cpp": "tuplewise_tpu_torch.backends.cpp_backend",
}


def get_backend(name: str, kernel, **opts):
    if name not in _BACKENDS and name in _LAZY:
        import importlib

        importlib.import_module(_LAZY[name])
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: "
            f"{sorted(set(_BACKENDS) | set(_LAZY))}"
        ) from None
    return cls(kernel, **opts)
