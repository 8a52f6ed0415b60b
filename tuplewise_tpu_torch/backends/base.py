"""The Estimator(backend=...) boundary: a registry of execution backends.

A backend owns execution (how pair sums are tiled or launched, where
randomness comes from, how per-worker results are aggregated); the
estimator semantics live above it. The port has one backend so far:

* ``torch`` — single device, PyTorch with hand-written CUDA pair kernels.
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
