"""Test-support instrumentation shipped with the library (the counterpart
of ``tuplewise_tpu.testing``).

Production code imports nothing from here unless a chaos injector is
explicitly passed in; the hook points are no-ops when no injector is
attached, so this package costs the hot path nothing.
"""

from tuplewise_tpu_torch.testing.chaos import (
    FaultInjector,
    InjectedDeviceError,
    InjectedFault,
)

__all__ = ["FaultInjector", "InjectedDeviceError", "InjectedFault"]
