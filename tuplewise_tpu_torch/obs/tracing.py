"""The span guard of the serving path's call sites.

The counterpart of ``maybe_span`` in ``tuplewise_tpu.obs.tracing``.
Instrumented call sites hold ``tracer = None`` and pay one ``is None``
check. Span tracing itself (``Tracer``, its JSONL and Chrome exports)
is not ported yet, so any tracer other than None raises.
"""

from __future__ import annotations


class _NullSpan:
    """Shared no-op context manager: the disabled path allocates
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def check_tracer(tracer) -> None:
    """Raise unless ``tracer`` is None (the only tracer this port has)."""
    if tracer is not None:
        raise NotImplementedError(
            "span tracing is not ported to tuplewise_tpu_torch yet; "
            "pass tracer=None")


def maybe_span(tracer, name: str, parent=None, **attrs):
    """A no-op context manager when ``tracer`` is None; any other tracer
    raises (see :func:`check_tracer`)."""
    check_tracer(tracer)
    return _NULL_SPAN
