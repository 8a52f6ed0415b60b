"""Observability of the serving path: the parts the single-tenant engine
and ``replay`` use.

* ``tracing.maybe_span``    — the guard every instrumented call site
                              uses; span tracing itself (``Tracer``) is
                              not ported yet, so a tracer must be None.
* ``flight.FlightRecorder`` — a bounded ring of lifecycle events
                              (compactions, restarts, poison rejects,
                              deadline expiries), dumped as JSONL.
* ``ledger.WaveLedger``     — the host-tax split of every insert
                              micro-batch into queue wait, lock wait,
                              host Python, dispatch, device compute,
                              first-use build and GC buckets.
* ``health``                — CI-width tracking of the streaming
                              estimate and drift against the exact
                              index.
* ``report``                — the functions that build ``replay``'s
                              report.
"""
