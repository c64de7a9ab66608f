"""Observability layer: metrics registry and structured tracer; port of
repro.obs (its ``costs``, ``perfmodel``, ``artifacts`` and ``__main__``
wait for the plan-layer slice).

One import surface for the rest of the port::

    from repro_torch import obs

    obs.registry().counter("serving_requests_submitted_total").inc()
    with obs.tracer().span("engine.decode_step", cat="serving"):
        ...
    y = obs.mark_end(backend.run(...), "gemm", cat="gemm")

Everything is off by default and near-free when off: counters are
attribute bumps, ``tracer().span`` returns a shared no-op context
manager, and :func:`mark_begin`/:func:`mark_end` (the counterpart of the
reference's ``jit_begin``/``jit_end``: CUDA events, recorded into a CUDA
graph when staged at its capture) stage nothing unless tracing is on.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Registry,
    SNAPSHOT_SCHEMA_VERSION,
    registry,
    serve_prometheus,
    validate_snapshot,
    validate_snapshot_file,
)
from repro_torch.obs.trace import (  # noqa: F401
    TRACE_SCHEMA_VERSION,
    Tracer,
    disable_tracing,
    enable_tracing,
    mark_begin,
    mark_end,
    tracer,
    validate_trace,
    validate_trace_file,
)

__all__ = [
    "Registry", "registry", "serve_prometheus",
    "validate_snapshot", "validate_snapshot_file",
    "SNAPSHOT_SCHEMA_VERSION",
    "Tracer", "tracer", "enable_tracing", "disable_tracing",
    "mark_begin", "mark_end",
    "validate_trace", "validate_trace_file", "TRACE_SCHEMA_VERSION",
]
