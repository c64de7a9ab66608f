"""Observability layer: metrics registry, structured tracer, cost model,
perf model and artifact integrity; port of repro.obs.

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

from repro_torch.obs import costs  # noqa: F401,E402  (re-export module)
from repro_torch.obs import perfmodel  # noqa: F401,E402  (re-export module)


def __getattr__(name):
    # lazy: obs.artifacts imports repro_torch.obs back for the registry, so
    # a top-level import here would be circular
    if name == "artifacts":
        import importlib
        return importlib.import_module("repro_torch.obs.artifacts")
    raise AttributeError(name)


__all__ = [
    "Registry", "registry", "serve_prometheus",
    "validate_snapshot", "validate_snapshot_file",
    "SNAPSHOT_SCHEMA_VERSION",
    "Tracer", "tracer", "enable_tracing", "disable_tracing",
    "mark_begin", "mark_end",
    "validate_trace", "validate_trace_file", "TRACE_SCHEMA_VERSION",
    "costs", "perfmodel",
]
