"""Pluggable execution-backend registry; port of repro.dispatch.registry
(registration, capability checks, selection by priority and device, and
the process-local quarantine that selection skips, which the serving
engine's NaN guard and watchdog escalation fill).

A backend's ``run`` has the signature::

    run(spec, plan, params, x, *, k, epilogue=None, bias=None,
        residual=None) -> y

with ``x (..., k)`` row-major activations and ``y (..., m)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.spec import QuantSpec


def _always(device_type: str) -> bool:
    return True


def _no_epilogue(epilogue) -> bool:
    """Default: fuse nothing (``execute`` applies the epilogue after run)."""
    return False


@dataclass(frozen=True)
class Backend:
    """A registered execution path with its capability envelope."""

    name: str
    modes: tuple[str, ...]
    run: Callable
    is_available: Callable[[str], bool] = _always  # device type -> bool
    priority: int = 0
    d_range: tuple[int, int] = (1, 4)
    storages: tuple[str, ...] = ("packed_idx", "packed_u8")
    codebooks: tuple[str, ...] = ("none", "learned")
    tunable: tuple[str, ...] = ()  # tile fields the autotuner explores
    epilogue_ok: Callable = _no_epilogue
    description: str = ""

    def supports(self, spec: QuantSpec, d: int) -> bool:
        """Can this backend execute weights described by ``spec`` at depth d?"""
        return (spec.mode in self.modes and spec.storage in self.storages
                and spec.codebook in self.codebooks
                and (spec.mode != "msgemm"
                     or self.d_range[0] <= d <= self.d_range[1]))


_REGISTRY: dict[str, Backend] = {}

# Runtime quarantine: backend name -> reason.  A quarantined backend is
# skipped by auto-selection and by forced-policy resolution, so a
# misbehaving path degrades to the next backend instead of crashing the
# server.  Process-local, never persisted, cleared by clear_quarantine().
_QUARANTINED: dict[str, str] = {}


def _quarantine_changed() -> None:
    from repro_torch.dispatch.plan import invalidate

    invalidate()  # resolved plans depend on the quarantine
    obs.registry().gauge("dispatch_backends_quarantined").set(
        len(_QUARANTINED))


def quarantine_backend(name: str, reason: str = "") -> None:
    """Mark a backend suspect; selection skips it until cleared (unless
    that would leave a spec with no candidate: see available_backends)."""
    get_backend(name)  # raise on unknown names
    _QUARANTINED[name] = reason or "quarantined"
    obs.registry().counter(
        "dispatch_backend_quarantined_total", backend=name).inc()
    _quarantine_changed()


def clear_quarantine(name: str | None = None) -> None:
    """Lift quarantine for one backend, or all when name is None."""
    if name is None:
        _QUARANTINED.clear()
    else:
        _QUARANTINED.pop(name, None)
    _quarantine_changed()


def is_quarantined(name: str) -> bool:
    return name in _QUARANTINED


def quarantined() -> dict[str, str]:
    """Snapshot of the current quarantine list (name -> reason)."""
    return dict(_QUARANTINED)


def register_backend(name: str, *, modes, run, is_available=_always,
                     priority: int = 0, d_range=(1, 4),
                     storages=("packed_idx", "packed_u8"),
                     codebooks=("none", "learned"), tunable=(),
                     epilogue_ok=_no_epilogue,
                     description: str = "", overwrite: bool = False) -> Backend:
    """Register an execution backend; duplicate names raise unless
    ``overwrite``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered; "
                         "pass overwrite=True to replace it")
    be = Backend(name=name, modes=tuple(modes), run=run,
                 is_available=is_available, priority=priority,
                 d_range=tuple(d_range), storages=tuple(storages),
                 codebooks=tuple(codebooks), tunable=tuple(tunable),
                 epilogue_ok=epilogue_ok, description=description)
    _REGISTRY[name] = be
    return be


def unregister_backend(name: str) -> None:
    """Drop a backend (a no-op for unknown names)."""
    _REGISTRY.pop(name, None)
    _QUARANTINED.pop(name, None)
    _quarantine_changed()


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def backend_names() -> list[str]:
    return sorted(_REGISTRY)


def device_kind() -> str:
    """The device type auto-selection keys on when none is given: ``cuda``
    where a card is present, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def available_backends(spec: QuantSpec, d: int,
                       device_type: str | None = None) -> list[Backend]:
    """Backends that can run ``spec`` on ``device_type`` (default
    :func:`device_kind`), best first (priority descending, then name)."""
    device_type = device_type or device_kind()
    cands = [b for b in _REGISTRY.values()
             if b.supports(spec, d) and b.is_available(device_type)]
    if _QUARANTINED:
        # never quarantine into an empty candidate set: serving a suspect
        # backend beats serving nothing
        cands = [b for b in cands if b.name not in _QUARANTINED] or cands
    return sorted(cands, key=lambda b: (-b.priority, b.name))


def select_backend(spec: QuantSpec, d: int, device_type: str | None = None
                   ) -> Backend:
    """Deterministic auto-selection: the highest-priority capable backend."""
    device_type = device_type or device_kind()
    cands = available_backends(spec, d, device_type)
    if not cands:
        raise ValueError(
            f"no backend can execute mode={spec.mode!r} d={d} "
            f"storage={spec.storage!r} codebook={spec.codebook!r} on "
            f"{device_type!r}; registered: {backend_names()}")
    return cands[0]
