"""Fault injection facade (zero overhead when off); port of repro.faults.

Mirrors the ``obs.trace`` contract: when no plan is armed, every
injection site is a single ``None`` check — nothing is drawn, counted,
or recorded, and ``faults_armed`` stays 0.

Usage::

    import repro_torch.faults as faults

    faults.arm("step_fail:p=0.5,max=2", seed=0)
    ...
    ev = faults.fire("step_fail")     # FaultEvent | None
    if ev is not None:
        raise InjectedFault("step_fail", ev)
    ...
    faults.disarm()

Injection sites and the components that recover from them are listed in
README §Resilience (the port's sites: its "PyTorch/CUDA port"
section).  ``plan_from_env()`` arms from ``REPRO_FAULTS`` /
``REPRO_FAULT_SEED`` so any entry point (CLI, benchmark, test) can be
chaos-tested without code changes.
"""

from __future__ import annotations

import os

from repro_torch import obs
from repro_torch.faults.plan import (
    CLASSES,
    FaultEvent,
    FaultPlan,
    FaultSpec,
    default_spec,
    parse_spec,
)

__all__ = [
    "CLASSES",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "active",
    "arm",
    "corrupt_file",
    "default_spec",
    "disarm",
    "fire",
    "parse_spec",
    "plan_from_env",
]

_PLAN: FaultPlan | None = None


class InjectedFault(RuntimeError):
    """Raised by injection sites whose fault class is "this call
    fails".  Recovery paths treat it exactly like the organic error it
    models, but tests can assert on the class."""

    def __init__(self, cls: str, event: FaultEvent):
        super().__init__(f"injected fault: {cls} (fire #{event.index})")
        self.cls = cls
        self.event = event


def arm(plan, *, seed: int = 0) -> FaultPlan:
    """Arm a fault plan process-wide.  ``plan`` is a FaultPlan, a spec
    string (``"all"``, ``"oom:p=0.3;hang"``), or a list of FaultSpecs."""
    global _PLAN
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan, seed=seed)
    _PLAN = plan
    obs.registry().gauge("faults_armed").set(len(plan.specs))
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None
    obs.registry().gauge("faults_armed").set(0)


def active() -> FaultPlan | None:
    return _PLAN


def fire(cls: str) -> FaultEvent | None:
    """The hot-path check.  One attribute load + None test when
    disarmed; when armed, ask the plan and count any fire."""
    plan = _PLAN
    if plan is None:
        return None
    ev = plan.fire(cls)
    if ev is not None:
        obs.registry().counter("faults_injected_total", cls=cls).inc()
    return ev


def plan_from_env() -> FaultPlan | None:
    """Arm from ``REPRO_FAULTS`` / ``REPRO_FAULT_SEED`` if set; returns
    the armed plan or None.  A no-op when the variable is unset, so
    importing callers stay zero-overhead by default."""
    spec = os.environ.get("REPRO_FAULTS", "").strip()
    if not spec:
        return None
    seed = int(os.environ.get("REPRO_FAULT_SEED", "0"))
    return arm(spec, seed=seed)


def corrupt_file(path, event: FaultEvent) -> bool:
    """Deterministically corrupt an artifact file in place (used by the
    ``corrupt_*`` classes).  Truncates to a prefix and appends garbage
    bytes drawn from the event RNG, guaranteeing the result is neither
    valid JSON nor CRC-consistent.  Returns False if the file does not
    exist."""
    path = os.fspath(path)
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    keep = int(event.rng.integers(0, max(1, len(data) // 2)))
    junk = event.rng.integers(0, 256, size=16, dtype="uint8").tobytes()
    with open(path, "wb") as f:
        f.write(data[:keep] + b"\x00{corrupt" + junk)
    return True
