"""Deterministic, seeded fault plans; a copy of repro.faults.plan (numpy
RNG, so both packages draw the same decision streams for one spec and
seed).

A :class:`FaultPlan` is a schedule of fault *classes* (``CLASSES``),
each with a per-opportunity probability, an opportunity offset, a fire
budget, and a class-specific magnitude.  Every injection site in the
stack calls ``faults.fire("<class>")`` at its opportunity point; the
plan answers with a :class:`FaultEvent` (fire) or ``None`` (pass).

Determinism contract: the decision stream per class is a function of
``(seed, class)`` and the opportunity index only — two runs of the same
workload under the same plan inject the exact same faults at the exact
same points, which is what lets the chaos benchmark assert token
identity of everything the faults did not touch.

Spec strings (CLI ``--faults`` / env ``REPRO_FAULTS``)::

    all                               # every class, default knobs
    nan_logits                        # one class, default knobs
    step_fail:p=0.5,after=2,max=3     # per-class overrides
    oom:p=0.2;disconnect:max=1        # ';'-separated multi-class

Knobs: ``p`` (probability per opportunity), ``after`` (skip the first N
opportunities), ``max`` (total fire budget; 0 = unbounded), ``mag``
(class magnitude — sleep seconds for latency/hang).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np

# The fault taxonomy.  Each class maps to exactly one injection site
# (see README §Resilience for the site/recovery table).
CLASSES = (
    "latency",             # engine step-latency spike (sleep)
    "oom",                 # BlockPool.alloc artificially exhausted
    "nan_logits",          # non-finite logits row after a step
    "step_fail",           # transient host-side step failure (raises)
    "hang",                # step stalls past the watchdog hang timer
    "disconnect",          # mid-stream client disconnect of a live seq
    "corrupt_plan_cache",  # garbage written over the plan-cache JSON
    "corrupt_calibration", # garbage written over calibration.json
    "corrupt_checkpoint",  # garbage written over a checkpoint manifest
)

# per-class default knobs: (p, after, max_fires, magnitude)
_DEFAULTS = {
    "latency": (0.25, 2, 4, 0.05),
    "oom": (0.25, 1, 4, 0.0),
    "nan_logits": (0.5, 3, 1, 0.0),
    "step_fail": (0.5, 1, 2, 0.0),
    "hang": (1.0, 4, 1, 0.25),
    "disconnect": (0.5, 4, 1, 0.0),
    "corrupt_plan_cache": (1.0, 0, 1, 0.0),
    "corrupt_calibration": (1.0, 0, 1, 0.0),
    "corrupt_checkpoint": (1.0, 0, 1, 0.0),
}


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault class with its schedule knobs."""

    cls: str
    p: float = 1.0          # fire probability per opportunity
    after: int = 0          # opportunities to skip before the first roll
    max_fires: int = 1      # total budget (0 = unbounded)
    magnitude: float = 0.0  # class-specific size (sleep seconds, ...)

    def __post_init__(self):
        if self.cls not in CLASSES:
            raise ValueError(
                f"unknown fault class {self.cls!r}; known: {CLASSES}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p={self.p} outside [0, 1]")
        if self.after < 0 or self.max_fires < 0:
            raise ValueError("after and max must be >= 0")


class FaultEvent(NamedTuple):
    """One fired fault: which class, the nth fire of that class, its
    magnitude, and a per-event RNG for deterministic victim/byte
    choices at the injection site."""

    cls: str
    index: int
    magnitude: float
    rng: np.random.Generator


def default_spec(cls: str) -> FaultSpec:
    if cls not in _DEFAULTS:
        raise ValueError(
            f"unknown fault class {cls!r}; pick from {sorted(CLASSES)}")
    p, after, max_fires, mag = _DEFAULTS[cls]
    return FaultSpec(cls=cls, p=p, after=after, max_fires=max_fires,
                     magnitude=mag)


def parse_spec(text: str) -> list[FaultSpec]:
    """Parse a ``--faults`` spec string into FaultSpecs (see module
    docstring for the grammar)."""
    text = (text or "").strip()
    if not text:
        return []
    if text == "all":
        return [default_spec(c) for c in CLASSES]
    out = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        cls, _, knobs = part.partition(":")
        spec = default_spec(cls.strip())
        for kv in filter(None, (s.strip() for s in knobs.split(","))):
            key, _, val = kv.partition("=")
            key = {"max": "max_fires", "mag": "magnitude"}.get(key, key)
            if key not in ("p", "after", "max_fires", "magnitude"):
                raise ValueError(f"unknown fault knob {kv!r} in {part!r}")
            cast = int if key in ("after", "max_fires") else float
            spec = replace(spec, **{key: cast(val)})
        out.append(spec)
    return out


class FaultPlan:
    """Seeded multi-class fault schedule.  ``fire(cls)`` is the single
    decision point every injection site goes through."""

    def __init__(self, specs, *, seed: int = 0):
        if isinstance(specs, str):
            specs = parse_spec(specs)
        specs = [s if isinstance(s, FaultSpec) else FaultSpec(cls=s)
                 for s in specs]
        dup = [s.cls for s in specs]
        if len(dup) != len(set(dup)):
            raise ValueError(f"duplicate fault classes in plan: {dup}")
        self.seed = int(seed)
        self.specs: dict[str, FaultSpec] = {s.cls: s for s in specs}
        self._opportunities: dict[str, int] = {c: 0 for c in self.specs}
        self._fires: dict[str, int] = {c: 0 for c in self.specs}
        self._rngs = {
            c: np.random.default_rng(
                np.random.SeedSequence([self.seed, CLASSES.index(c)]))
            for c in self.specs}

    # ------------------------------------------------------------ state
    def armed_classes(self) -> tuple[str, ...]:
        return tuple(self.specs)

    def fires(self, cls: str | None = None) -> int:
        if cls is not None:
            return self._fires.get(cls, 0)
        return sum(self._fires.values())

    def exhausted(self) -> bool:
        """True when every armed class has spent its fire budget (an
        unbounded class never exhausts)."""
        return all(s.max_fires and self._fires[c] >= s.max_fires
                   for c, s in self.specs.items())

    # ------------------------------------------------------------- fire
    def fire(self, cls: str) -> FaultEvent | None:
        spec = self.specs.get(cls)
        if spec is None:
            return None
        n = self._opportunities[cls]
        self._opportunities[cls] = n + 1
        if n < spec.after:
            return None
        if spec.max_fires and self._fires[cls] >= spec.max_fires:
            return None
        rng = self._rngs[cls]
        # always draw, so the decision stream depends only on the
        # opportunity index — not on earlier budget exhaustion
        roll = rng.random()
        if roll >= spec.p:
            return None
        idx = self._fires[cls]
        self._fires[cls] = idx + 1
        return FaultEvent(
            cls=cls, index=idx, magnitude=spec.magnitude,
            rng=np.random.default_rng(
                np.random.SeedSequence([self.seed, CLASSES.index(cls),
                                        idx])))

    def describe(self) -> str:
        return ",".join(
            f"{c}(p={s.p:g},after={s.after},max={s.max_fires or 'inf'})"
            for c, s in self.specs.items()) or "<empty>"
