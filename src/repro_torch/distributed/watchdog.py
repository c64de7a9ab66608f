"""Straggler / hang detection; port of repro.distributed.watchdog (the
serving engine times its steps with it, the training driver will).

On multi-host TPU fleets the common failure modes are (a) a host that
stops making progress (hang) and (b) a slow host stretching every step
(straggler).  Without real multi-host telemetry here, the watchdog tracks
wall-clock per step with a rolling mean/std and

* flags steps whose duration z-score exceeds ``z_threshold`` (straggler
  signal -> logged + counted; hook for re-dispatch/drain in production),
* arms a hang timer (``hang_factor`` x rolling mean) that fires a callback
  — the driver uses it to abort + restart from the last checkpoint.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch import obs


@dataclass
class Watchdog:
    window: int = 50
    z_threshold: float = 4.0
    hang_factor: float = 10.0
    min_steps: int = 5
    # floor on the hang timeout: mean*hang_factor can be microseconds on
    # tiny models, which would fire on any GC pause.  Serving (and fast
    # tests) lower it deliberately.
    min_timeout_s: float = 1.0
    on_straggler: callable = None
    on_hang: callable = None
    _times: deque = field(default_factory=lambda: deque(maxlen=200))
    _timer: threading.Timer | None = None
    straggler_count: int = 0
    hang_count: int = 0

    def _stats(self):
        xs = list(self._times)[-self.window:]
        n = len(xs)
        mean = sum(xs) / n
        var = sum((x - mean) ** 2 for x in xs) / max(n - 1, 1)
        return mean, var**0.5

    def step_started(self):
        self._t0 = time.monotonic()
        if len(self._times) >= self.min_steps:
            mean, _ = self._stats()
            timeout = max(mean * self.hang_factor, self.min_timeout_s)
            self._timer = threading.Timer(timeout, self._hang)
            self._timer.daemon = True
            self._timer.start()

    def _hang(self):
        self.hang_count += 1
        obs.registry().counter(
            "watchdog_hangs_total",
            help="hang-timer firings (step exceeded hang_factor x mean)"
        ).inc()
        obs.tracer().instant("watchdog.hang", cat="watchdog",
                             hang_count=self.hang_count)
        if self.on_hang:
            self.on_hang()

    def step_finished(self) -> dict:
        dt = time.monotonic() - self._t0
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        info = {"step_time": dt, "straggler": False}
        if len(self._times) >= self.min_steps:
            mean, std = self._stats()
            if std > 0 and (dt - mean) / std > self.z_threshold:
                self.straggler_count += 1
                info["straggler"] = True
                obs.registry().counter(
                    "watchdog_stragglers_total",
                    help="steps whose z-score exceeded the threshold"
                ).inc()
                obs.tracer().instant("watchdog.straggler", cat="watchdog",
                                     step_time=dt, mean=mean, std=std)
                if self.on_straggler:
                    self.on_straggler(dt, mean, std)
        self._times.append(dt)
        return info
