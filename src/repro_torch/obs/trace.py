"""Structured span/event tracer emitting Chrome-trace (Perfetto) JSON; port
of repro.obs.trace.

Two recording surfaces share one event buffer:

* **Host spans** — ``with tracer().span("engine.decode_step"): ...``
  around ordinary Python (the engine loop, the scheduler).  Complete
  ("ph": "X") events with microsecond timestamps on the host lane.
* **Device marks** — :func:`mark_begin` / :func:`mark_end`, the
  counterpart of the reference's jit marks (``jax.debug.callback``\\ s
  staged at trace time).  On CUDA tensors a mark is a
  ``torch.cuda.Event(enable_timing=True)`` recorded on the current
  stream; inside a CUDA graph capture the event is made with
  ``external=True``, so it becomes an event-record node that every replay
  records again.  On CPU tensors a mark is a host timestamp.  Staged pairs
  are resolved by :meth:`Tracer.resolve_marks` after the step has
  synchronised: each becomes an "X" event on the device lane and,
  with ``hist=``, one observation of that registry histogram (e.g.
  ``kernel_gemm_s``).  Device times are placed on the host's time axis
  through an anchor: the host time taken when the step (or replay) began,
  at the first mark's event.

**Nothing is staged while tracing is off**, the reference's contract:
``tracer().enabled`` is read when a mark would be staged — at the call on
the eager route, at capture for a CUDA graph, which plays the role of
JAX's trace time.  With tracing off no event is recorded and
``marks_staged`` stays 0.  So enable tracing *before* building the engine
that captures the step; a graph keeps whatever was staged at its capture
and records it on every replay.

Load the written file at https://ui.perfetto.dev (or chrome://tracing).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import AbstractContextManager

import torch

from repro_torch.obs import metrics

TRACE_SCHEMA_VERSION = 1

# how many device marks were staged since import (tests assert 0 on the
# tracing-off path; the reference's jit_marks_staged)
marks_staged = 0

# Perfetto lane ids: host spans, and device marks (kept apart so device
# events, placed by their own clock, cannot corrupt the host lane's
# nesting)
TID_HOST = 0
TID_DEVICE = 1


class _NullSpan(AbstractContextManager):
    __slots__ = ()

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span(AbstractContextManager):
    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer, name, cat, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer._complete(self.name, self.cat, self.t0,
                              time.perf_counter(), self.args, TID_HOST)
        return False


class Mark:
    """One staged begin/end pair.  ``t0``/``t1`` are CUDA events, or host
    ``perf_counter`` seconds for CPU tensors; ``host_t0`` is the host time
    at which the begin was staged."""

    __slots__ = ("name", "cat", "args", "hist", "labels", "t0", "t1",
                 "host_t0")

    def __init__(self, name, t0, host_t0):
        self.name = name
        self.t0 = t0
        self.host_t0 = host_t0
        self.cat, self.args, self.hist, self.labels, self.t1 = \
            "device", None, None, None, None


class Tracer:
    def __init__(self):
        self.enabled = False
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._open: dict[str, list[Mark]] = {}  # begin marks awaiting an end
        self._staged: list[Mark] = []  # complete pairs awaiting resolution
        self._pid = os.getpid()

    # ----------------------------------------------------------- control
    def enable(self, *, clear: bool = False) -> None:
        if clear:
            self.clear()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._staged.clear()
        self._t0 = time.perf_counter()

    # ----------------------------------------------------------- record
    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _complete(self, name, cat, t0, t1, args, tid) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self._pid,
              "tid": tid, "ts": self._us(t0),
              "dur": max(self._us(t1) - self._us(t0), 0.0)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, cat: str = "host", **args):
        """Context manager recording one complete event (no-op singleton
        when disabled — safe on hot loops)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
              "pid": self._pid, "tid": TID_HOST,
              "ts": self._us(time.perf_counter())}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, **values) -> None:
        """Chrome-trace counter track (ph "C") — e.g. queue depth over
        time next to the spans."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({"name": name, "ph": "C",
                                 "pid": self._pid, "tid": TID_HOST,
                                 "ts": self._us(time.perf_counter()),
                                 "args": values})

    # ------------------------------------------------------ device marks
    def _mark_begin(self, name: str, stamp) -> None:
        mk = Mark(name, stamp, time.perf_counter())
        with self._lock:
            self._open.setdefault(name, []).append(mk)

    def _mark_end(self, name: str, stamp, cat, args, hist, labels) -> None:
        with self._lock:
            stack = self._open.get(name)
            mk = stack.pop() if stack else None
            if mk is None:  # unmatched: degrade to an instant, as the
                # reference does for a reordered callback
                self._events.append({"name": name, "cat": cat, "ph": "i",
                                     "s": "p", "pid": self._pid,
                                     "tid": TID_DEVICE,
                                     "ts": self._us(time.perf_counter())})
                return
            mk.t1, mk.cat, mk.args, mk.hist, mk.labels = \
                stamp, cat, args, hist, labels
            self._staged.append(mk)

    def take_marks(self) -> list[Mark]:
        """The pairs staged since the last call, handed to the caller: an
        eager step resolves them after its sync; a graph keeps those of
        its capture and resolves them after every replay."""
        with self._lock:
            out, self._staged = self._staged, []
        return out

    def resolve_marks(self, marks: list[Mark], host_t0: float | None = None
                      ) -> None:
        """Turn staged pairs into device-lane "X" events (and histogram
        observations).  Device times are offsets from the first mark's
        begin event, placed at ``host_t0`` (default: the host time when
        that begin was staged).  Waits for the last event, so it is safe
        to call before the step synchronised."""
        if not marks:
            return
        first = marks[0]
        base = first.host_t0 if host_t0 is None else host_t0
        on_device = not isinstance(first.t0, float)
        if on_device:
            marks[-1].t1.synchronize()
        reg = metrics.registry()
        for mk in marks:
            if on_device:  # elapsed_time is in milliseconds
                t0 = base + first.t0.elapsed_time(mk.t0) / 1e3
                t1 = t0 + mk.t0.elapsed_time(mk.t1) / 1e3
            else:
                t0, t1 = mk.t0, mk.t1
            self._complete(mk.name, mk.cat, t0, t1, mk.args, TID_DEVICE)
            if mk.hist is not None:
                reg.histogram(mk.hist, **mk.labels).observe(t1 - t0)

    # ------------------------------------------------------------ export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path) -> dict:
        """Resolve any marks still staged, write Chrome-trace JSON
        (Perfetto-loadable) and return the document."""
        self.resolve_marks(self.take_marks())
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "metadata": {"schema_version": TRACE_SCHEMA_VERSION,
                         "producer": "repro_torch.obs",
                         "pid": self._pid},
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc

    @staticmethod
    def load(path) -> dict:
        with open(path) as f:
            return json.load(f)


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enable_tracing(*, clear: bool = False) -> Tracer:
    _TRACER.enable(clear=clear)
    return _TRACER


def disable_tracing() -> None:
    _TRACER.disable()


# ------------------------------------------------------------ device marks
def _stamp(value: torch.Tensor):
    """A timing event recorded on the current stream for a CUDA tensor
    (an event-record node of the graph while a capture is on), else the
    host clock."""
    if value.device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(
        enable_timing=True,
        external=torch.cuda.is_current_stream_capturing())
    ev.record()
    return ev


def mark_begin(value: torch.Tensor, name: str) -> torch.Tensor:
    """Stage a begin mark for ``name`` on ``value``'s device; returns
    ``value`` unchanged.  Nothing is staged while tracing is off."""
    t = _TRACER
    if not t.enabled:
        return value
    global marks_staged
    marks_staged += 1
    t._mark_begin(name, _stamp(value))
    return value


def mark_end(value: torch.Tensor, name: str, cat: str = "device",
             args: dict | None = None, hist: str | None = None,
             hist_labels: dict | None = None) -> torch.Tensor:
    """Stage the matching end mark after ``value`` (the op's output) was
    computed; returns ``value`` unchanged.  With ``hist`` the duration is
    also observed into that registry histogram when the pair resolves."""
    t = _TRACER
    if not t.enabled:
        return value
    global marks_staged
    marks_staged += 1
    t._mark_end(name, _stamp(value), cat, args, hist,
                dict(hist_labels or {}))
    return value


# ------------------------------------------------------------ validation
def validate_trace(doc: dict) -> list[str]:
    """Schema check for a saved trace document (empty list == valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["trace is not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    meta = doc.get("metadata", {})
    if meta.get("schema_version") != TRACE_SCHEMA_VERSION:
        errs.append(f"metadata.schema_version="
                    f"{meta.get('schema_version')!r} != "
                    f"{TRACE_SCHEMA_VERSION}")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}] not an object")
            continue
        for f in ("name", "ph", "ts", "pid", "tid"):
            if f not in ev:
                errs.append(f"traceEvents[{i}] ({ev.get('name')}) "
                            f"missing {f!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            errs.append(f"traceEvents[{i}] complete event missing dur")
    return errs


def validate_trace_file(path) -> list[str]:
    try:
        doc = json.loads(open(path).read())
    except (OSError, ValueError) as e:
        return [f"unreadable trace {path}: {e}"]
    return validate_trace(doc)
