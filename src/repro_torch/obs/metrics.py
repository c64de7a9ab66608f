"""Counters, gauges and histograms with a versioned JSON snapshot and a
Prometheus text exposition; port of repro.obs.metrics (pure Python, so a
copy: the port imports nothing of the JAX package).

Every layer of the port records into one process-wide :class:`Registry`
(the serving engine and scheduler, dispatch, the device marks of
``repro_torch.obs.trace``), and every surface (``launch/serve
--metrics-json/--prom-port``, tests) reads the same snapshot format back
out.  The snapshot layout and ``SNAPSHOT_SCHEMA_VERSION`` are the
reference's, so a snapshot of either package validates under both
packages' :func:`validate_snapshot`.

* **Near-zero overhead.**  Recording is a Python attribute bump; no
  formatting until export.  Nothing here touches the device.
* **Accurate serving percentiles.**  Histograms keep a bounded reservoir
  of raw samples (default 8192) beside fixed buckets, so p50/p95/p99 in
  snapshots come from real samples; the buckets feed the Prometheus
  export only.
"""

from __future__ import annotations

import bisect
import json
import random
import threading
import time
from dataclasses import dataclass, field

SNAPSHOT_SCHEMA_VERSION = 1

# latency-oriented default buckets (seconds): 100us .. 60s, roughly x3
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                   3.0, 10.0, 30.0, 60.0)

RESERVOIR_CAP = 8192


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


@dataclass
class Counter:
    """Monotonic counter (float; ``inc`` only)."""

    name: str
    labels: dict = field(default_factory=dict)
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self.value}


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    labels: dict = field(default_factory=dict)
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def as_dict(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self.value}


class Histogram:
    """Fixed buckets for the Prometheus export + a bounded reservoir of
    raw samples for accurate snapshot percentiles.

    Reservoir policy: the first ``RESERVOIR_CAP`` samples are kept
    verbatim; past that, classic Algorithm-R replacement keeps the kept
    set a uniform sample of everything observed.  count/sum/min/max are
    exact regardless.
    """

    def __init__(self, name: str, labels: dict | None = None,
                 help: str = "", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list[float] = []
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
            if len(self._samples) < RESERVOIR_CAP:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_CAP:
                    self._samples[j] = v

    def percentile(self, q: float) -> float | None:
        """q in [0, 100]; ``None`` when the reservoir is empty (never
        raises — a snapshot taken before any observation reports null
        percentiles rather than a fabricated 0.0, and serving summaries
        with 0 or 1 samples must stay well-formed).  Callers that need
        a number coalesce: ``h.percentile(50) or 0.0``."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return None
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    def as_dict(self) -> dict:
        cum = 0
        buckets = {}
        for le, n in zip(self.buckets, self._bucket_counts):
            cum += n
            buckets[f"{le:g}"] = cum
        buckets["+Inf"] = self.count
        return {"name": self.name, "labels": dict(self.labels),
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                # null (not 0.0) before the first observation — see
                # percentile(); validate_snapshot accepts both
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p95": self.percentile(95), "p99": self.percentile(99),
                "buckets": buckets}


class Registry:
    """Process-wide series store: get-or-create by (kind, name, labels)."""

    def __init__(self):
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, cls, name: str, help: str, labels: dict,
             **kw):
        key = (kind, name, _labels_key(labels))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    s = cls(name, labels=labels, help=help, **kw) \
                        if cls is Histogram else cls(name=name,
                                                    labels=labels, help=help)
                    self._series[key] = s
        return s

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, help, labels,
                         buckets=buckets)

    # ------------------------------------------------------------ views
    def series(self, kind: str | None = None) -> list:
        return [s for (k, _, _), s in sorted(self._series.items(),
                                             key=lambda kv: kv[0])
                if kind is None or k == kind]

    def value(self, kind: str, name: str, **labels) -> float | None:
        """Current value of one series, or None if never created (tests
        and benchmark emitters read through this)."""
        s = self._series.get((kind, name, _labels_key(labels)))
        if s is None:
            return None
        return s.count if kind == "histogram" else s.value

    def reset(self, prefix: str | None = None) -> None:
        """Drop every series, or only those whose name starts with
        ``prefix`` (e.g. ``reset(prefix="serving_")`` after a warmup
        stream, leaving dispatch/kernel series intact)."""
        with self._lock:
            if prefix is None:
                self._series.clear()
            else:
                for key in [k for k in self._series
                            if k[1].startswith(prefix)]:
                    del self._series[key]

    # ---------------------------------------------------------- exports
    def snapshot(self, extra: dict | None = None) -> dict:
        """Versioned, JSON-able view of every series.  ``extra`` merges
        free-form context (engine config, benchmark args) under its own
        key so the series schema stays stable."""
        out = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "created_unix": time.time(),
            "counters": [s.as_dict() for s in self.series("counter")],
            "gauges": [s.as_dict() for s in self.series("gauge")],
            "histograms": [s.as_dict() for s in self.series("histogram")],
        }
        if extra:
            out["context"] = extra
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        lines: list[str] = []

        def fmt_labels(labels: dict, extra: dict | None = None) -> str:
            items = {**labels, **(extra or {})}
            if not items:
                return ""
            body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
            return "{" + body + "}"

        seen_meta: set[tuple[str, str]] = set()

        def meta(name: str, kind: str, help: str):
            if (name, kind) in seen_meta:
                return
            seen_meta.add((name, kind))
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        for s in self.series("counter"):
            meta(s.name, "counter", s.help)
            lines.append(f"{s.name}{fmt_labels(s.labels)} {s.value:g}")
        for s in self.series("gauge"):
            meta(s.name, "gauge", s.help)
            lines.append(f"{s.name}{fmt_labels(s.labels)} {s.value:g}")
        for s in self.series("histogram"):
            meta(s.name, "histogram", s.help)
            d = s.as_dict()
            for le, n in d["buckets"].items():
                lines.append(f"{s.name}_bucket"
                             f"{fmt_labels(s.labels, {'le': le})} {n}")
            lines.append(f"{s.name}_sum{fmt_labels(s.labels)} {d['sum']:g}")
            lines.append(f"{s.name}_count{fmt_labels(s.labels)} "
                         f"{d['count']}")
        return "\n".join(lines) + "\n"


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide default registry."""
    return _REGISTRY


# ------------------------------------------------------------ validation
def validate_snapshot(doc: dict) -> list[str]:
    """Schema check for a ``Registry.snapshot()`` document.  Returns a
    list of problems (empty == valid) — CI asserts emptiness rather than
    parsing exceptions."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["snapshot is not an object"]
    if doc.get("schema_version") != SNAPSHOT_SCHEMA_VERSION:
        errs.append(f"schema_version={doc.get('schema_version')!r} != "
                    f"{SNAPSHOT_SCHEMA_VERSION}")
    for kind, req in (("counters", ("name", "labels", "value")),
                      ("gauges", ("name", "labels", "value")),
                      ("histograms", ("name", "labels", "count", "sum",
                                      "p50", "p95", "buckets"))):
        rows = doc.get(kind)
        if not isinstance(rows, list):
            errs.append(f"{kind} missing or not a list")
            continue
        for i, row in enumerate(rows):
            if not isinstance(row, dict):
                errs.append(f"{kind}[{i}] not an object")
                continue
            for f in req:
                if f not in row:
                    errs.append(f"{kind}[{i}] ({row.get('name')}) "
                                f"missing {f!r}")
            if not isinstance(row.get("labels", {}), dict):
                errs.append(f"{kind}[{i}] labels not an object")
            if kind == "histograms":
                # percentiles are numbers, or null for an empty series
                # (a snapshot taken before any observation)
                for f in ("p50", "p90", "p95", "p99"):
                    if f in row and not isinstance(
                            row[f], (int, float, type(None))):
                        errs.append(f"{kind}[{i}] ({row.get('name')}) "
                                    f"{f} is {type(row[f]).__name__}, "
                                    "expected number or null")
                if row.get("count") and row.get("p50") is None:
                    errs.append(f"{kind}[{i}] ({row.get('name')}) has "
                                "observations but null p50")
    return errs


def validate_snapshot_file(path) -> list[str]:
    try:
        doc = json.loads(open(path).read())
    except (OSError, ValueError) as e:
        return [f"unreadable snapshot {path}: {e}"]
    return validate_snapshot(doc)


# ---------------------------------------------------------- prom endpoint
def serve_prometheus(port: int, reg: Registry | None = None):
    """Expose ``reg`` at http://0.0.0.0:port/metrics from a daemon
    thread.  Returns the server (call ``.shutdown()`` to stop; tests
    bind port 0 and read ``server.server_address``)."""
    import http.server

    reg = reg or registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = reg.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="obs-prometheus")
    t.start()
    return server
