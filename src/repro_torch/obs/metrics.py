"""Zero-dependency metrics registry: counters, gauges, bounded histograms.

(The port's own copy of ``repro.obs.metrics``.)  Telemetry lives as
integer attributes scattered across the stack — round and pass counts on
the server, queue depth, slot residency, quarantine history on the engine.
:class:`MetricsRegistry` is the one place they all surface:

* **Counter** — monotone count (``inc``);
* **Gauge** — instantaneous value (``set``), or a *pull* gauge built with
  ``fn=`` whose value is read from a callback at export time — the
  mechanism the server uses to absorb the existing scattered attributes
  without adding a single write to any hot path;
* **Histogram** — bounded fixed-bucket distribution (``observe``), with
  cumulative Prometheus semantics in the text exposition.

Exports: :meth:`MetricsRegistry.snapshot` (plain JSON-able dict — the
``OLAWorkloadServer.metrics_snapshot()`` payload) and
:meth:`MetricsRegistry.to_prometheus` (text exposition format, scrapeable
by anything Prometheus-compatible).  No third-party imports anywhere.

Instruments are identified by ``(name, labels)``: registering the same
identity twice returns the existing instrument (idempotent — safe to call
from ``__init__`` paths that may run more than once).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence


def _fmt_value(v: float) -> str:
    """Prometheus float formatting: integers render without the dot."""
    f = float(v)
    if math.isfinite(f) and f == int(f) and abs(f) < 1e15:
        return str(int(f))
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotone counter.  ``inc`` only; negative increments are rejected
    (a counter that can go down is a gauge)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n

    def get(self) -> float:
        return self.value


class Gauge:
    """Instantaneous value.  With ``fn`` the gauge is *pull-based*: its
    value is whatever the callback returns at read time — the adapter that
    lets the registry absorb pre-existing counters (prefetcher attributes,
    rollup tallies) with zero hot-path writes.  A callback that raises is
    reported as NaN rather than poisoning the whole export."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.fn = fn
        self._value = 0.0

    def set(self, v: float) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is pull-based (fn=...)")
        self._value = float(v)

    def get(self) -> float:
        if self.fn is None:
            return self._value
        try:
            return float(self.fn())
        except Exception:
            return float("nan")


class Histogram:
    """Bounded fixed-bucket histogram: ``bounds`` are the upper edges of
    the finite buckets (ascending); everything above the last bound lands
    in the implicit +Inf bucket.  Memory is O(len(bounds)) forever —
    bounded by construction, never by sampling."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Sequence[float] = (),
                 labels: Optional[dict] = None):
        bs = tuple(float(b) for b in bounds)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             f"ascending, got {bs}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = bs
        self.counts = [0] * (len(bs) + 1)   # last = +Inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = len(self.bounds)
        for k, b in enumerate(self.bounds):
            if v <= b:
                i = k
                break
        self.counts[i] += 1
        self.total += 1
        self.sum += v

    def get(self) -> dict:
        return {"buckets": {(_fmt_value(b)): c for b, c in
                            zip(self.bounds, self.counts)},
                "overflow": self.counts[-1],
                "count": self.total, "sum": self.sum}


#: Default latency buckets (modeled seconds): spans the smoke workloads'
#: sub-millisecond tier-1 answers up through multi-scan residencies.
LATENCY_BUCKETS_S = (1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                     3.0, 10.0, 30.0)


class MetricsRegistry:
    """Instrument factory + exporter (see module docstring)."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}

    def __len__(self) -> int:
        return len(self._metrics)

    def _get_or_make(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"{name}{_label_str(dict(labels or {}))} already "
                    f"registered as {type(m).__name__}")
            return m
        m = cls(name, help=help, labels=labels, **kw)
        self._metrics[key] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_make(Gauge, name, help, labels, fn=fn)
        if fn is not None:
            g.fn = fn   # re-binding a pull gauge retargets the callback
        return g

    def histogram(self, name: str, help: str = "",
                  bounds: Sequence[float] = LATENCY_BUCKETS_S,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 bounds=bounds)

    def unregister(self, name: str, labels: Optional[dict] = None) -> bool:
        """Drop one instrument (e.g. a pull gauge whose source object is
        being replaced); True when something was removed."""
        key = (name, tuple(sorted((labels or {}).items())))
        return self._metrics.pop(key, None) is not None

    # ----------------------------------------------------------- export ----
    def snapshot(self) -> dict:
        """JSON-able snapshot: ``{name[.labels]: value}`` for counters and
        gauges, the bucket dict for histograms.  Pull gauges are evaluated
        here — this is the moment scattered source counters are read."""
        out = {}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _label_str(dict(labels))
            out[key] = m.get()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4), dependency-free."""
        by_name: dict[str, list] = {}
        for (_, _), m in sorted(self._metrics.items()):
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name, ms in by_name.items():
            m0 = ms[0]
            if m0.help:
                lines.append(f"# HELP {name} {m0.help}")
            lines.append(f"# TYPE {name} {m0.kind}")
            for m in ms:
                ls = _label_str(m.labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.bounds, m.counts):
                        cum += c
                        le = dict(m.labels, le=_fmt_value(b))
                        lines.append(f"{name}_bucket{_label_str(le)} {cum}")
                    le = dict(m.labels, le="+Inf")
                    lines.append(
                        f"{name}_bucket{_label_str(le)} {m.total}")
                    lines.append(f"{name}_sum{ls} {_fmt_value(m.sum)}")
                    lines.append(f"{name}_count{ls} {m.total}")
                else:
                    lines.append(f"{name}{ls} {_fmt_value(m.get())}")
        return "\n".join(lines) + ("\n" if lines else "")
