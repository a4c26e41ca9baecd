"""Observability: metrics registry, span tracer, per-query explain plane.

The port's own copy of ``repro.obs`` (zero third-party dependencies): the
port imports nothing of ``repro``, so it carries the modules it needs.
"""

from repro_torch.obs.explain import ExplainRecord, RoundSample
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    SpanTracer,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "ExplainRecord",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "RoundSample",
    "SpanTracer",
    "validate_chrome_trace",
]
