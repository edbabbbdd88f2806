"""Unified serving observability: metrics registry, per-request span
recorder, Chrome-trace exporter (copied from the JAX package, whose
obs/README.md catalogs the metrics and the trace event schema).

Zero dependencies and host-scalars-only by design: the tick loop records
here without ever forcing a device->host sync.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (TERMINAL_EVENTS, TraceRecorder,
                                   chrome_trace, save_chrome_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Observability", "TraceRecorder", "TERMINAL_EVENTS",
           "chrome_trace", "save_chrome_trace"]


class Observability:
    """The pair a `ServingPipeline` records into: a metrics registry
    (always present; pass ``MetricsRegistry(enabled=False)`` for a
    no-op one) and an optional trace recorder (``None`` = tracing off,
    which costs the tick loop nothing)."""

    def __init__(self, metrics: "MetricsRegistry" = None,
                 trace: "TraceRecorder" = None) -> None:
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = trace

    @classmethod
    def with_trace(cls, max_events: int = None) -> "Observability":
        rec = TraceRecorder() if max_events is None \
            else TraceRecorder(max_events=max_events)
        return cls(trace=rec)
