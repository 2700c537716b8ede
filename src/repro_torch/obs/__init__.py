"""Telemetry used by the port's serving path: clocks and metrics.

A copy of the part of `repro.obs` this slice needs. `clock` is the
sanctioned time source for `router/` and `index/` (the `obs-discipline`
lint rule), and `MetricsRegistry` holds the gateway's and the index
manager's counters and histograms (`route_phase_ms{phase=}`,
`route_batch_ms`, `index_served_total{path=}`, ...). Tracing, the event
bus and the quality monitor are not ported yet.
"""
from repro_torch.obs import clock
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    LogHistogram,
    MetricsRegistry,
    get_registry,
)

__all__ = [
    "clock",
    "Counter",
    "Gauge",
    "LogHistogram",
    "MetricsRegistry",
    "get_registry",
]
