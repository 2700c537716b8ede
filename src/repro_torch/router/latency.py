"""Latency measurement harness (paper §5.5, Tables 1 & 6).

Measures per-request p50/p99 wall-clock of one serving call at a time,
covering embedding computation, similarity search and any re-ranking —
the paper's protocol.

The percentile math itself lives in `repro_torch.obs.summary` (one
implementation shared by this harness and the tracer);
`LatencyStats`/`percentile_stats` are re-exported here.

Counterpart of `repro/router/latency.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.obs import clock
from repro_torch.obs.summary import LatencyStats, percentile_stats

__all__ = ["LatencyStats", "measure_latency", "percentile_stats"]


def measure_latency(
    serve_one: Callable[[int], object],
    n_requests: int,
    warmup: int = 20,
) -> LatencyStats:
    """Time `serve_one(i)` per request (one at a time — router semantics)."""
    for i in range(min(warmup, n_requests)):
        serve_one(i)
    samples: List[float] = []
    for i in range(n_requests):
        t0 = clock.perf()
        serve_one(i)
        samples.append(clock.duration_ms(t0))
    return percentile_stats(samples)
