"""One percentile-summary implementation for every latency consumer.

`LatencyStats` + `percentile_stats` live here (the telemetry plane is the
layer every plane already reports into) and are re-exported from
`repro_torch.router.latency`. `stats_from_histogram` gives the same
`LatencyStats` shape from a live `LogHistogram`, so offline exact
summaries and serve-time histogram estimates are interchangeable
downstream.

Counterpart of `repro/obs/summary.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

__all__ = ["LatencyStats", "percentile_stats", "stats_from_histogram"]


@dataclasses.dataclass
class LatencyStats:
    p50_ms: float
    p99_ms: float
    mean_ms: float
    n: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "mean_ms": self.mean_ms,
            "n": self.n,
        }


def percentile_stats(samples_ms: Sequence[float]) -> LatencyStats:
    """Exact p50/p99/mean over a sample list (offline benches, harnesses)."""
    arr = np.asarray(samples_ms, dtype=np.float64)
    return LatencyStats(
        p50_ms=float(np.percentile(arr, 50)),
        p99_ms=float(np.percentile(arr, 99)),
        mean_ms=float(arr.mean()),
        n=len(arr),
    )


def stats_from_histogram(hist) -> LatencyStats:
    """`LatencyStats` estimated from a `repro_torch.obs.metrics.LogHistogram`.

    Percentiles are bucket-resolution estimates (exact to within one
    log-spaced bucket width — the tradeoff that makes serve-time recording
    O(1) and bounded); mean is exact (the histogram tracks the true sum).
    """
    return LatencyStats(
        p50_ms=hist.percentile(50.0),
        p99_ms=hist.percentile(99.0),
        mean_ms=hist.mean(),
        n=hist.count(),
    )
