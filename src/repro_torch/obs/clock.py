"""Canonical clocks for the serving/index hot paths.

The `obs-discipline` lint rule forbids `time.time()` / `time.perf_counter()`
/ `time.monotonic()` (and `print()`) inside `router/` and `index/`: phase
timing and deadlines must flow through this module so (a) every recorded
duration uses the same monotonic source — wall-clock steps from NTP slew
would otherwise corrupt latency histograms — and (b) tests and the overhead
benchmark can reason about every timing call site from one file.

Three clocks, three jobs:

* ``perf()`` — high-resolution monotonic, for phase durations
  (``duration_ms`` pairs a start with it);
* ``monotonic()`` — monotonic deadline clock, for timeouts/poll loops;
* ``wall()`` — wall-clock epoch seconds, ONLY for event timestamps that
  leave the process (outcome events, bus events, trace records).

``perf_ns()`` and ``wall_ns()`` are the first and the last in integer
nanoseconds, for the program's spans (`repro_torch.obs.trace.span`).
"""
from __future__ import annotations

import time

__all__ = ["perf", "perf_ns", "monotonic", "wall", "wall_ns", "duration_ms"]

perf = time.perf_counter
perf_ns = time.perf_counter_ns  # a span's stamps: perf()'s clock, whole nanoseconds
monotonic = time.monotonic
wall = time.time
wall_ns = time.time_ns  # the profiler's epoch: spans are read out on it


def duration_ms(t0: float, t1: float | None = None) -> float:
    """Milliseconds elapsed from ``t0`` (a ``perf()`` stamp) to ``t1``/now."""
    return ((perf() if t1 is None else t1) - t0) * 1e3
