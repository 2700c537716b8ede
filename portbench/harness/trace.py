"""A traced segment: the device's operations from the profiler, and the
benchmark's own host ranges around route, prefill, first token and step.

Only device activity is profiled (CUPTI): recording every host op slows a
host-paced loop by up to half, which would show as idle device time that
the untraced window does not have. The host ranges are taken with the
wall clock the profiler stamps its events with (`time.time_ns`), so an
idle gap can be labelled by what the host was doing. The events are read
from the profiler's raw results, one object an event, without building
its tree of host ops.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


class Trace:
    def __init__(self, device_ops: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]], window_s: float):
        self.ops = sorted(device_ops, key=lambda e: e[1])  # (name, start_ns, end_ns)
        self.host = sorted(host, key=lambda e: e[1])
        self.window_s = window_s
        self.busy = self._union(self.ops)

    @staticmethod
    def _union(ops) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, a, b in ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name contains `part`."""
        return sum(b - a for n, a, b in self.ops if part in n) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            key = name[:96]
            by[key] = by.get(key, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device seconds between operations, summed by the innermost
        host range open when each gap began ("host" where none was)."""
        by: Dict[str, float] = {}
        j, open_ = 0, []
        for (_, end), (start, _) in zip(self.busy, self.busy[1:]):
            while j < len(self.host) and self.host[j][1] <= end:
                open_.append(self.host[j])
                j += 1
            open_ = [h for h in open_ if h[2] > end]
            label = open_[-1][0] if open_ else "host"
            by[label] = by.get(label, 0.0) + (start - end) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Recorder:
    """Host ranges of a traced segment; a no-op when not tracing."""

    def __init__(self, on: bool):
        self.on = on
        self.host: List[Tuple[str, int, int]] = []
        self.trace: Optional[Trace] = None
        self.window_s = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.host.append((name, a, time.time_ns()))


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block's device activity; the Trace is on the recorder
    once the block ends. The block sets `rec.window_s`."""
    rec = Recorder(True)
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        yield rec
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU and not e.is_user_annotation():
            a = e.start_ns()
            ops.append((e.name(), a, a + e.duration_ns()))
    rec.trace = Trace(ops, rec.host, rec.window_s)
