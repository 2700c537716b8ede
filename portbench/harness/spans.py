"""The program's spans read against a traced segment's device trace.

A span here is any object with `name`, `start_ns`, `end_ns` (the wall
clock the profiler stamps its events with), `parent` (the index of the
enclosing span in the same list, -1 for an outermost one) and `attrs`, as
`repro_torch.obs.trace.recording()` reads them out. The harness imports
nothing of the program: the spans are handed to it.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.harness.trace import Trace


def labelled(trace: Trace, spans: Sequence) -> Trace:
    """The trace with the program's spans among its host ranges: its
    `idle_gaps` then label each gap by the innermost span, the program's
    or the benchmark's, open when the gap began."""
    return Trace(trace.ops, trace.host + [(s.name, s.start_ns, s.end_ns) for s in spans],
                 trace.window_s)


def idle_s(trace: Trace, intervals: Sequence[Tuple[int, int]]) -> float:
    """Seconds inside `intervals` (disjoint, in ns) with no operation on
    the device."""
    busy = trace.busy
    starts = [a for a, _ in busy]
    idle = 0
    for a, b in intervals:
        covered = 0
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(busy) and busy[j][0] < b:
            covered += max(0, min(b, busy[j][1]) - max(a, busy[j][0]))
            j += 1
        idle += (b - a) - covered
    return idle / 1e9


def _named(spans: Sequence, name: str) -> List[Tuple[int, int]]:
    return [(s.start_ns, s.end_ns) for s in spans if s.name == name]


def host_ms(spans: Sequence, name: str) -> Optional[float]:
    """Mean duration of the spans named `name`, in ms: the host's time in
    that block (it enqueues; it waits only where the program reads a
    device value)."""
    iv = _named(spans, name)
    return statistics.fmean(b - a for a, b in iv) / 1e6 if iv else None


def idle_ms_per_span(trace: Trace, spans: Sequence, name: str) -> Optional[float]:
    """The device's idle time inside the spans named `name`, summed over
    the segment, over their number, in ms."""
    iv = _named(spans, name)
    return 1e3 * idle_s(trace, iv) / len(iv) if iv else None


def child_idle_share(trace: Trace, spans: Sequence, name: str) -> Optional[float]:
    """Of the device's idle time inside the spans named `name`, the share
    that falls inside one of their direct children."""
    parents = {i for i, s in enumerate(spans) if s.name == name}
    total = idle_s(trace, [(spans[i].start_ns, spans[i].end_ns) for i in sorted(parents)])
    if not parents or total <= 0:
        return None
    inner = [(s.start_ns, s.end_ns) for s in spans if s.parent in parents]
    return idle_s(trace, inner) / total


def host_ms_by_name(spans: Sequence) -> Dict[str, List[float]]:
    """Each span name's [count, mean ms, total ms]."""
    by: Dict[str, List[int]] = {}
    for s in spans:
        by.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    return {k: [len(v), statistics.fmean(v) / 1e6, sum(v) / 1e6] for k, v in sorted(by.items())}
