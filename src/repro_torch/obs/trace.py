"""Sampled route tracing: structured per-batch span records for ~1-in-N.

Histograms answer "what is p99"; traces answer "where did *this* slow batch
spend it". The tracer samples ~1-in-N `route_batch` calls (seeded Bernoulli
sampler — deterministic for a given seed and call sequence, so tests and
replayed traffic produce identical trace sets) and records one `RouteTrace`
per sampled batch: phase spans (embed/adapter/score/rerank/assemble with
millisecond durations), the batch size and its power-of-two bucket, the
index path that served it (backend vs exact fallback), and the
(table_version, stage_version) stamp that fully determines the scores.

Traces live in a bounded ring (`dropped` counts evictions) and export as
JSONL — one object per line, streamable — in the format the JAX package's
`repro-obs` report reads.

Counterpart of `repro/obs/trace.py`, copied with only its imports changed (it
imports no JAX); the program's spans below are the port's own.

Program spans
=============

`span(name)` marks a block of the host's work at a layer boundary of the
port's programs (`prefill`, `forward`, the train step, `route_batch`; the
catalog is in `repro_torch.obs`). Recording is off unless a
`recording()` context is open in the process: then `span()` returns one
shared no-op object, after one global check, and allocates nothing. While
recording, each span keeps its name, start, end, the index of the span
that encloses it (`parent`) and of the outermost span open around it
(`root`: the spans of one prefill, one routed batch or one train step
share it), and a few integer attributes (`layer`, `tokens`, `queries`).
Stacks are per thread; a recorder holds at most `capacity` spans and
counts those it drops. Stamps are `clock.perf_ns()`; one offset to
`clock.wall_ns()`, taken as recording starts, puts every span read out on
the epoch the profiler stamps its events with, so a span can be laid over
the device's trace. A span never synchronises, reads no device value and
touches no tensor: it times what the host enqueues, not what the card runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.obs import clock

__all__ = ["RouteTrace", "TraceSampler", "RouteTracer", "Span", "SpanRecorder", "span",
           "record", "recording", "recording_on"]


@dataclasses.dataclass(frozen=True)
class RouteTrace:
    trace_id: int  # tracer-unique, in sampled order
    ts: float  # wall-clock at batch entry
    batch_size: int
    bucket: int  # pow2 bucket the batch padded into
    path: str  # "index:<backend>" | "exact" — which scorer served it
    table_version: int
    stage_version: int
    spans: Tuple[Tuple[str, float], ...]  # ordered (phase, duration_ms)
    total_ms: float

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spans"] = {name: ms for name, ms in self.spans}
        return d


class TraceSampler:
    """Seeded ~1-in-N Bernoulli sampler (deterministic per seed + sequence).

    A modulo counter would sample deterministically too, but phase-locks to
    periodic traffic (every sampled batch is the same position in a
    scheduler cycle); the seeded PRNG keeps determinism without the
    aliasing. `sample_every <= 1` samples everything (tests, debugging).
    """

    def __init__(self, sample_every: int = 64, seed: int = 0):
        self.sample_every = max(int(sample_every), 1)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def sample(self) -> bool:
        if self.sample_every == 1:
            return True
        with self._lock:  # Random() is not thread-safe under free-threading
            return self._rng.random() < 1.0 / self.sample_every


class RouteTracer:
    """Bounded ring of sampled `RouteTrace` records + JSONL export."""

    def __init__(
        self,
        sample_every: int = 64,
        capacity: int = 1024,
        seed: int = 0,
    ):
        assert capacity >= 1
        self.sampler = TraceSampler(sample_every, seed)
        self.capacity = int(capacity)
        self._ring: Deque[RouteTrace] = deque()
        self._next_id = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def sample(self) -> bool:
        """Decide at batch entry; the gateway only stamps spans when True."""
        return self.sampler.sample()

    def record(
        self,
        batch_size: int,
        bucket: int,
        path: str,
        table_version: int,
        stage_version: int,
        spans: List[Tuple[str, float]],
        total_ms: float,
    ) -> RouteTrace:
        with self._lock:
            trace = RouteTrace(
                trace_id=self._next_id,
                ts=clock.wall(),
                batch_size=int(batch_size),
                bucket=int(bucket),
                path=path,
                table_version=int(table_version),
                stage_version=int(stage_version),
                spans=tuple((str(n), float(ms)) for n, ms in spans),
                total_ms=float(total_ms),
            )
            self._next_id += 1
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(trace)
            return trace

    # --------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def traces(self) -> List[RouteTrace]:
        with self._lock:
            return list(self._ring)

    def get(self, trace_id: int) -> Optional[RouteTrace]:
        """Retained trace by id, or None (evicted / never sampled) — the
        lookup behind exemplar links ("your p99 bucket → this trace")."""
        with self._lock:
            for t in reversed(self._ring):
                if t.trace_id == trace_id:
                    return t
        return None

    def export_jsonl(self, path: str) -> int:
        """Write retained traces as JSONL; returns the number written."""
        traces = self.traces()
        with open(path, "w") as f:
            for t in traces:
                f.write(json.dumps(t.as_dict()) + "\n")
        return len(traces)

    def phase_summaries(self) -> Dict[str, dict]:
        """Per-phase {count, mean, p50, p99} over the retained traces —
        the exact-sample view (`repro_torch.obs.summary.percentile_stats`)."""
        from repro_torch.obs.summary import percentile_stats

        by_phase: Dict[str, List[float]] = {}
        for t in self.traces():
            for name, ms in t.spans:
                by_phase.setdefault(name, []).append(ms)
        return {
            name: percentile_stats(samples).as_dict()
            for name, samples in sorted(by_phase.items())
        }


# ============================================================ program spans
@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int  # wall-clock epoch nanoseconds (`time.time_ns`, the profiler's)
    end_ns: int
    parent: int  # index of the enclosing span; -1 for an outermost one
    root: int  # index of the outermost span open around it (its own if outermost)
    attrs: Dict[str, int]


class SpanRecorder:
    """The spans of one `recording()`, bounded by `capacity` (`dropped`
    counts the rest). Made by `recording()`; `spans()` reads them out."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dropped = 0
        # one row a span: [name, start, end (-1 while open), parent, root, attrs]
        self._rows: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()  # .stack: this thread's open span indices
        p0 = clock.perf_ns()
        w = clock.wall_ns()
        self._offset_ns = w - (p0 + clock.perf_ns()) // 2
        self._stop_ns = -1

    def _stack(self) -> List[int]:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = []
            return stack

    def open(self, name: str, attrs: Dict[str, int]) -> Tuple[Optional[list], List[int]]:
        """Open a span on this thread: (its row, None when the recorder is
        full; the thread's stack of open spans, the new one on top)."""
        stack = self._stack()
        i = self._append(name, clock.perf_ns(), -1, stack[-1] if stack else -1,
                         stack[0] if stack else None, attrs)
        if i < 0:
            return None, stack
        stack.append(i)
        return self._rows[i], stack

    def _append(self, name: str, start: int, end: int, parent: int, root: Optional[int],
                attrs: Dict[str, int]) -> int:
        """Append one span (`end` -1 while it is open); its index, or -1 when
        the recorder is full."""
        with self._lock:
            i = len(self._rows)
            if i >= self.capacity:
                self.dropped += 1
                return -1
            self._rows.append([name, start, end, parent, i if root is None else root, attrs])
            return i

    def stamped(self, name: str, start: float, end: float,
                children: Sequence[Tuple[str, float, float]], attrs: Dict[str, int]) -> None:
        """A span and its children from `clock.perf()` stamps the caller
        already took, under the span open on this thread (if any)."""
        stack = self._stack()
        i = self._append(name, int(start * 1e9), int(end * 1e9), stack[-1] if stack else -1,
                         stack[0] if stack else None, attrs)
        if i < 0:
            return
        root = self._rows[i][4]
        for child, a, b in children:
            self._append(child, int(a * 1e9), int(b * 1e9), i, root, {})

    def stop(self) -> None:
        self._stop_ns = clock.perf_ns()

    def spans(self) -> List[Span]:
        """Every span recorded, in the order they opened (an index is a
        span's place here), on the wall clock; one still open when
        recording stopped ends at the stop."""
        with self._lock:
            rows = [list(r) for r in self._rows]
        off, stop = self._offset_ns, self._stop_ns
        return [Span(name, start + off, (end if end >= 0 else stop) + off, parent, root, attrs)
                for name, start, end, parent, root, attrs in rows]


class _NoSpan:
    """What `span()` returns while nothing records: one shared instance."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_attrs", "_row", "_stack")

    def __init__(self, rec: SpanRecorder, name: str, attrs: Dict[str, int]):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self) -> None:
        self._row, self._stack = self._rec.open(self._name, self._attrs)

    def __exit__(self, *exc) -> None:
        if self._row is not None:
            self._row[2] = clock.perf_ns()
            self._stack.pop()


# the recorder of the open `recording()`, or None: process-wide, so that the
# programs' spans need no recorder passed through every call
_ACTIVE: Optional[SpanRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def _attrs(layer: Optional[int], tokens: Optional[int],
           queries: Optional[int]) -> Dict[str, int]:
    attrs = {}
    if layer is not None:
        attrs["layer"] = int(layer)
    if tokens is not None:
        attrs["tokens"] = int(tokens)
    if queries is not None:
        attrs["queries"] = int(queries)
    return attrs


def recording_on() -> bool:
    return _ACTIVE is not None


def span(name: str, layer: Optional[int] = None, tokens: Optional[int] = None,
         queries: Optional[int] = None):
    """A context manager that records the block as a span named `name`
    while a `recording()` is open, and does nothing otherwise."""
    rec = _ACTIVE
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name, _attrs(layer, tokens, queries))


def record(name: str, start: float, end: float,
           children: Sequence[Tuple[str, float, float]] = (),
           queries: Optional[int] = None) -> None:
    """Record a span, and its children `(name, start, end)`, from
    `clock.perf()` stamps already taken, while a `recording()` is open."""
    rec = _ACTIVE
    if rec is not None:
        rec.stamped(name, start, end, children, _attrs(None, None, queries))


@contextlib.contextmanager
def recording(capacity: int = 1 << 20) -> Iterator[SpanRecorder]:
    """Record the process's spans until the block ends; the recorder's
    `spans()` then holds them. One recording at a time."""
    global _ACTIVE
    rec = SpanRecorder(capacity)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a span recording is already open")
        _ACTIVE = rec
    try:
        yield rec
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
        rec.stop()
