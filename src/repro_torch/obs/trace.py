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
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs import clock

__all__ = ["RouteTrace", "TraceSampler", "RouteTracer"]


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
