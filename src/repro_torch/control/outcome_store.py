"""OutcomeStore: the control plane's bounded, thread-safe outcome event store.

The ingestion side of §7.2's loop ("read outcome logs"): routers push
`OutcomeEvent`s — either directly (`router = SemanticRouter(...,
outcome_sink=store.append)`) or via periodic drains
(`store.drain_router(router)`, which the `RefinementController` does every
step). Events live in a ring buffer bounded at `capacity`; when full, the
oldest events are overwritten (and counted in `dropped`) — the store keeps
the freshest evidence window, which is exactly what repeated refinement
wants, and a stalled controller can never OOM the serving process.

Per-tool positive/negative counters are maintained incrementally (including
decrement-on-eviction), so data-density gating (`core.deployment`) reads
them in O(1) without scanning the ring.

`build_refinement_batch` turns the ring into the dense inputs
`refine_embeddings` consumes: queries are deduplicated by token content, the
unique queries are embedded through the shared encoder in ONE batched call,
and `core.outcomes.masks_from_stream` builds the [Q, T] pos/neg masks.

Persistence: `save`/`restore` round-trip the ring through
`repro_torch.checkpoint` (msgpack + compression, in the JAX package's file
format), padding the ragged query-token arrays into one [E, L] matrix +
length vector, so the outcome window survives controller restarts.

Counterpart of `repro/control/outcome_store.py`, copied with only its
imports changed; `build_refinement_batch` returns numpy, as there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.outcomes import masks_from_stream
from repro_torch.router.gateway import OutcomeEvent

__all__ = ["RefinementBatch", "OutcomeStore"]


@dataclasses.dataclass
class RefinementBatch:
    """Dense refinement inputs built from the current event window."""

    query_tokens: List[np.ndarray]  # [Q] deduplicated query token arrays
    query_emb: np.ndarray  # [Q, D] batched-encoded unique queries
    pos_mask: np.ndarray  # [Q, T] observed successes (= relevance labels)
    neg_mask: np.ndarray  # [Q, T] observed failures (pos vetoes neg)
    n_events: int  # events folded into the masks
    # fingerprint of the EXACT window snapshot these inputs were built from,
    # taken under the same lock acquisition — an append racing the build
    # cannot desynchronize the two (the learning plane stamps artifacts
    # with it for attributability)
    fingerprint: str = ""

    @property
    def n_queries(self) -> int:
        return len(self.query_tokens)


def _query_key(tokens: np.ndarray) -> Tuple[int, bytes]:
    t = np.asarray(tokens)
    return (t.size, t.tobytes())


class OutcomeStore:
    """Thread-safe bounded ring of OutcomeEvents with per-tool counters."""

    def __init__(self, n_tools: int, capacity: int = 100_000):
        assert capacity >= 1
        self.n_tools = int(n_tools)
        self.capacity = int(capacity)
        self._events: Deque[OutcomeEvent] = deque()
        self._pos_counts = np.zeros(self.n_tools, dtype=np.int64)
        self._neg_counts = np.zeros(self.n_tools, dtype=np.int64)
        self.total_ingested = 0  # monotone; the controller's trigger watermark
        self.dropped = 0  # ring overwrites
        self._lock = threading.Lock()

    # ------------------------------------------------------------- ingestion
    def append(self, event: OutcomeEvent) -> None:
        """Ingest one event (the router's `outcome_sink` target)."""
        with self._lock:
            self._append_locked(event)

    def ingest(self, events: Iterable[OutcomeEvent]) -> int:
        """Ingest a drained batch; returns the number of events added."""
        n = 0
        with self._lock:
            for ev in events:
                self._append_locked(ev)
                n += 1
        return n

    def drain_router(self, router) -> int:
        """Pull a router's accumulated outcome log into the store."""
        return self.ingest(router.drain_outcomes())

    def clear(self) -> int:
        """Drop the whole event window (returns how many were dropped).

        Used by the controller after a guard rollback: the window is
        dominated by outcomes the condemned table generated and cannot be
        attributed per-version, so refinement must rebuild its evidence from
        fresh traffic. `total_ingested` stays monotone (it is a trigger
        watermark, not a window size)."""
        with self._lock:
            n = len(self._events)
            self._events.clear()
            self._pos_counts[:] = 0
            self._neg_counts[:] = 0
            return n

    def _append_locked(self, event: OutcomeEvent) -> None:
        if len(self._events) >= self.capacity:
            old = self._events.popleft()
            self._count(old, -1)
            self.dropped += 1
        self._events.append(event)
        self._count(event, +1)
        self.total_ingested += 1

    def _count(self, event: OutcomeEvent, delta: int) -> None:
        if event.outcome:
            self._pos_counts[event.tool_id] += delta
        else:
            self._neg_counts[event.tool_id] += delta

    # -------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def tool_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """([T] positive, [T] negative) event counts over the current window."""
        with self._lock:
            return self._pos_counts.copy(), self._neg_counts.copy()

    def snapshot_events(self) -> List[OutcomeEvent]:
        """Consistent copy of the current window (events stay in the ring)."""
        with self._lock:
            return list(self._events)

    def _fingerprint_locked(self) -> str:
        h = hashlib.sha1()
        h.update(np.int64(self.total_ingested).tobytes())
        h.update(np.int64(len(self._events)).tobytes())
        h.update(self._pos_counts.tobytes())
        h.update(self._neg_counts.tobytes())
        return h.hexdigest()[:16]

    def window_fingerprint(self) -> str:
        """Content hash of the current evidence window.

        The learning plane stamps every trained artifact with this (plus the
        table version), so a deployed StageSet is attributable to the exact
        window it was trained from. Built from the watermark + window size +
        per-tool counters: O(T), no ring scan, and any ingest/evict/clear
        changes it. For a fingerprint guaranteed to match a training batch,
        use `RefinementBatch.fingerprint` (same lock acquisition as the
        event snapshot it hashes)."""
        with self._lock:
            return self._fingerprint_locked()

    def build_refinement_batch(
        self,
        embed_batch_fn: Callable[[Sequence[np.ndarray]], np.ndarray],
    ) -> RefinementBatch:
        """Dense [Q, T] masks + batched query embeddings for Alg. 1.

        Deduplicates queries by token content (a query served K tools yields
        K events but one row), embeds the unique queries in one
        `embed_batch_fn` call, and folds every event into pos/neg masks via
        `masks_from_stream` (positives veto negatives on conflict). The
        returned batch carries the window fingerprint taken atomically with
        the event snapshot.
        """
        with self._lock:
            events = list(self._events)
            fingerprint = self._fingerprint_locked()
        keys: Dict[Tuple[int, bytes], int] = {}
        uniq_tokens: List[np.ndarray] = []
        qids = np.empty(len(events), dtype=np.int64)
        tids = np.empty(len(events), dtype=np.int64)
        outs = np.empty(len(events), dtype=np.int64)
        for i, ev in enumerate(events):
            k = _query_key(ev.query_tokens)
            qid = keys.get(k)
            if qid is None:
                qid = keys[k] = len(uniq_tokens)
                uniq_tokens.append(np.asarray(ev.query_tokens))
            qids[i] = qid
            tids[i] = ev.tool_id
            outs[i] = ev.outcome
        pos, neg = masks_from_stream(
            qids, tids, outs, n_queries=len(uniq_tokens), n_tools=self.n_tools
        )
        if uniq_tokens:
            q_emb = np.asarray(embed_batch_fn(uniq_tokens), dtype=np.float32)
        else:
            q_emb = np.zeros((0, 0), dtype=np.float32)
        return RefinementBatch(
            query_tokens=uniq_tokens,
            query_emb=q_emb,
            pos_mask=pos,
            neg_mask=neg,
            n_events=len(events),
            fingerprint=fingerprint,
        )

    # ---------------------------------------------------------- persistence
    def save(self, directory: str, step: int = 0) -> str:
        """Persist the event window via repro_torch.checkpoint (msgpack + codec)."""
        events = self.snapshot_events()
        max_len = max(
            max((len(np.asarray(e.query_tokens)) for e in events), default=1), 1
        )
        tokens = np.zeros((len(events), max_len), dtype=np.int64)
        lengths = np.zeros(len(events), dtype=np.int64)
        tool_ids = np.zeros(len(events), dtype=np.int64)
        outcomes = np.zeros(len(events), dtype=np.int64)
        timestamps = np.zeros(len(events), dtype=np.float64)
        for i, ev in enumerate(events):
            toks = np.asarray(ev.query_tokens)
            lengths[i] = len(toks)
            tokens[i, : len(toks)] = toks
            tool_ids[i] = ev.tool_id
            outcomes[i] = ev.outcome
            timestamps[i] = ev.timestamp
        tree = {
            "tokens": tokens,
            "lengths": lengths,
            "tool_ids": tool_ids,
            "outcomes": outcomes,
            "timestamps": timestamps,
            "counters": {
                "total_ingested": np.int64(self.total_ingested),
                "dropped": np.int64(self.dropped),
            },
        }
        meta = {
            "kind": "outcome_store",
            "n_tools": self.n_tools,
            "capacity": self.capacity,
        }
        return save_checkpoint(directory, step, tree, meta)

    @classmethod
    def restore(
        cls,
        directory: str,
        step: Optional[int] = None,
        capacity: Optional[int] = None,
    ) -> "OutcomeStore":
        """Rebuild a store (events + counters) from a saved window."""
        _, tree, meta = restore_checkpoint(directory, step)
        assert meta.get("kind") == "outcome_store", f"not an outcome store: {meta}"
        store = cls(
            n_tools=int(meta["n_tools"]),
            capacity=int(capacity if capacity is not None else meta["capacity"]),
        )
        lengths = tree["lengths"].reshape(-1)
        for i in range(len(lengths)):
            store.append(
                OutcomeEvent(
                    query_tokens=tree["tokens"][i, : int(lengths[i])].copy(),
                    tool_id=int(tree["tool_ids"].reshape(-1)[i]),
                    outcome=int(tree["outcomes"].reshape(-1)[i]),
                    timestamp=float(tree["timestamps"].reshape(-1)[i]),
                )
            )
        # restore() replays ingestion; overwrite the monotone counters with
        # the persisted lifetime values so trigger watermarks stay correct
        store.total_ingested = int(np.asarray(tree["counters"]["total_ingested"]))
        store.dropped = int(np.asarray(tree["counters"]["dropped"]))
        return store
