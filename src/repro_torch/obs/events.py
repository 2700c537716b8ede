"""EventBus: the planes' lifecycle events as one bounded, queryable stream.

Before this module, lifecycle transitions were scattered prints and
write-only attributes: a swap was visible only in a `ControllerReport`
someone kept a reference to, a guard rollback only in `guard.rollbacks`, an
index rebuild not at all. The bus gives every plane one `publish()` call
and every consumer (health endpoint, `chip_smoke.py`'s loop phase) one
ordered stream with version stamps.

Design constraints, in the same spirit as `OutcomeStore`:

* **bounded** — events live in a ring of `capacity`; when full the oldest
  event is overwritten and `dropped` counts it (a stalled consumer can
  never OOM the serving process);
* **cheap** — `publish` is a dataclass construction + deque append under a
  lock; no formatting, no I/O;
* **monotone** — every event carries a process-unique `seq`, so a poller
  asks for `events(since_seq=...)` and never re-reads or misses inside the
  retained window;
* **subscribable** — `subscribe(fn)` callbacks run synchronously *after*
  the ring append and outside the bus lock (a subscriber may publish or
  read without deadlock; a slow subscriber slows its publisher, which is
  the honest contract for in-process hooks).

Event kinds are an open vocabulary; the catalog the repo's planes publish
is documented in `repro_torch.obs.__init__`. `watch_db(db)` wires a
`ToolsDatabase` so *every* table version change (controller swap, guard
rollback, out-of-band deploy) lands on the bus even when the mover did not
carry a bus reference.

Counterpart of `repro/obs/events.py`, copied with only its imports changed (it
imports no JAX).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs import clock

__all__ = ["Event", "EventBus"]


@dataclasses.dataclass(frozen=True)
class Event:
    seq: int  # process-unique, monotone publication order
    ts: float  # wall-clock epoch seconds (exported records)
    kind: str  # e.g. "swap", "rollback", "rebuild_start" (see obs catalog)
    plane: str  # "serve" | "control" | "learn" | "index"
    details: Dict[str, object] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "kind": self.kind,
            "plane": self.plane,
            **self.details,
        }


class EventBus:
    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = int(capacity)
        self._ring: Deque[Event] = deque()
        self._seq = 0
        self.dropped = 0  # ring overwrites (oldest evicted first)
        self._counts: Dict[str, int] = {}  # per-kind lifetime counts
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[Event], None]] = []

    # ------------------------------------------------------------ publishing
    def publish(self, kind: str, plane: str = "serve", **details) -> Event:
        with self._lock:
            event = Event(self._seq, clock.wall(), kind, plane, details)
            self._seq += 1
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(event)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            subscribers = list(self._subscribers)
        for fn in subscribers:  # outside the lock: subscribers may publish
            fn(event)
        return event

    def subscribe(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[Event], None]) -> None:
        """Detach a subscriber; a no-op if it was never (or already no
        longer) attached, so teardown paths can call it unconditionally."""
        with self._lock:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    def watch_db(self, db) -> Callable[[], None]:
        """Publish a "swap" event for every table version change on `db`.

        Registered as a `ToolsDatabase` swap listener, so controller swaps,
        guard rollbacks, and out-of-band deploys all surface — the listener
        fires after the database lock is released, like index rebuilds.

        Returns a zero-arg detach handle that unregisters the listener, so
        long-lived tests and shutdown paths don't leak listeners across
        database instances. Idempotent.
        """
        listener = lambda version: self.publish("swap", plane="control",
                                                version=version)
        db.add_swap_listener(listener)
        return lambda: db.remove_swap_listener(listener)

    # --------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(
        self, since_seq: int = -1, kind: Optional[str] = None
    ) -> List[Event]:
        """Retained events with seq > since_seq (optionally one kind)."""
        with self._lock:
            evs = [e for e in self._ring if e.seq > since_seq]
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def last(self, kind: str) -> Optional[Event]:
        with self._lock:
            for e in reversed(self._ring):
                if e.kind == kind:
                    return e
        return None

    def counts(self) -> Dict[str, int]:
        """Lifetime per-kind publication counts (evictions don't decrement)."""
        with self._lock:
            return dict(self._counts)
