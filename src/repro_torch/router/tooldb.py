"""ToolsDatabase: the router's tool-embedding table + metadata store.

The serving-plane object the paper's Stage 1 updates: `swap_table` atomically
replaces the embedding table after an offline refinement job passes the
validation gate (§7.2 — "read outcome logs, compute centroid updates,
validate, and swap the embedding table. No code changes to the serving
path"). Keeps a small bounded *version history* of superseded tables so
deployment is instantly reversible: `rollback()` restores the most recent
retained table, `rollback(to_version=...)` targets any retained version
(the control plane's guard uses this to unwind a regressing swap even after
further swaps have landed). A rollback discards the replaced table and every
retained version newer than the target — they are dead lineage once the
guard has condemned them.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np

__all__ = ["ToolRecord", "ToolsDatabase", "ConflictError"]


class ConflictError(RuntimeError):
    """A versioned operation lost a race: the table moved under the caller."""


@dataclasses.dataclass
class ToolRecord:
    tool_id: int
    name: str
    description_tokens: np.ndarray
    category: int


class ToolsDatabase:
    """Thread-safe embedding table with atomic swap + versioned rollback."""

    def __init__(
        self,
        records: List[ToolRecord],
        embeddings: np.ndarray,
        history_limit: int = 4,
    ):
        assert len(records) == embeddings.shape[0]
        assert history_limit >= 1
        self._records = records
        self._table = embeddings.astype(np.float32)
        # superseded tables, oldest first: {version -> table at that version}
        self._history: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._history_limit = history_limit
        self._lock = threading.Lock()
        # version-change listeners (repro_torch.index.ToolIndexManager registers its
        # rebuild trigger here); invoked AFTER the lock is released so a
        # listener may call snapshot()/swap_table() without deadlocking
        self._swap_listeners: List[Callable[[int], None]] = []
        self.table_version = 0

    def __len__(self) -> int:
        return len(self._records)

    @property
    def embeddings(self) -> np.ndarray:
        return self._table

    def snapshot(self) -> tuple:
        """(table_version, embedding table) read atomically w.r.t. swaps,
        so a serving batch can never score with table N+1 while labelling
        its outcomes with version N."""
        with self._lock:
            return self.table_version, self._table

    def record(self, tool_id: int) -> ToolRecord:
        return self._records[tool_id]

    def categories(self) -> np.ndarray:
        return np.array([r.category for r in self._records], dtype=np.int64)

    def retained_versions(self) -> List[int]:
        """Versions currently available as rollback targets, oldest first."""
        with self._lock:
            return list(self._history.keys())

    def add_swap_listener(self, fn: Callable[[int], None]) -> None:
        """Register `fn(new_version)` to run after every swap/rollback.

        The index layer uses this to rebuild its index the moment a new
        table deploys; a serving call that still finds the index stale
        rebuilds it itself, so listeners are fire-and-forget. Exceptions
        raised by a listener are swallowed — a broken rebuild hook must never
        turn a successful deployment into a failed one.

        The database holds a strong reference until `remove_swap_listener`:
        a retiring router/manager must unregister (`ToolIndexManager.close`)
        or it keeps rebuilding — and keeps its table copies alive — on every
        swap for the database's lifetime.
        """
        with self._lock:
            self._swap_listeners.append(fn)

    def remove_swap_listener(self, fn: Callable[[int], None]) -> None:
        """Unregister a listener added by `add_swap_listener` (idempotent)."""
        with self._lock:
            try:
                self._swap_listeners.remove(fn)
            except ValueError:
                pass

    def _notify_swap(self, new_version: int) -> None:
        for fn in list(self._swap_listeners):
            try:
                fn(new_version)
            except Exception:
                pass

    def swap_table(
        self, new_table: np.ndarray, expect_current: Optional[int] = None
    ) -> int:
        """Atomically deploy a refined embedding table (returns new version).

        The outgoing table is retained as a rollback target; the history is
        bounded at `history_limit` entries (oldest evicted first).

        `expect_current` makes the swap compare-and-swap: a deployment
        derived from version N is refused (ConflictError) if the table has
        moved past N while it was being computed, instead of silently
        clobbering someone else's swap.
        """
        assert new_table.shape == self._table.shape, (
            f"table shape {new_table.shape} != {self._table.shape}"
        )
        with self._lock:
            if expect_current is not None and self.table_version != expect_current:
                raise ConflictError(
                    f"table is v{self.table_version}, not v{expect_current} "
                    f"the deployment was derived from; refusing swap"
                )
            self._history[self.table_version] = self._table
            while len(self._history) > self._history_limit:
                self._history.popitem(last=False)
            self._table = new_table.astype(np.float32)
            self.table_version += 1
            new_version = self.table_version
        self._notify_swap(new_version)
        return new_version

    def rollback(
        self, to_version: Optional[int] = None, expect_current: Optional[int] = None
    ) -> int:
        """Instant rollback (§7.2) to a retained version's table.

        Default target is the most recent retained version (the table that
        served immediately before the current one). Restoring bumps
        `table_version` — a rollback is itself a swap, so serving snapshots
        stay strictly versioned. The condemned current table is *not*
        retained, and retained versions newer than the target are dropped.

        `expect_current` makes the rollback compare-and-swap: if another
        swap landed after the caller judged version `expect_current`, the
        rollback is refused (ConflictError) instead of condemning a table
        the caller never evaluated — the guard's safety hinge.
        """
        with self._lock:
            if expect_current is not None and self.table_version != expect_current:
                raise ConflictError(
                    f"table is v{self.table_version}, not the judged "
                    f"v{expect_current}; refusing rollback"
                )
            if not self._history:
                raise RuntimeError("no previous table to roll back to")
            if to_version is None:
                to_version = next(reversed(self._history))
            if to_version not in self._history:
                raise RuntimeError(
                    f"version {to_version} not retained "
                    f"(available: {list(self._history.keys())})"
                )
            table = self._history.pop(to_version)
            for v in [v for v in self._history if v > to_version]:
                del self._history[v]
            self._table = table
            self.table_version += 1
            new_version = self.table_version
        self._notify_swap(new_version)
        return new_version
