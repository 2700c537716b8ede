"""ToolIndexManager: version-tracked index lifecycle between the database
and the scorer backends.

Counterpart of `repro/index/manager.py`, without its background rebuild
thread (every ported build is inline); every backend (and the exact fallback) lives on the manager's `device` —
`None` means the CUDA card, and a machine without one raises.

The swap-compatibility problem this layer solves: an index (a
device-resident table copy, later IVF clusters) is derived state over one table snapshot,
but `ToolsDatabase.swap_table`/`rollback` can land at any moment —
including mid-batch, including from the control plane's guard. The
manager keeps the invariant that *served scores always come from the table
version they are reported under*:

  * every `topk` call starts from an atomic `db.snapshot()`;
  * if the built backend matches the snapshot version (and can honor the
    batch's candidate mask), it serves;
  * otherwise the index is rebuilt inline for the snapshot's version and
    serves. Every ported backend's build is one device upload
    (`build_is_cheap`), so no batch waits on a background thread; IVF,
    whose k-means build needs one, comes in a later slice;
  * a masked batch the backend cannot honor, or a swap that lands between
    the snapshot and the rebuild, is served by the exact dense path **on
    the snapshot itself** — a `DenseBackend` over that snapshot, rebuilt
    only on version change, so it is numerically identical to the dense
    index.

Rebuilds are also triggered eagerly: the manager registers a
`ToolsDatabase.add_swap_listener` hook at construction, so a control-plane
swap or guard rollback rebuilds the index before the next request.

A failed build is counted in `stats["build_failures"]` and raised: the
construction, or the serving call that needed the index, fails. The
configured backend (on the card, the `topk_sim` kernel) never hands its
batches to the exact path quietly.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.index.dense import DenseBackend
from repro_torch.obs import clock
from repro_torch.obs.metrics import MetricsRegistry, get_registry
from repro_torch.router.tooldb import ToolsDatabase

__all__ = ["ToolIndexManager"]


class _IndexInstruments:
    """Preresolved metric handles (the names `repro.obs` catalogs)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.served = {
            "index": registry.counter("index_served_total", path="index"),
            "exact": registry.counter("index_served_total", path="exact"),
        }
        self.rebuilds = registry.counter("index_rebuilds_total")
        self.build_failures = registry.counter("index_build_failures_total")
        self.build_ms = registry.histogram("index_build_ms")


def _build_backend(kind: str, table: np.ndarray, table_version: int, device):
    # local import so manager <-> package __init__ stay cycle-free
    from repro_torch.index import build_backend

    return build_backend(kind, table, table_version, device=device)


class ToolIndexManager:
    def __init__(
        self,
        db: ToolsDatabase,
        backend: str = "dense",
        watch_swaps: bool = True,
        metrics: Union[MetricsRegistry, bool, None] = None,
        bus: Optional["EventBus"] = None,  # repro_torch.obs.events
        device: Union[str, torch.device, None] = None,
    ):
        from repro_torch.index import BACKENDS  # call-time import: no module cycle

        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r} (available: {sorted(BACKENDS)})"
            )
        if not BACKENDS[backend].build_is_cheap:
            raise ValueError(f"backend {backend!r} needs a background build")
        self.db = db
        self.device = resolve_device(device)
        self.backend_kind = backend
        self._lock = threading.Lock()
        # waiters for an in-flight build (a concurrent serving call joins
        # the running build instead of duplicating it); shares self._lock
        self._build_cond = threading.Condition(self._lock)
        self._backend = None
        self._building_for: Optional[int] = None  # version with an in-flight build
        self._fallback: Optional[DenseBackend] = None  # exact path, per version
        self.stats: Dict[str, int] = {
            "served_index": 0,
            "served_exact": 0,
            "rebuilds": 0,
            "build_failures": 0,
        }
        # telemetry mirrors of `stats` + rebuild lifecycle events; the bus
        # is a plain attribute so launchers can attach one to a manager a
        # router already built (`manager.bus = bus`)
        if metrics is False:
            self._obs: Optional[_IndexInstruments] = None
        else:
            registry = metrics if isinstance(metrics, MetricsRegistry) else get_registry()
            self._obs = _IndexInstruments(registry)
        self.bus = bus
        # which path served the calling thread's last topk ("index:<kind>" |
        # "exact"): thread-local so concurrent batches don't cross-stamp
        # their traces
        self._tls = threading.local()
        self.refresh()  # a failed first build raises here
        self._watching = watch_swaps
        if watch_swaps:
            db.add_swap_listener(self._on_swap)

    # ------------------------------------------------------------- lifecycle
    def _on_swap(self, new_version: int) -> None:
        # the database swallows a listener's exception; the serving call
        # that finds the index stale retries the build and raises
        self.refresh()

    def close(self) -> None:
        """Unregister from the database's swap listeners (idempotent).

        A manager that is being retired (router torn down, backend
        reconfigured) must be closed, or the database keeps a strong
        reference and keeps triggering rebuilds — and keeps this manager's
        table copies alive — on every future swap.
        """
        if self._watching:
            self.db.remove_swap_listener(self._on_swap)
            self._watching = False

    def is_fresh(self) -> bool:
        """True when the built index matches the database's live version."""
        with self._lock:
            backend = self._backend
        return backend is not None and backend.table_version == self.db.table_version

    def wait_ready(self) -> bool:
        """Build the index for the live version if it is stale; True when
        it is fresh. A failed build raises."""
        self.refresh()
        return self.is_fresh()

    def refresh(self) -> None:
        """Build the index for the current table version, inline, unless it
        is fresh or another thread is building it (then wait for that)."""
        version, table = self.db.snapshot()
        with self._lock:
            if self._backend is not None and self._backend.table_version >= version:
                return
            if self._building_for == version:
                while self._building_for == version:
                    self._build_cond.wait()
                return
            self._building_for = version
        self._build(version, np.asarray(table))

    def _build(self, version: int, table: np.ndarray) -> None:
        bus, obs = self.bus, self._obs
        if bus is not None:
            bus.publish("rebuild_start", plane="index", version=version,
                        backend=self.backend_kind)
        t0 = clock.perf()
        try:
            backend = _build_backend(self.backend_kind, table, version, self.device)
        except Exception as exc:
            with self._lock:
                self.stats["build_failures"] += 1
                if self._building_for == version:
                    self._building_for = None
                self._build_cond.notify_all()
            if obs is not None:
                obs.build_failures.inc()
            if bus is not None:
                bus.publish("rebuild_failure", plane="index", version=version,
                            backend=self.backend_kind, error=repr(exc))
            raise
        build_ms = clock.duration_ms(t0)
        with self._lock:
            # never replace a fresher index with a slower build's older one
            if self._backend is None or self._backend.table_version <= version:
                self._backend = backend
                self.stats["rebuilds"] += 1
            if self._building_for == version:
                self._building_for = None
            self._build_cond.notify_all()
        if obs is not None:
            obs.rebuilds.inc()
            obs.build_ms.record(build_ms)
        if bus is not None:
            bus.publish("rebuild_finish", plane="index", version=version,
                        backend=self.backend_kind, build_ms=build_ms)

    # ----------------------------------------------------------------- serve
    def topk(
        self,
        queries: np.ndarray,
        k: int,
        candidate_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(scores [Q, k], indices [Q, k], table_version) for this batch.

        The returned version is the snapshot the scores were computed from —
        the backend's when it serves, the fallback snapshot's otherwise.
        """
        version, table = self.db.snapshot()
        with self._lock:
            backend = self._backend
        if backend is None or backend.table_version != version:
            self.refresh()  # inline: one device upload; a failure raises
            with self._lock:
                backend = self._backend
            if backend is None or backend.table_version < version:
                # another thread's build for this version failed
                raise RuntimeError(
                    f"no {self.backend_kind} index for table version {version}"
                )
        maskable = candidate_mask is None or backend.supports_masks
        if backend.table_version == version and maskable:
            scores, idx = backend.topk(queries, k, candidate_mask)
            with self._lock:  # counters race under concurrent serving
                self.stats["served_index"] += 1
            self._tls.path = f"index:{self.backend_kind}"
            if self._obs is not None:
                self._obs.served["index"].inc()
            return scores, idx, version
        scores, idx = self._exact_topk(queries, table, version, k, candidate_mask)
        with self._lock:
            self.stats["served_exact"] += 1
        self._tls.path = "exact"
        if self._obs is not None:
            self._obs.served["exact"].inc()
        return scores, idx, version

    def last_path(self) -> str:
        """Which path served the calling thread's most recent `topk`."""
        return getattr(self._tls, "path", "unknown")

    def _exact_topk(
        self,
        queries: np.ndarray,
        table: np.ndarray,
        version: int,
        k: int,
        candidate_mask: Optional[np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray]:
        # the exact path IS a DenseBackend over the snapshot — one
        # implementation, so fallback and dense-index numerics are identical
        # by construction; rebuilt only on version change (a benign race can
        # at worst double-upload)
        fallback = self._fallback
        if fallback is None or fallback.table_version != version:
            fallback = DenseBackend(table, version, device=self.device)
            self._fallback = fallback
        return fallback.topk(queries, k, candidate_mask)
