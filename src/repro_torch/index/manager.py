"""ToolIndexManager: version-tracked index lifecycle between the database
and the scorer backends.

Counterpart of `repro/index/manager.py`; every backend (and the exact
fallback) lives on the manager's `device` — `None` means the CUDA card,
and a machine without one raises.

The swap-compatibility problem this layer solves: an index (a
device-resident table copy, IVF clusters) is derived state over one table
snapshot, but `ToolsDatabase.swap_table`/`rollback` can land at any moment —
including mid-batch, including from the control plane's guard. The
manager keeps the invariant that *served scores always come from the table
version they are reported under*:

  * every `topk` call starts from an atomic `db.snapshot()`;
  * if the built backend matches the snapshot version (and can honor the
    batch's candidate mask), it serves;
  * a masked batch the backend cannot honor, or a batch that finds no
    index for its version, is served by the exact dense path **on the
    snapshot itself** — a `DenseBackend` over that snapshot, rebuilt only
    on version change, so it is numerically identical to the dense index.

Rebuilds are also triggered eagerly: the manager registers a
`ToolsDatabase.add_swap_listener` hook at construction, so a control-plane
swap or guard rollback starts the rebuild immediately instead of on the
next unlucky request.

Two build disciplines, by backend:

  * cheap builds (`build_is_cheap`: dense, fused — one device upload) run
    inline, on the thread that swapped or the serving call that found the
    index stale, so no batch waits on a background thread. A failed cheap
    build is counted in `stats["build_failures"]` and raised: the
    construction, or the serving call that needed the index, fails. The
    configured backend (on the card, the `topk_sim` kernel) never hands its
    batches to the exact path quietly;
  * expensive builds (IVF k-means) run on a background
    `index-rebuild-v{n}` thread (`async_rebuild=False` makes them
    synchronous: deterministic for tests and offline jobs), and the exact
    fallback serves the snapshot meanwhile, counted in
    `stats["served_exact"]` and `last_path()`. A swap-triggered rebuild
    seeds from the outgoing index's `warm_start_state()`. A failed
    expensive build is counted and leaves the fallback serving: that
    index is an optimization, never a correctness dependency.

`backend_opts` are validated at construction by a probe build over the
table's first 64 rows, so a misconfiguration raises there instead of
dissolving into a build-failure loop behind the fallback.
"""
from __future__ import annotations

import threading
import time  # time.sleep only; clocks come from repro_torch.obs.clock
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


def _build_backend(kind: str, table: np.ndarray, table_version: int, device, **opts):
    # local import so manager <-> package __init__ stay cycle-free
    from repro_torch.index import build_backend

    return build_backend(kind, table, table_version, device=device, **opts)


class ToolIndexManager:
    def __init__(
        self,
        db: ToolsDatabase,
        backend: str = "dense",
        backend_opts: Optional[dict] = None,
        async_rebuild: bool = True,
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
        self.db = db
        self.device = resolve_device(device)
        self.backend_kind = backend
        self.backend_opts = dict(backend_opts or {})
        # cheap builds (dense/fused: one device upload) always run inline and
        # raise on failure; only an expensive build (IVF k-means) goes to a
        # background thread, with the exact fallback serving meanwhile
        self._inline_build = bool(BACKENDS[backend].build_is_cheap)
        self.async_rebuild = async_rebuild and not self._inline_build
        self._lock = threading.Lock()
        # waiters for an in-flight build (a concurrent call joins the
        # running build instead of duplicating it); shares self._lock
        self._build_cond = threading.Condition(self._lock)
        self._backend = None
        self._building_for: Optional[int] = None  # version with an in-flight build
        self._failed_for: Optional[int] = None  # version whose build failed
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
        # their traces during a fallback-serving window
        self._tls = threading.local()
        # fail fast on misconfigured backend_opts: a tiny synchronous
        # validation build surfaces TypeError/ValueError at construction
        _, probe_table = db.snapshot()
        _build_backend(backend, np.asarray(probe_table[:64]), -1, self.device,
                       **self.backend_opts)
        self.refresh(block=not self.async_rebuild)  # a failed cheap build raises here
        self._watching = watch_swaps
        if watch_swaps:
            db.add_swap_listener(self._on_swap)

    # ------------------------------------------------------------- lifecycle
    def _on_swap(self, new_version: int) -> None:
        # the database swallows a listener's exception; for a cheap backend
        # the serving call that finds the index stale retries and raises
        self.refresh(block=not self.async_rebuild)

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

    def wait_ready(self, timeout_s: float = 60.0, poll_s: float = 0.01) -> bool:
        """Block until the index is fresh; True on success.

        A cheap backend is built inline here if it is stale (a failed build
        raises). For a background build this polls, and returns False
        immediately (not after the full timeout) when the build for the
        live version has already failed and nothing is retrying it —
        callers must check the result: False means the exact fallback is
        serving, not the configured backend.
        """
        if self._inline_build:
            self.refresh(block=True)
            return self.is_fresh()
        deadline = clock.monotonic() + timeout_s
        while clock.monotonic() < deadline:
            if self.is_fresh():
                return True
            with self._lock:
                building = self._building_for is not None
                failed_version = self._failed_for
            if not building and failed_version == self.db.table_version:
                return False  # doomed: failed build, no retry in flight
            time.sleep(poll_s)
        return self.is_fresh()

    def refresh(self, block: bool = False) -> None:
        """Ensure a build for the current table version is done or in flight.

        `block=True` builds on this thread (or joins the build already
        running for this version); otherwise the build runs on a background
        thread. Cheap builds always block."""
        block = block or self._inline_build
        version, table = self.db.snapshot()
        with self._lock:
            if self._backend is not None and self._backend.table_version >= version:
                return
            if self._building_for == version:
                if not block:
                    return  # one in-flight build per version is enough
                # join the in-flight build instead of duplicating it; when
                # it finishes (installed or failed) this refresh is done
                while self._building_for == version:
                    self._build_cond.wait()
                return
            if self._failed_for == version and not block:
                # this version's background build already failed (counted
                # in stats); don't respawn a doomed build per serving call
                # — the next swap, or an explicit refresh(block=True), retries
                return
            self._building_for = version
        if block:
            self._build(version, np.asarray(table))
        else:
            threading.Thread(
                target=self._build,
                args=(version, np.asarray(table)),
                name=f"index-rebuild-v{version}",
                daemon=True,
            ).start()

    def _build(self, version: int, table: np.ndarray) -> None:
        bus, obs = self.bus, self._obs
        if bus is not None:
            bus.publish("rebuild_start", plane="index", version=version,
                        backend=self.backend_kind)
        t0 = clock.perf()
        opts = dict(self.backend_opts)
        with self._lock:
            prev = self._backend
        if prev is not None and hasattr(prev, "warm_start_state"):
            # swap-triggered rebuild: seed the new build from the outgoing
            # index's state (IVF k-means centroids); an incompatible state
            # is validated and ignored by the backend, never an error
            opts["warm_start"] = prev.warm_start_state()
        try:
            backend = _build_backend(self.backend_kind, table, version, self.device, **opts)
        except Exception as exc:
            with self._lock:
                self.stats["build_failures"] += 1
                self._failed_for = version
                if self._building_for == version:
                    self._building_for = None
                self._build_cond.notify_all()
            if obs is not None:
                obs.build_failures.inc()
            if bus is not None:
                bus.publish("rebuild_failure", plane="index", version=version,
                            backend=self.backend_kind, error=repr(exc))
            if self._inline_build:
                raise
            return  # the exact fallback keeps serving
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

    def warm(self, batch_size: int, ks) -> None:
        """The live backend's `warm(batch_size, ks)`, where it has one (the
        fused backend: each route's first launch on the card, before
        serving). The other backends load nothing lazily; nothing is counted
        in `stats`."""
        with self._lock:
            backend = self._backend
        warm = getattr(backend, "warm", None)
        if warm is not None:
            warm(batch_size, ks)

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
            # cheap builds run inline (a failure raises); an expensive one
            # goes to the background and this batch serves the exact path
            self.refresh()
            with self._lock:
                backend = self._backend
            if self._inline_build and (backend is None or backend.table_version < version):
                # another thread's build for this version failed
                raise RuntimeError(
                    f"no {self.backend_kind} index for table version {version}"
                )
        maskable = candidate_mask is None or (
            backend is not None and backend.supports_masks
        )
        if backend is not None and backend.table_version == version and maskable:
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
