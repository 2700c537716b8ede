"""Continuous profiling: live compile/cost telemetry for the hot path.

Counterpart of `repro/obs/profile.py`, with the same surface, instruments
and ``/profile`` payload, so the SLO engine and the flight recorder read it
unchanged. What it probes differs, because the port compiles nothing with
XLA:

* `JitProfiler` — polls each tracked entry's `_cache_size()`. For the port
  that is `router.gateway.hot_path_jits()`'s `topk_sim` probe: the kernel
  library loaded (0 or 1) plus the routes launched at least once (CUDA
  loads a route's kernels lazily at its first launch). The **first**
  `collect()` establishes a baseline so warmup loads are not counted as
  incidents; after that, every growth increments
  ``jit_compiles_total{fn=...}`` and the absolute size is mirrored to
  ``jit_cache_size{fn=...}``. The `TimeSeriesRing` windows the counters like
  any other signal and `default_slos()`'s ``jit_retrace_rate`` SLO alerts on
  a sustained post-warmup rate. The eager adapter and re-ranker have no
  probe and are listed as ``unsupported``, as the reference lists a
  callable without a jit cache.

* Cost stamping — `stamp_cost(name, *shape)` records the entry's analytic
  `cost()` (FLOPs and bytes from the shapes, `kernels/topk_sim/kernel.py::
  cost`) and the route it would take at those shapes. It never builds,
  loads or launches anything, so stamping cannot show up as a retrace.
  `stamp_router_costs` derives the shapes from a live router. The result
  is exported at ``/profile``.

* `SamplingProfiler` — an opt-in wall-clock sampler for the controller
  daemons: a daemon thread snapshots ``sys._current_frames()`` at a fixed
  interval, filters to the registered thread idents, and aggregates
  collapsed stacks into counts. Self-time is attributed to whatever frame
  is on top when the sample lands — the classic statistical profile, at
  ~zero cost to the profiled threads (no tracing hook is installed). Off
  by default; `launch/serve.py` enables it behind ``--profile-daemons``.
  Copied from the reference unchanged.
"""
from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.common.bucketing import pad_amount

__all__ = ["JitProfiler", "SamplingProfiler", "stamp_router_costs", "supports_cache_size"]


def supports_cache_size(fn) -> bool:
    """True when `fn` exposes the compile-cache probe this module needs."""
    return callable(getattr(fn, "_cache_size", None))


class JitProfiler:
    """Compile-cache poller + cost stamper over named hot-path entries.

    `collect()` is cheap (one attribute read per entry) and is meant to run
    on the `TimeSeriesRing` tick cadence; the first call only baselines.
    """

    def __init__(
        self,
        jits: Optional[Dict[str, Callable]] = None,
        registry=None,  # repro_torch.obs.metrics.MetricsRegistry
    ):
        if jits is None:
            from repro_torch.router.gateway import hot_path_jits

            jits = hot_path_jits()
        self._fns: Dict[str, Callable] = {}
        self.unsupported: List[str] = []
        for name, fn in jits.items():
            if supports_cache_size(fn):
                self._fns[name] = fn
            else:
                self.unsupported.append(name)
        self.registry = registry
        # last observed cache size per entry; None until the baseline collect
        self._last: Dict[str, Optional[int]] = {n: None for n in self._fns}
        self._compiles: Dict[str, int] = {n: 0 for n in self._fns}
        self._costs: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._counters = self._gauges = None
        if registry is not None:
            self._counters = {
                n: registry.counter("jit_compiles_total", fn=n) for n in self._fns
            }
            self._gauges = {
                n: registry.gauge("jit_cache_size", fn=n) for n in self._fns
            }

    def names(self) -> List[str]:
        return sorted(self._fns)

    # ------------------------------------------------------------- collecting
    def collect(self) -> Dict[str, int]:
        """Poll every cache size; count post-baseline growth as compiles.

        Returns {fn: cache_size}. The first call per entry records the
        baseline without incrementing — warmup loads are expected, only
        growth *after* the profiler is watching is a retrace signal.
        """
        sizes = {n: int(f._cache_size()) for n, f in self._fns.items()}
        with self._lock:
            for n, size in sizes.items():
                last = self._last[n]
                if last is not None and size > last:
                    delta = size - last
                    self._compiles[n] += delta
                    if self._counters is not None:
                        self._counters[n].inc(delta)
                self._last[n] = size
                if self._gauges is not None:
                    self._gauges[n].set(size)
        return sizes

    # --------------------------------------------------------------- stamping
    def stamp_cost(self, name: str, *args, **kwargs) -> dict:
        """Record `name`'s analytic cost at the shapes in `args`.

        The entry's `cost(*args)` gives FLOPs and bytes, its `route(*args)`
        (where it has one) the route it would take. Nothing is built,
        loaded or launched, so `_cache_size()` does not move.
        """
        fn = self._fns[name]
        if not callable(getattr(fn, "cost", None)):
            raise ValueError(f"{name} has no analytic cost()")
        cost = dict(fn.cost(*args, **kwargs))
        cost["arg_shapes"] = [int(a) for a in args]
        if callable(getattr(fn, "route", None)):
            cost["route"] = fn.route(*args, **kwargs)
        with self._lock:
            self._costs[name] = cost
        return cost

    # ---------------------------------------------------------------- reading
    def snapshot(self) -> dict:
        """The ``/profile`` payload: per-entry cache/compile/cost state."""
        with self._lock:
            jits = {
                n: {
                    "cache_size": self._last[n] if self._last[n] is not None else 0,
                    "compiles_total": self._compiles[n],
                    "baselined": self._last[n] is not None,
                    "cost": self._costs.get(n),
                }
                for n in self._fns
            }
        return {"jits": jits, "unsupported": list(self.unsupported)}


def stamp_router_costs(
    profiler: JitProfiler, router, batch_size: int = 1
) -> Dict[str, dict]:
    """Stamp `topk_sim` at the shapes a live `router` serves.

    Only when the router's index backend is "fused" (the one that launches
    the kernel; nothing is stamped otherwise): Q is `batch_size` padded to
    the power-of-two bucket `route_batch` uses, T and D the live table's,
    and C the candidates the index is asked for (k, or k x the candidate
    multiplier while a re-ranker is live), so the stamped call IS the
    serving call.
    """
    stamped: Dict[str, dict] = {}
    if "topk_sim" not in profiler.names() or router.index.backend_kind != "fused":
        return stamped
    q = int(batch_size)
    _, emb = router.db.snapshot()
    n_t, d = emb.shape
    _, stages = router.stage_set()
    c = (
        min(router.k * router.candidate_multiplier, n_t)
        if stages.has_reranker
        else min(router.k, n_t)
    )
    stamped["topk_sim"] = profiler.stamp_cost("topk_sim", q + pad_amount(q), n_t, d, c)
    return stamped


class SamplingProfiler:
    """Opt-in statistical wall-clock profiler over chosen threads.

    Samples `sys._current_frames()` on a daemon thread and aggregates
    collapsed call stacks (outermost;...;innermost) per registered thread.
    The profiled threads pay nothing — no trace hook, no instrumentation —
    and the profile's resolution is the sampling interval.
    """

    def __init__(self, interval_s: float = 0.05, max_depth: int = 24):
        self.interval_s = float(interval_s)
        self.max_depth = int(max_depth)
        self._targets: Dict[int, str] = {}  # thread ident -> display name
        self._samples: Dict[str, Dict[str, int]] = {}  # name -> stack -> n
        self._n_ticks = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_loop_error: Optional[str] = None

    def watch_thread(self, thread: threading.Thread, name: Optional[str] = None):
        """Register a (started) thread for sampling."""
        assert thread.ident is not None, "watch_thread needs a started thread"
        with self._lock:
            self._targets[thread.ident] = name or thread.name
        return self

    def sample_once(self) -> int:
        """Take one sample of every watched thread; returns threads seen."""
        frames = sys._current_frames()
        seen = 0
        with self._lock:
            targets = dict(self._targets)
        collapsed: List[Tuple[str, str]] = []
        for ident, name in targets.items():
            frame = frames.get(ident)
            if frame is None:
                continue  # thread exited; keep the accumulated profile
            stack: List[str] = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                code = frame.f_code
                stack.append(f"{code.co_name}@{code.co_filename.rsplit('/', 1)[-1]}")
                frame = frame.f_back
                depth += 1
            collapsed.append((name, ";".join(reversed(stack))))
            seen += 1
        with self._lock:
            self._n_ticks += 1
            for name, stack in collapsed:
                per = self._samples.setdefault(name, {})
                per[stack] = per.get(stack, 0) + 1
        return seen

    def start(self) -> "SamplingProfiler":
        assert self._thread is None, "sampling profiler already running"
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.sample_once()
                    self.last_loop_error = None
                except Exception as exc:  # noqa: BLE001 — daemon must survive
                    self.last_loop_error = f"{type(exc).__name__}: {exc}"
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=_loop, name="sampling-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Idempotent; joins the sampler with a bounded wait."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        self._thread = None

    def snapshot(self, top: int = 10) -> dict:
        """Per-thread top collapsed stacks by sample count."""
        with self._lock:
            n_ticks = self._n_ticks
            threads = {
                name: sorted(per.items(), key=lambda kv: -kv[1])[:top]
                for name, per in self._samples.items()
            }
        return {
            "interval_s": self.interval_s,
            "n_samples": n_ticks,
            "threads": {
                name: [{"stack": s, "samples": n} for s, n in stacks]
                for name, stacks in threads.items()
            },
        }
