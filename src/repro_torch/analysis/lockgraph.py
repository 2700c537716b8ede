"""Lock-order checker: acquisition-graph recording + device dispatch under a lock.

Counterpart of `repro/analysis/lockgraph.py`. The planes share a handful of
locks (ToolsDatabase._lock, the router's stage lock, the index manager's
lock/condition, guard locks, the outcome ring). Two hazards survive code
review silently:

* **order cycles** — thread A takes L1 then L2 while thread B takes L2
  then L1: a deadlock that only fires under production interleavings;
* **dispatch under lock** — a host-to-device copy or a kernel launch
  inside a critical section: every contending thread eats the device
  latency (and a library load or a route's first launch under a lock is a
  multi-ms p99 breach for all of them).

`LockGraph` records both at runtime. `patch_threading(graph)` monkeypatches
`threading.Lock` so every lock constructed inside the with-block is a
`TrackedLock` named by its allocation site — `threading.Condition` built on
a tracked lock keeps working because TrackedLock duck-types acquire/release
exactly as Condition requires. `watch_dispatch(graph)` wraps the port's
dispatch surfaces to flag calls made while any tracked lock is held:
`torch.Tensor.to` with a device (the upload of `index/dense.py`,
`index/fused_backend.py`, `router/gateway.py` and `router/stages.py`),
`core.retrieval.topk_dense`, `core.reranker.rerank_topk_scored`, the
adapter, and the kernels' launch functions (`topk_sim_cuda`,
`flash_attention_cuda`, `ssd_scan_cuda`). A function is wrapped in every
port module that bound it by name before the patch (`router/stages.py`
imports `adapter_apply`, `kernels/topk_sim/ops.py` imports
`topk_sim_cuda`), not only where it is defined.

`python -m repro_torch.analysis.lockgraph --smoke [--device cpu]` runs a
threaded scenario (serving + CAS table swaps + stage churn + guard checks
under instrumentation) and exits non-zero on a cycle, a dispatch under a
lock or a thread error. On the card it serves through the fused backend.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockGraph",
    "TrackedLock",
    "patch_threading",
    "watch_dispatch",
    "run_scenario",
    "main",
]

# captured at import: the graph's own mutex (and every TrackedLock's inner
# lock) must be real even when allocated inside a patch_threading window
_REAL_LOCK = threading.Lock


def _caller_site(skip_internal: bool = True) -> str:
    """'path/to/file.py:123' of the nearest frame outside this module and
    the threading machinery — the lock's allocation site, its name."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn.endswith(("analysis/lockgraph.py", "threading.py")):
            continue
        return f"{fn.split('/src/')[-1].split('/lib/')[-1]}:{frame.lineno}"
    return "<unknown>"


class LockGraph:
    """Thread-safe record of lock acquisition order and dispatch-under-lock."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # (held_name, acquired_name) -> example thread name
        self.edges: Dict[Tuple[str, str], str] = {}
        # [{"fn": ..., "locks": [names], "thread": ...}]
        self.dispatch_events: List[dict] = []

    # ------------------------------------------------------------ recording
    def _stack(self) -> List["TrackedLock"]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def note_acquired(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        if stack:
            with self._mu:
                for held in stack:
                    if held.name != lock.name:
                        self.edges.setdefault(
                            (held.name, lock.name), threading.current_thread().name
                        )
        stack.append(lock)

    def note_released(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def held_locks(self) -> List[str]:
        return [l.name for l in self._stack()]

    def note_dispatch(self, fn_name: str, held: List[str]) -> None:
        with self._mu:
            self.dispatch_events.append(
                {
                    "fn": fn_name,
                    "locks": list(held),
                    "thread": threading.current_thread().name,
                }
            )

    # ------------------------------------------------------------- analysis
    def cycles(self) -> List[List[str]]:
        """Distinct lock-order cycles (each a [n1, n2, ..., n1] name path)."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        out: List[List[str]] = []
        seen_cycles = set()
        color: Dict[str, int] = {}  # 0 unvisited / 1 on-path / 2 done

        def dfs(node: str, path: List[str]):
            color[node] = 1
            path.append(node)
            for nxt in adj[node]:
                c = color.get(nxt, 0)
                if c == 1:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                elif c == 0:
                    dfs(nxt, path)
            path.pop()
            color[node] = 2

        for n in sorted(adj):
            if color.get(n, 0) == 0:
                dfs(n, [])
        return out

    def report(self) -> dict:
        return {
            "locks": sorted({n for e in self.edges for n in e})
            or sorted({l for ev in self.dispatch_events for l in ev["locks"]}),
            "edges": sorted(f"{a} -> {b}" for a, b in self.edges),
            "cycles": [" -> ".join(c) for c in self.cycles()],
            "dispatch_under_lock": self.dispatch_events,
        }


class TrackedLock:
    """Drop-in `threading.Lock` recording acquisition order into a LockGraph.

    Duck-typed, not subclassed (threading.Lock is a factory for an opaque
    type): exposes acquire/release/locked/__enter__/__exit__, which is the
    full surface `threading.Condition` relies on when handed a lock.
    """

    def __init__(self, graph: LockGraph, name: Optional[str] = None):
        self._graph = graph
        self.name = name or _caller_site()
        self._inner = _REAL_LOCK()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.note_acquired(self)
        return ok

    def release(self) -> None:
        self._graph.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        self.acquire()
        return True

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name}>"


@contextlib.contextmanager
def patch_threading(graph: LockGraph, site_filter: Optional[str] = None):
    """Within the block, `threading.Lock()` yields TrackedLocks.

    Patch only around the construction of the objects under test: stdlib or
    torch machinery allocating locks in the window would be tracked too.
    `site_filter` narrows tracking to locks whose allocation site contains
    the substring (e.g. ``"repro_torch/"``); other allocations get real
    locks.
    """
    orig = threading.Lock

    def make_tracked():
        if site_filter is not None and site_filter not in _caller_site():
            return orig()
        return TrackedLock(graph)

    threading.Lock = make_tracked
    try:
        yield graph
    finally:
        threading.Lock = orig


def _targets_device(args, kwargs) -> bool:
    """Whether a `Tensor.to(...)` call names a device (an upload on the card)."""
    import torch

    return "device" in kwargs or any(isinstance(a, (torch.device, str)) for a in args)


def _bound_names(orig, name: str) -> List[Tuple[object, str]]:
    """Every (port module, attribute) bound to `orig` now."""
    return [(mod, attr) for mod_name, mod in list(sys.modules.items())
            if mod is not None and mod_name.split(".")[0] == "repro_torch"
            for attr in (name,) if getattr(mod, attr, None) is orig]


@contextlib.contextmanager
def watch_dispatch(graph: LockGraph):
    """Within the block, record device dispatch performed with tracked locks
    held: `Tensor.to` with a device, and the port's dispatch functions
    wherever a port module bound them (see the module docstring)."""
    import torch

    from repro_torch.core import adapter, reranker, retrieval
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    defined: List[Tuple[object, str]] = [
        (retrieval, "topk_dense"),
        (reranker, "rerank_topk_scored"),
        (adapter, "adapter_apply"),
        (topk_kernel, "topk_sim_cuda"),
        (flash_kernel, "flash_attention_cuda"),
        (ssd_kernel, "ssd_scan_cuda"),
    ]
    saved = []

    def wrap(mod, attr, orig, name, when=None):
        def wrapped(*a, **k):
            held = graph.held_locks()
            if held and (when is None or when(a[1:], k)):
                graph.note_dispatch(name, held)
            return orig(*a, **k)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, orig))

    try:
        for mod, attr in defined:
            orig = getattr(mod, attr)
            for bound_mod, bound_attr in _bound_names(orig, attr) or [(mod, attr)]:
                wrap(bound_mod, bound_attr, orig, f"{bound_mod.__name__}.{attr}")
        wrap(torch.Tensor, "to", torch.Tensor.to, "Tensor.to", when=_targets_device)
        yield graph
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


# ----------------------------------------------------------------- CI leg


def run_scenario(
    n_tools: int = 48, dim: int = 16, seed: int = 0, iters: int = 12, device=None,
    table=None,
) -> dict:
    """Threaded swap/serve/stage-churn/guard run under full instrumentation,
    on `device` (the card by default: the fused backend's kernel), over
    `table` or `n_tools` seeded unit rows of `dim`."""
    import numpy as np

    graph = LockGraph()
    with patch_threading(graph, site_filter="repro_torch/"):
        # construction inside the patch window: every plane lock is tracked
        from repro_torch.analysis.retrace import _build_router
        from repro_torch.control.guard import GuardConfig, TableGuard
        from repro_torch.router.tooldb import ConflictError

        router, db = _build_router(n_tools, dim, seed, device=device, table=table)
        guard = TableGuard(db, GuardConfig(min_samples=4, window=16))

    rng = np.random.default_rng(seed)
    base = db.embeddings.copy()
    errors: List[str] = []

    def serve():
        try:
            for i in range(iters):
                n = [1, 3, 8][i % 3]
                queries = [
                    rng.integers(0, 50, size=3).astype(np.int64) for _ in range(n)
                ]
                for r in router.route_batch(queries):
                    # labelled feedback keeps the guard judging real state
                    guard.observe(r.table_version, r.tools, r.tools[:1])
        except Exception as exc:  # surfaced via errors
            errors.append(f"serve: {exc!r}")

    def swap():
        try:
            for i in range(iters):
                version, _ = db.snapshot()
                jitter = base + rng.normal(scale=1e-3, size=base.shape).astype(
                    np.float32
                )
                jitter /= np.linalg.norm(jitter, axis=1, keepdims=True)
                try:
                    db.swap_table(jitter, expect_current=version)
                except ConflictError:
                    pass  # lost the race: exactly the CAS contract
                guard.check()
        except Exception as exc:
            errors.append(f"swap: {exc!r}")

    def churn():
        try:
            stage_set = router.stage_set()[1]
            for _ in range(iters):
                version = router.stage_version
                try:
                    router.set_stages(stage_set, expect_version=version)
                except ConflictError:
                    pass
        except Exception as exc:
            errors.append(f"churn: {exc!r}")

    with watch_dispatch(graph):
        threads = [
            threading.Thread(target=fn, name=name)
            for name, fn in (("serve", serve), ("swap", swap), ("churn", churn))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        errors.extend(f"{t.name}: still running after 120 s" for t in threads if t.is_alive())
    router.close()

    report = graph.report()
    report["errors"] = errors
    report["device"] = str(router.device)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lockgraph",
        description="Fail on lock-order cycles or device dispatch under a lock "
        "in a threaded serve/swap/churn scenario.",
    )
    ap.add_argument("--smoke", action="store_true", help="CI-sized scenario")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    report = run_scenario(iters=args.iters, seed=args.seed, device=args.device)
    print(f"device: {report['device']}")
    print(f"tracked locks: {len(report['locks'])}")
    for e in report["edges"]:
        print(f"  order: {e}")
    ok = True
    for c in report["cycles"]:
        print(f"LOCK-ORDER CYCLE: {c}", file=sys.stderr)
        ok = False
    for ev in report["dispatch_under_lock"]:
        print(
            f"DISPATCH UNDER LOCK: {ev['fn']} while holding "
            f"{ev['locks']} on thread {ev['thread']}",
            file=sys.stderr,
        )
        ok = False
    for err in report["errors"]:
        print(f"SCENARIO ERROR: {err}", file=sys.stderr)
        ok = False
    if ok:
        print("lockgraph check OK: no cycles, no dispatch under a lock")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
