"""Runtime retrace detector for the hot serving path.

Counterpart of `repro/analysis/retrace.py`. The reference's retrace is a
fresh XLA compile, a multi-ms stall against the 10 ms p99 budget. The
port compiles nothing with XLA; what it builds and loads is the `topk_sim`
kernel library, and CUDA loads a route's kernels at the route's first
launch. `route_batch` pads every batch into a power-of-two bucket
(`repro_torch.common.bucketing`), so a sweep of batch sizes may load the
library once and launch each route its buckets take once, ever.
`RetraceMonitor` records each tracked entry's `_cache_size()` around a
workload and reports how much it grew.

The entries come from `repro_torch.router.gateway.hot_path_jits()`: the
`topk_sim` kernel's probe (`kernels/topk_sim/kernel.py::PROBE`: the
library loaded, 0 or 1, plus the routes launched at least once). The
eager adapter and re-ranker have no probe and are listed as unsupported,
as `obs.profile.JitProfiler` lists them.

`python -m repro_torch.analysis.retrace --smoke [--device cpu]` builds a
router (fused backend, adapter stage active), sweeps the reference's batch
sizes through `route_batch` twice, and fails if the first sweep grows the
probe past its budget or the second grows it at all. The budget on the
card is read when the sweep starts: 1 if the library is not loaded yet
(building the fused backend loads it), plus the distinct routes
`topk_route` gives the sweep's padded buckets (`PROBE.route`, which
launches nothing) that have not launched yet. On the CPU the fused
backend runs the kernel's plain version and the budget is 0.
"""
from __future__ import annotations

import argparse
import sys
from typing import AbstractSet, Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["supports_cache_size", "RetraceMonitor", "hot_path_monitor", "topk_sim_budget",
           "sweep_budget", "run_scenario", "main"]

SMOKE_SIZES = [1, 2, 3, 4, 5, 7, 8, 9, 16, 3, 8, 16]


def supports_cache_size(fn) -> bool:
    """True when `fn` exposes the compile-cache probe this module needs."""
    return callable(getattr(fn, "_cache_size", None))


class RetraceMonitor:
    """Counts new loads and first launches per tracked entry across a workload.

    Usage::

        mon = RetraceMonitor()
        mon.track("topk_sim", topk_kernel.PROBE)
        with mon:
            run_workload()
        mon.check({"topk_sim": expected_max})  # -> violations

    Counting deltas (not absolute sizes) makes the monitor composable with
    anything that already warmed the process, at the cost of missing what
    happened before `__enter__`. The CLI runs it in a fresh process, where
    the delta is the absolute count.
    """

    def __init__(self):
        self._fns: Dict[str, Callable] = {}
        self._unsupported: List[str] = []
        self._before: Dict[str, int] = {}
        self._after: Optional[Dict[str, int]] = None

    def track(self, name: str, fn: Callable) -> bool:
        """Register an entry with a probe; False (and skip) if it has none."""
        if not supports_cache_size(fn):
            self._unsupported.append(name)
            return False
        self._fns[name] = fn
        return True

    @property
    def unsupported(self) -> List[str]:
        return list(self._unsupported)

    def __enter__(self):
        self._after = None
        self._before = {n: f._cache_size() for n, f in self._fns.items()}
        return self

    def __exit__(self, *exc):
        self._after = {n: f._cache_size() for n, f in self._fns.items()}
        return False

    def traces(self) -> Dict[str, int]:
        """{name: growth during the with-block}."""
        if self._after is None:
            raise RuntimeError("traces() outside a completed with-block")
        return {n: self._after[n] - self._before[n] for n in self._fns}

    def check(self, budget: Dict[str, int]) -> List[str]:
        """Human-readable violations for every tracked entry over its budget."""
        got = self.traces()
        out = []
        for name, limit in budget.items():
            if name not in got:
                continue  # unsupported or untracked: not a failure
            if got[name] > limit:
                out.append(
                    f"{name}: {got[name]} loads/first launches > expected {limit} — "
                    f"a batch escaped the power-of-two buckets (or a new route or "
                    f"library load appeared after warm-up)"
                )
        return out


def hot_path_monitor() -> RetraceMonitor:
    """Monitor pre-loaded with the route_batch hot-path entries, from
    `router.gateway.hot_path_jits` (the list `obs.profile.JitProfiler`
    reads too)."""
    from repro_torch.router.gateway import hot_path_jits

    mon = RetraceMonitor()
    for name, fn in hot_path_jits().items():
        mon.track(name, fn)
    return mon


def topk_sim_budget(batch_sizes: Sequence[int], n_tools: int, dim: int, k: int,
                    on_card: bool, loaded: bool = False,
                    launched: AbstractSet[str] = frozenset()) -> int:
    """The most the `topk_sim` probe may grow over a sweep: on the card the
    library's load unless it is `loaded`, plus the distinct routes of the
    sweep's padded buckets not in `launched`; on the CPU nothing."""
    from repro_torch.common.bucketing import expected_buckets
    from repro_torch.kernels.topk_sim.kernel import PROBE

    if not on_card:
        return 0
    routes = {PROBE.route(q, n_tools, dim, k) for q in expected_buckets(batch_sizes)}
    return (0 if loaded else 1) + len(routes - set(launched))


def sweep_budget(batch_sizes: Sequence[int], n_tools: int, dim: int, k: int,
                 on_card: bool) -> int:
    """`topk_sim_budget` from the probe's state now: call it just before the
    sweep, so a load or launch made while setting up is not budgeted."""
    from repro_torch.kernels.topk_sim import kernel

    return topk_sim_budget(batch_sizes, n_tools, dim, k, on_card,
                           loaded=kernel.LIBRARY.loads > 0, launched=kernel.launched_routes)


# ----------------------------------------------------------------- CI leg


def _build_router(n_tools: int, dim: int, seed: int, device=None, backend: str = "fused",
                  table: Optional[np.ndarray] = None):
    """A self-contained router: `backend` index, adapter stage active, over
    `table` or `n_tools` seeded unit rows of `dim`."""
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.stages import StageSet
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if table is None:
        emb = rng.normal(size=(n_tools, dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    else:
        emb = np.asarray(table, np.float32)
    n_tools, dim = emb.shape
    records = [
        ToolRecord(i, f"tool_{i}", np.arange(1, dtype=np.int64), 0)
        for i in range(n_tools)
    ]
    db = ToolsDatabase(records, emb)

    def embed_one(tokens: np.ndarray) -> np.ndarray:
        v = np.sin((np.arange(dim) + 1.0) * (1.0 + float(np.sum(tokens))))
        return (v / np.linalg.norm(v)).astype(np.float32)

    def embed_batch(batch) -> np.ndarray:
        return np.stack([embed_one(t) for t in batch])

    # a dim-matched residual head, the structure of core.adapter: the
    # identity at w2 = 0, so routing quality is irrelevant — only loads and
    # first launches are under test
    hidden = max(dim // 2, 2)
    gen = torch.Generator().manual_seed(seed + 1)
    params = {
        "w1": (torch.randn((dim, hidden), generator=gen) * 0.02).to(device),
        "b1": torch.zeros((hidden,), device=device),
        "w2": torch.zeros((hidden, dim), device=device),
        "b2": torch.zeros((dim,), device=device),
    }
    router = SemanticRouter(
        db,
        embed_fn=embed_one,
        embed_batch_fn=embed_batch,
        k=4,
        stages=StageSet(adapter_params=params, adapter_scale=0.1),
        backend=backend,
        device=device,
    )
    return router, db


def run_scenario(
    batch_sizes, n_tools: int = 48, dim: int = 16, seed: int = 0, device=None,
    table: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Sweep `batch_sizes` through route_batch twice under the hot-path
    monitor: the first sweep within `topk_sim_budget`, the second adding
    nothing.

    Returns {"traces": {...}, "second": {...}, "budget": {...},
    "violations": [...], "unsupported": [...], "buckets": [...]}.
    """
    from repro_torch.common.bucketing import expected_buckets

    router, db = _build_router(n_tools, dim, seed, device=device, table=table)
    n_tools, dim = db.embeddings.shape
    rng = np.random.default_rng(seed + 7)
    buckets = expected_buckets(batch_sizes)
    # the reranker is not configured in this scenario: zero new entries
    budget = {"topk_sim": sweep_budget(batch_sizes, n_tools, dim, router.k,
                                       router.device.type == "cuda"),
              "adapter_apply": len(buckets), "rerank_topk_scored": 0}
    sweeps = []
    try:
        for _ in range(2):
            mon = hot_path_monitor()
            with mon:
                for n in batch_sizes:
                    queries = [
                        rng.integers(0, 50, size=rng.integers(1, 6)).astype(np.int64)
                        for _ in range(n)
                    ]
                    results = router.route_batch(queries)
                    if len(results) != n:
                        raise RuntimeError(f"{len(results)} results for {n} queries")
            sweeps.append(mon)
    finally:
        router.close()
    violations = sweeps[0].check(budget)
    violations += [f"second sweep: {v}" for v in sweeps[1].check(dict.fromkeys(budget, 0))]
    return {
        "traces": sweeps[0].traces(),
        "second": sweeps[1].traces(),
        "budget": budget,
        "violations": violations,
        "unsupported": sweeps[0].unsupported,
        "buckets": buckets,
        "device": str(router.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.retrace",
        description="Fail if route_batch's hot path loads or first-launches beyond "
        "the power-of-two bucket set's routes.",
    )
    ap.add_argument(
        "--smoke", action="store_true", help="small sweep (CI default sizes)"
    )
    ap.add_argument(
        "--batch-sizes",
        default=None,
        help="comma-separated batch sizes (overrides --smoke)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--table", default=None,
                    help="a [T, D] float32 .npy tool table (default: 48 seeded rows of 16)")
    args = ap.parse_args(argv)

    if args.batch_sizes:
        sizes = [int(s) for s in args.batch_sizes.split(",") if s.strip()]
    else:
        # mixed ragged sizes sharing buckets: {1,2,3,4} -> buckets {1,2,4},
        # {5,7,8} -> {8}, {9,16} -> {16} — 5 buckets, 12 calls
        sizes = list(SMOKE_SIZES)
    table = None if args.table is None else np.load(args.table)

    report = run_scenario(sizes, seed=args.seed, device=args.device, table=table)
    print(f"device: {report['device']}")
    print(f"batch sizes: {sizes}")
    print(f"expected buckets: {report['buckets']}")
    for name, n in sorted(report["traces"].items()):
        print(f"  {name}: {n} load(s)/first launch(es), budget {report['budget'][name]}; "
              f"second sweep {report['second'][name]}")
    for name in report["unsupported"]:
        print(f"  {name}: SKIPPED (eager torch, no probe)")
    if report["violations"]:
        for v in report["violations"]:
            print(f"RETRACE VIOLATION: {v}", file=sys.stderr)
        return 1
    print("retrace check OK: the hot path loaded and first-launched within its buckets' routes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
