"""The port's runtime invariant checks: the retrace detector and the
lock-order checker.

Counterpart of the runtime legs of `repro/analysis` (its AST lint reads
source files, imports no JAX, and already lints the port: `python -m
repro.analysis src`):

* ``python -m repro_torch.analysis.retrace --smoke`` — sweeps batch sizes
  through `route_batch` and fails if the `topk_sim` kernel's library loads
  or its routes first launch beyond what the power-of-two buckets give, or
  at all on a second sweep;
* ``python -m repro_torch.analysis.lockgraph --smoke`` — an instrumented-
  lock run of a threaded serve/swap/stage-churn/guard scenario, failing
  on lock-order cycles or device dispatch performed while holding a lock.

Both default to the CUDA card and take ``--device cpu``. The names below
resolve on first access, so running a leg with ``-m`` imports it once.
"""
import importlib

_EXPORTS = {
    "LockGraph": "lockgraph",
    "TrackedLock": "lockgraph",
    "patch_threading": "lockgraph",
    "watch_dispatch": "lockgraph",
    "RetraceMonitor": "retrace",
    "hot_path_monitor": "retrace",
    "supports_cache_size": "retrace",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
