"""The port's invariant analyzer: AST lint, retrace detector, lock-order
checker.

Counterpart of `repro/analysis`. The router's latency story rests on
invariants generic linters cannot see: compare-and-swap-only version swaps,
atomic snapshot reads, one portable mesh layer, one bucketing function, no
device work under hot-path locks. This package enforces them without JAX
or `repro`:

* ``python -m repro_torch.analysis [paths]`` — AST lint (the catalog below).
  It only reads source and imports no torch; it takes the reference's
  flags, default paths (``src``) and baseline (``analysis_baseline.json``),
  and exits 0, 1, or 2 for an unknown rule id;
* ``python -m repro_torch.analysis.retrace --smoke`` — sweeps batch sizes
  through `route_batch` and fails if the `topk_sim` kernel's library loads
  or its routes first launch beyond what the power-of-two buckets give, or
  at all on a second sweep;
* ``python -m repro_torch.analysis.lockgraph --smoke`` — an instrumented-
  lock run of a threaded serve/swap/stage-churn/guard scenario, failing
  on lock-order cycles or device dispatch performed while holding a lock.

The two runtime legs default to the CUDA card and take ``--device cpu``.
Their names below resolve on first access, so running a leg with ``-m``
imports it once.

Rule catalog
============

The lint gives the reference's findings on any tree (the same rule, file,
line and column), except where a rule below says "the port also".

mesh-api
    *What*: raw JAX mesh-context APIs (``jax.set_mesh``,
    ``jax.sharding.use_mesh``/``get_abstract_mesh``, ``jax.make_mesh``,
    ``shard_map`` imports, ``jax._src.mesh``, ``thread_resources``) used
    outside ``common/meshctx.py``. The port also flags, there, a private
    name reached under ``torch.distributed`` (an imported module or name,
    or an attribute of a dotted chain, starting with ``_``; local names
    resolved through the module's imports), ``DTensor._*`` attributes and
    ``torch._C._*DTensor*``. Public names (``DTensor``, ``Replicate``,
    ``Shard``, ``DeviceMesh``, ``implicit_replication``) stay clean.
    *Why*: these APIs drift across JAX and torch releases; meshctx exists
    to pin the drift to one file so version bumps are a one-file diff.
    *Fix*: call ``repro_torch.common.meshctx`` (``use_mesh``,
    ``make_mesh``, ``current_mesh``, ``dtensor_run_patches``,
    ``clear_dtensor_caches``), or add what is missing there.

cas-discipline
    *What*: ``swap_table``/``rollback``/``rollback_stages`` without
    ``expect_current=``, ``set_stages`` without ``expect_version=``.
    *Why*: a bare swap silently clobbers a concurrent deployment — the
    lost-update race the versioned stores exist to refuse (ConflictError).
    *Fix*: pass the expectation from the snapshot the change was derived
    from. Receivers named ``*registry*`` are exempt (ArtifactRegistry's
    rollback is bounded-history trimming, not a serving CAS).

snapshot-discipline
    *What*: touching another object's ``_table``/``_history``/``_stages``/
    ``_stage_history``/``_swap_listeners`` outside the owning router
    modules.
    *Why*: bypassing ``snapshot()``/``stage_set()`` can observe a
    half-completed swap and mis-attribute scores to the wrong version.
    *Fix*: read through the atomic accessors.

jit-in-function, jit-static-scalar
    *What*: ``jax.jit`` applied inside a function body; a jitted function
    with an ``int``/``bool``/``str``-annotated parameter not in
    ``static_argnames``. Kept as the reference has them, for the JAX
    package: the port uses no ``torch.compile`` and no ``torch.jit``.

pow2-bucket
    *What*: hand-rolled ``1 << n.bit_length()`` bucket math outside
    ``common/bucketing.py``.
    *Why*: every batched entry point must agree on one bucketing function,
    or the retrace detector's expected-bucket set is per-module luck.
    *Fix*: ``repro_torch.common.bucketing.pow2_bucket``.

lock-dispatch
    *What*: ``jnp.*``/``jax.*``/known-jitted/``device_put`` calls lexically
    inside ``with <lock>:`` in ``router/``, ``control/``, ``learn/``,
    ``index/``. The port also flags the dispatch ``lockgraph.watch_dispatch``
    counts at run time: ``Tensor.to`` naming a device (a ``device=``
    keyword, or a positional argument that is not a dtype), ``.cuda()``,
    the kernel wrappers ``topk_sim_cuda``/``flash_attention_cuda``/
    ``ssd_scan_cuda`` (``topk_dense``, ``rerank_topk_scored`` and
    ``adapter_apply`` are known-jitted names already), and any ``torch.*``
    call given ``device=``.
    *Why*: device work under a hot-path lock stalls every contending
    thread; a compile or an upload under a lock is a p99 breach for all of
    them.
    *Fix*: compute outside the critical section, hold the lock only to
    publish (see ``ToolIndexManager._build``).

cache-version-stamp
    *What*: ``lookup_batch``/``insert_batch`` on a ``*cache*`` receiver
    without explicit ``table_version=`` AND ``stage_version=`` keywords;
    plus the lock-dispatch scan, the port's patterns included, applied to
    the ``cache/`` package.
    *Why*: the route cache's exact-invalidation guarantee holds only if
    every entry is stamped with the snapshot its scores came from; the
    cache lock is taken per routed batch.
    *Fix*: thread the versions from the same snapshot that produced the
    scores; keep cache critical sections numpy-only.

thread-discipline
    *What*: a ``daemon=True`` thread whose locally-defined loop lacks an
    ``except Exception`` handler, or has one that does not record the
    failure on an ``*error*``/``*exception*`` attribute.
    *Why*: a dead or flapping control/learning plane that no guard or
    health check can detect.
    *Fix*: record ``self.last_loop_error = exc`` (clear on success).

obs-discipline
    *What*: direct ``time.time()``/``time.perf_counter()``/
    ``time.monotonic()`` or ``print()`` calls in ``router/``, ``index/``,
    ``control/``, and ``learn/``.
    *Why*: recorded durations must share one monotonic source, and a
    serving process's stdout is not an operator surface.
    *Fix*: ``repro_torch.obs.clock``; the ``MetricsRegistry``/``EventBus``.

kernel-contract (project rule)
    *What*: a ``kernels/<name>/kernel.py`` without a ``ref.py`` oracle or
    a parity test referencing ``kernels.<name>``; top-K kernels hardcoding
    a ``<= -1e29`` padding sentinel instead of importing ``NEG_INF``. The
    port keys each kernel by its directory path: over ``src`` the JAX
    package's ``kernels/topk_sim/`` and the port's are two kernels, each
    checked (the reference keys by name and checks the last one scanned).
    *Why*: the gateway filters selected tools by ``score > NEG_INF / 2``;
    a drifted sentinel silently surfaces padding as results.
    *Fix*: add ``ref.py`` + a parity test; import
    ``repro_torch.core.retrieval.NEG_INF``.

Suppression and baseline
========================

The reference's: ``# repro: noqa[rule-id]`` on the flagged line
suppresses that rule there (``# repro: noqa`` suppresses all), so one
comment silences both lints; ``analysis_baseline.json`` (repo root), read
in the same format, grandfathers deliberate exceptions, content-matched;
stale entries are warned about. Regenerate with ``python -m
repro_torch.analysis --write-baseline``.
"""
import importlib

from repro_torch.analysis.engine import run, scan
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.rules import REGISTRY, ModuleInfo, Rule, register

_EXPORTS = {
    "LockGraph": "lockgraph",
    "TrackedLock": "lockgraph",
    "patch_threading": "lockgraph",
    "watch_dispatch": "lockgraph",
    "RetraceMonitor": "retrace",
    "hot_path_monitor": "retrace",
    "supports_cache_size": "retrace",
}

__all__ = sorted([*_EXPORTS, "Baseline", "Finding", "ModuleInfo", "REGISTRY", "Rule",
                  "register", "run", "scan"])


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
