#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, model pool, offline OATS
pipeline and online refinement loop once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a Hopper card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX and nothing of the JAX
package `repro`. Phases, each of which fails the run by raising:

  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile the hand-written kernels from `src/repro_torch`, one
               nvcc per source, all started together;
  3. kernels — hold each kernel against its plain PyTorch version on the
               card, at the main paths' shapes and at edge cases (topk_sim
               on each of its routes that can take the inputs, cluster,
               split, wgmma and select, the wgmma and select routes also
               bitwise against the split route, select also at k = 130,
               k = T and D = 1,536, which only it takes; and flash attention
               on both its kernels: wgmma for bf16, fma for float32 and for
               bf16 with hd % 8 != 0, each launch checked against the route
               `topk_route` or `flash_route` gives; the SSD scan also on
               strided bf16 slices of one xBC tensor, as ssm_block passes
               them); the flash
               attention and SSD scan kernels also at the inputs that a
               2,048-token prompt gives them in layers 0 and 31 of
               full-width hymba-1.5b, and the whole reduced model with the
               kernels against the same model with the plain versions.
               The flash kernel and its plain version are also measured
               against float64 at the init's own attention scale, which
               the pool rescales (no tolerance: a record of why);
  4. serve   — route 600 ToolBench-like queries over a 100,000-tool table
               through `SemanticRouter(backend="fused")`, bare and with an
               adapter, in batches of 8 and of 64; re-rank at the native
               2,413 tools; a CAS table swap. Results must equal those of
               the dense backend on the card, and topk_sim must launch on
               the route `topk_route` gives each batch size (wgmma for the
               100,000-tool batches of WGMMA_MIN_Q queries and more, split
               below that) and on the cluster route for the re-ranker;
  5. pool    — serve 16 routed requests (prompts of 1,100-2,048 tokens, 16
               new tokens each) through `ContinuousBatcher` over full-width
               hymba-1.5b in bf16 (wq, wk, wv at a d_model fan-in) with 4
               slots, tool-routed at admission through the fused backend
               at the native 2,413 tools. Every
               request must get 16 tokens in the vocabulary from finite
               logits, its tools must equal the dense backend's, and each
               prefill must launch flash_attention once per layer (on the
               wgmma route, never the fma one) and ssd_scan once per layer
               and phase, and each routed batch topk_sim once (on the
               cluster route); then
               profile a second short drain for the device's
               busy and idle share, and one 2,048-token prefill alone;
  6. pipeline — fit OATS-S1, S2 and S3 (`OATSPipeline.fit` through
               `BenchmarkEvaluator`) on the card on the full MetaTool-like
               and ToolBench-like benchmarks and print NDCG@5 and Recall@1;
               the same S1 fit through the port on the CPU must make the
               same gate decision and NDCG@5 within 1e-3 (rows whose
               ranking differs counted under the near-tie rule), S2 and S3
               must fall in the band the JAX package gives over seeds 0-4;
               then serve ToolBench-like's refined table, swapped into a
               fused-backend router, at batches 8 and 64 against the dense
               backend, and with the S2 re-ranker at k = 26, whose C = 130
               candidates only topk_sim's select route takes;
  8. loop    — (run before 7) the §7.2 loop through a fused-backend router
               on the card with its bus, quality monitor and tracer:
               outcomes stream into the OutcomeStore over 6 windows of
               MetaTool-like train queries, RefinementController.step()
               refines on the card and CAS-swaps, TableGuard watches; the
               windows that swap and the versions must equal the JAX
               package's (LOOP_TRAJECTORY) and the same loop through the port
               on the CPU, NDCG@5 within S1_NDCG_ATOL; then an injected bad
               table must be flagged by drift before the guard rolls it back
               to the good table; then controller.start() refines and swaps
               on its daemon thread while the main thread serves, every
               result the exact top-5 of the table its version names, no
               step failed, no loop_error event, HealthMonitor status ok;
               then batches of 64 under a thread swapping tables every 2 ms
               at 2,413 and 100,000 tools (every result checked against its
               version's table, p99 per query under 10 ms; the whole
               batch's p50/p99 printed); then the route cache in front of
               the fused backend at 25,000 tools on Zipf traffic (zero
               stale serves, hit rate >= 0.90 and agreement >= 0.98 at
               s = 1.1; the speedup and churn p99 printed). Each leg's
               topk_sim launches must take the routes `topk_route` gives
               its block sizes: cluster at 199 and 2,413 tools, wgmma for
               the 64-query batches at 100,000, split and wgmma for the
               cache's miss blocks of 1-32 queries at 25,000;
  7. times   — CUDA-event times of each kernel, its plain version and the
               library call, beside the bound computed from this run's
               shapes (topk_sim against torch.topk(q @ t.T) in five
               alternating rounds of 200 calls, medians, at 100,000 tools
               with the wgmma and split routes forced in the same turns,
               each pass's profiler device time and the rows rescored a
               call; its routes as the table grows and, at 100,000 tools,
               as the batch grows; the host dispatch of one small call
               against its device time; flash attention's two kernels on
               the same bf16 inputs, in turns; each SSD scan phase's device
               time); per-phase p50 and per-batch p50/p99 of the gateway.

The second-to-last line is the `kernels` JSON object, the last line
`{"ok": true, "device": {...}}`. TF32 is switched off for matmuls and
convolutions: every float32 product here runs in full float32.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import gc
import json
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores, and bf16 FLOP/s on the tensor cores (a bf16
# kernel's bound counts its work at the rate the card could do it)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
NEAR_TIE = 1e-5  # adjacent plain-version scores closer than this may swap (clone
# tables; the cluster route's summation order against cuBLAS's)
SCORE_ATOL = 1e-5
N_TOOLS = 100_000
BATCH_SIZES = (8, 64)
DEVICE = "cuda"
# tolerances of tests/test_kernels.py; a bf16 SSD output may also differ by
# one bf16 ulp (2**-7 relative): both versions round one float32 value
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_ATOL = 1e-3
BF16_ULP = 2**-7
# the model pool
POOL_ARCH = "hymba-1.5b"
POOL_REQUESTS, POOL_SLOTS, POOL_NEW_TOKENS = 16, 4, 16
POOL_PROMPT_LENS = (1100, 2048)  # inclusive; all past hymba's 1,024-token window
CAPTURE_LEN = 2048  # the prompt whose layer inputs the kernels are checked at
TIME_ROUNDS = 5  # rounds in turns of a small kernel's timing (one sample moves +-20%)
CROSSOVER_T = (2413, 4096, 6144, 8192, 12288)  # cluster vs split vs wgmma route
CROSSOVER_Q = (1, 8, 9, 16, 33, 64)  # split vs wgmma route at 100,000 tools, k = 5
CROSSOVER_K = (5, 10, 16, 25)  # and as k grows, at Q = 16 and 64
# the offline pipeline: the JAX package's OATS-S2 and S3 NDCG@5 over
# PipelineConfig.seed 0-4 on each full benchmark, as [min - 0.01, max + 0.01]
# (measured on a CPU by `python tests/test_torch_pipeline.py`; the card's
# machine has no JAX). S1 has no randomness but the numpy gate split.
PIPELINE_BANDS = {
    "make_metatool_like": {"oats-s2": (0.9294, 0.9541), "oats-s3": (0.9296, 0.9568)},
    "make_toolbench_like": {"oats-s2": (0.7367, 0.7795), "oats-s3": (0.7367, 0.7795)},
}
PIPELINE_PRESETS = ("se", "oats-s1", "oats-s2", "oats-s3")
S1_NDCG_ATOL = 1e-3  # card against the port's CPU fit: matmul summation orders differ
RERANK_K = 26  # the gateway asks the backend for C = 5k = 130 > 128 candidates
# the online loop (phase 8), at benchmarks/control_bench.py's full settings:
# MetaTool-like (seed 0, 2,400 queries, 199 tools), 6 windows of train
# queries routed in batches of 64 with every routed tool's outcome recorded,
# ControllerConfig(min_events=1000, min_queries=30), GuardConfig(min_samples=32),
# held-out NDCG@5 over 400 test queries after each step. The JAX package's
# trajectory as (events, table_version, swapped, NDCG@5), the first entry
# before any step (measured on a CPU by `python tests/test_torch_control.py`;
# the card's machine has no JAX).
LOOP_TRAJECTORY = (
    (0, 0, False, 0.804511), (1400, 1, True, 0.858980), (2800, 2, True, 0.884811),
    (4200, 2, False, 0.884811), (5600, 2, False, 0.884811), (7000, 3, True, 0.894755),
    (8400, 3, False, 0.894755))
LOOP_QUERIES, LOOP_WINDOWS, LOOP_BATCH, LOOP_EVAL = 2400, 6, 64, 400
LOOP_MIN_EVENTS, LOOP_MIN_QUERIES, LOOP_MIN_SAMPLES = 1000, 30, 32
LOOP_ACT2_BASELINE = 300  # labelled test queries served on the good table first
LOOP_THREAD_INTERVAL_S, LOOP_THREAD_DEADLINE_S, LOOP_THREAD_PASSES = 0.05, 120.0, 6
BUDGET_MS = 10.0  # the paper's per-query routing budget
CHURN_BATCH, CHURN_CALLS, CHURN_SWAP_S = 64, 64, 0.002  # control_bench's churn leg
# the route cache (benchmarks/cache_bench.py's full settings)
CACHE_TOOLS, CACHE_BATCHES, CACHE_ZIPF = 25_000, 150, (0.8, 1.1, 1.4)
CACHE_QUERY_LEN, CACHE_SWAP_EVERY = 24, 15
CACHE_WARMUP = (1, 2, 4, 8, 16, 32)
CACHE_HIT_FLOOR, CACHE_AGREEMENT_FLOOR = 0.90, 0.98  # gates (s = 1.1)
CACHE_SPEEDUP_REF, CACHE_CHURN_P99_REF = 2.0, 2.5  # the reference's gates: printed only


def log(*parts) -> None:
    print(*parts, flush=True)


def same_ranking(idx_a, sc_a, idx_b, sc_b, tie: float) -> bool:
    """True when ranking `a` equals `b` up to reordering inside near-ties.

    Positions of `b` whose adjacent scores differ by less than `tie` form
    runs; `a` may order each run's members differently, and the last run
    may take in a member from just beyond the list. Every position where
    the two differ must score within `tie` in both, and every position
    within SCORE_ATOL.
    """
    idx_a, idx_b = [int(x) for x in idx_a], [int(x) for x in idx_b]
    if idx_a == idx_b:
        return True
    n = len(idx_b)
    if len(idx_a) != n or len(set(idx_a)) != n:
        return False
    diff = [abs(float(x) - float(y)) for x, y in zip(sc_a, sc_b)]
    if max(diff) > SCORE_ATOL:
        return False
    if any(diff[p] >= tie for p in range(n) if idx_a[p] != idx_b[p]):
        return False
    start = 0
    for p in range(1, n):
        if float(sc_b[p - 1]) - float(sc_b[p]) >= tie:
            if set(idx_a[start:p]) != set(idx_b[start:p]):
                return False
            start = p
    return True


def compare_topk(ks, ki, rs, ri, tie: float):
    """(max abs score error, rows that differ inside near-ties) or raise."""
    err = float((ks - rs).abs().max()) if ks.numel() else 0.0
    if err > SCORE_ATOL:
        raise AssertionError(f"scores differ by {err:.3g} > {SCORE_ATOL}")
    differ = (ki != ri).any(dim=1).nonzero().flatten().tolist()
    ks_c, ki_c, rs_c, ri_c = (x.cpu().numpy() for x in (ks, ki, rs, ri))
    for r in differ:
        if not same_ranking(ki_c[r], ks_c[r], ri_c[r], rs_c[r], tie):
            raise AssertionError(
                f"row {r}: kernel {ki_c[r].tolist()} vs plain {ri_c[r].tolist()} "
                f"(plain scores {rs_c[r].tolist()})"
            )
    return err, len(differ)


def alternating(fns: dict, rounds: int = None, iters: int = 200) -> dict:
    """{name: [ms per call, one per round]}: every function timed in each
    round by `cuda_ms`, the order reversed from one round to the next."""
    rounds = rounds or TIME_ROUNDS
    out = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            out[name].append(cuda_ms(fns[name], iters=iters))
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flop_per_s: float):
    """(ms, "bytes" | "operations"): the least time for this work."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topk_bound(n_q: int, n_t: int, d: int, k: int, rescored: int = 0):
    """{"cuda_cores": (ms, by), "tensor_cores": (ms, by)}: each input read
    once, the outputs written once; 2QTD FLOPs as float32 FMAs, or as TF32
    products on the tensor cores plus the float32 rescore of `rescored`
    (query, row) pairs (2D FLOPs each), as this run's data needed."""
    nbytes = 4 * (n_q * d + n_t * d) + n_q * k * (4 + 8)
    flops = 2 * n_q * n_t * d
    t_ops = (flops / PEAK_TF32_FLOP_PER_S + 2 * d * rescored / PEAK_F32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"cuda_cores": bound(nbytes, flops, PEAK_F32_FLOP_PER_S),
            "tensor_cores": (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")}


def flash_bound(q, k, v, causal: bool, window: int, q_offset: int):
    """q, k, v read once and the output written once; 4*hd FLOPs for every
    live (unmasked) query-key pair of every query row."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_mask

    pairs = int(attention_mask(q.shape[1], k.shape[1], causal, window, q_offset,
                               q.device).sum())
    peak = PEAK_BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else PEAK_F32_FLOP_PER_S
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return bound(nbytes, 4 * q.shape[2] * pairs * q.shape[0], peak)


def ssd_bound(x, dt, a_log, bm, cm):
    """Inputs read once, y and the float32 state written once; the least
    float32 work of the recurrence, 4*P*N FLOPs per step and head: the
    state update (x*dt) B^T as one multiply-add per state entry and the
    readout state C as another (the decay can be applied once a chunk)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    flops = 4 * b * s * h * p * n
    nbytes = (2 * x.numel() * x.element_size() + 4 * b * h * p * n
              + sum(t.numel() * t.element_size() for t in (dt, a_log, bm, cm)))
    return bound(nbytes, flops, PEAK_F32_FLOP_PER_S)


def pool_config():
    """The pool's model: hymba-1.5b at full width and depth, in its bf16."""
    from repro_torch.configs import get_config

    return get_config(POOL_ARCH)


def capture_prefill(cfg, params, tokens, wanted):
    """Run one prefill through the port's own layer functions and return
    the flash_attention and ssd_scan arguments of the layers in `wanted`:
    {"flash": {layer: (args, kwargs)}, "ssd": {...}}."""
    import torch

    from repro_torch.models import layers, model as M, ssm

    captured = {"flash": {}, "ssd": {}}
    calls = {"flash": 0, "ssd": 0}
    originals = layers.flash_attention, ssm.ssd_ops.ssd_scan

    def capture(key, fn):
        def wrapper(*args, **kwargs):
            i = calls[key]
            calls[key] += 1
            if i in wanted:
                captured[key][i] = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                          for a in args), dict(kwargs))
            return fn(*args, **kwargs)
        return wrapper

    layers.flash_attention = capture("flash", originals[0])
    ssm.ssd_ops.ssd_scan = capture("ssd", originals[1])
    try:
        logits, _ = M.prefill(cfg, params, {"tokens": tokens})
    finally:
        layers.flash_attention, ssm.ssd_ops.ssd_scan = originals
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits in the captured prefill")
    if calls != {"flash": cfg.n_layers, "ssd": cfg.n_layers}:
        raise AssertionError(f"captured prefill made {calls} kernel calls")
    return captured


@contextlib.contextmanager
def plain_kernels():
    """The model's layers call the kernels' plain versions inside the block."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import layers, ssm

    originals = layers.flash_attention, ssm.ssd_ops
    layers.flash_attention = functools.partial(flash_ops.flash_attention, use_kernel=False)
    ssm.ssd_ops = types.SimpleNamespace(
        ssd_scan=functools.partial(ssd_ops.ssd_scan, use_kernel=False))
    try:
        yield
    finally:
        layers.flash_attention, ssm.ssd_ops = originals


def port_pkg(device):
    """The port's side of the loop driver below, on `device`. The driver
    takes a package as a namespace, so a test can hand it the JAX
    package's side too."""
    import repro_torch.control as control
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.index import ToolIndexManager
    from repro_torch.obs import EventBus, QualityMonitor
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    return types.SimpleNamespace(
        control=control, Router=SemanticRouter, DB=ToolsDatabase, Record=ToolRecord,
        Bus=EventBus, Quality=QualityMonitor, Index=ToolIndexManager,
        encoder=lambda vocab: BagEncoder(vocab, device=device),
        device_kw={"device": device})


def loop_world(pkg, bench, table, backend="dense", *, min_events=LOOP_MIN_EVENTS,
               min_queries=LOOP_MIN_QUERIES, min_samples=LOOP_MIN_SAMPLES, guard_k=5,
               tolerance=0.02, wired=True, metrics=False, tracer=None):
    """One package's §7.2 serving + control plane over `table`: a router
    wired to an outcome store, a table guard and a refinement controller
    (which refines on the router's device) and, when `wired`, to a bus and
    a quality monitor that watch the database before the index does. With
    a `metrics` registry the index manager is built here and records its
    build times there; else the router owns it."""
    enc = pkg.encoder(bench.vocab)
    db = pkg.DB([pkg.Record(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
                 for i in range(bench.n_tools)], table.copy())
    bus = quality = None
    if wired:
        bus = pkg.Bus()
        quality = pkg.Quality(bus=bus)
        bus.watch_db(db)
        quality.watch_db(db)
    store = pkg.control.OutcomeStore(n_tools=len(db), capacity=200_000)
    index = None
    if metrics is not False:
        index = pkg.Index(db, backend=backend, metrics=metrics, bus=bus, **pkg.device_kw)
    router = pkg.Router(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                        outcome_sink=store.append, backend=backend, index=index,
                        metrics=metrics, bus=bus, quality=quality, tracer=tracer,
                        **pkg.device_kw)
    guard = pkg.control.TableGuard(
        db, pkg.control.GuardConfig(k=guard_k, min_samples=min_samples, tolerance=tolerance),
        bus=bus)
    controller = pkg.control.RefinementController(
        db, store, enc.encode, routers=[router],
        config=pkg.control.ControllerConfig(min_events=min_events, min_queries=min_queries),
        guard=guard, bus=bus, **pkg.device_kw)
    return types.SimpleNamespace(enc=enc, db=db, bus=bus, quality=quality, store=store,
                                 index=router.index, router=router, guard=guard,
                                 controller=controller)


def close_world(w):
    w.router.close()
    w.index.close()


def serve_window(w, bench, idx, batch_size=LOOP_BATCH, check=None):
    """Route `idx` in batches, record every routed tool's outcome, feed the
    guard and the quality monitor; `check(idx, results)` sees each batch."""
    for lo in range(0, len(idx), batch_size):
        chunk = idx[lo:lo + batch_size]
        results = w.router.route_batch([bench.query_tokens[qi] for qi in chunk])
        if check is not None:
            check(chunk, results)
        for qi, res in zip(chunk, results):
            for t in res.tools:
                w.router.record_outcome(bench.query_tokens[qi], t, int(t in bench.relevant[qi]))
            w.guard.observe(res.table_version, res.tools, bench.relevant[qi])
            if w.quality is not None:
                w.quality.observe(res.tools, bench.relevant[qi])


def heldout_ndcg(w, bench, n_eval=LOOP_EVAL):
    import numpy as np

    from repro_torch.metrics.retrieval import ndcg_at_k

    idx = bench.test_idx[:n_eval]
    results = w.router.route_batch([bench.query_tokens[qi] for qi in idx])
    return float(np.mean([ndcg_at_k(r.tools, bench.relevant[qi], 5)
                          for qi, r in zip(idx, results)]))


def run_loop(w, bench, n_windows=LOOP_WINDOWS, n_eval=LOOP_EVAL):
    """The §7.2 loop (`benchmarks/control_bench.py`'s first leg): the series
    [(events, table_version, swapped, NDCG@5)] as LOOP_TRAJECTORY, the
    first before any step; the steps' reports; the live table after each."""
    import numpy as np

    series = [(0, w.db.table_version, False, heldout_ndcg(w, bench, n_eval))]
    reports, tables = [], []
    for idx in np.array_split(bench.train_idx, n_windows):
        serve_window(w, bench, idx)
        rep = w.controller.step()
        reports.append(rep)
        tables.append(w.db.embeddings.copy())
        series.append((w.store.total_ingested, rep.table_version, rep.swapped,
                       heldout_ndcg(w, bench, n_eval)))
    return series, reports, tables


def inject_and_roll_back(w, bench, n_baseline=LOOP_ACT2_BASELINE, after_inject=None):
    """`examples/live_loop.py`'s act 2: labelled traffic on the good table,
    then a scrambled and shifted table bypasses the gate (`after_inject()`
    runs on it); shadow windows until the guard rolls it back. Returns the
    guard's actions."""
    import numpy as np

    serve_window(w, bench, bench.test_idx[:n_baseline])
    rng = np.random.default_rng(0)
    bad = w.db.embeddings.copy()
    rng.shuffle(bad, axis=0)  # tool vectors scrambled across tools
    bad += 3.0 * bad.std()  # and shifted off the query population
    w.db.swap_table(bad)
    if after_inject is not None:
        after_inject()
    actions = []
    for idx in np.array_split(bench.test_idx, 3):
        serve_window(w, bench, idx)
        rep = w.controller.step()
        actions.append(rep.guard.action)
        if rep.guard.action == "rolled_back":
            break
    return actions


def timed_on_card(fn, into):
    """`fn`, appending each call's milliseconds, between card syncs, to `into`."""
    import torch

    def call(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t) * 1e3)
        return result

    return call


def dense_top5(q_emb, table, device):
    """(indices, scores) of each query's exact top-5, in float64 on `device`."""
    import torch

    sims = (torch.from_numpy(q_emb).to(device).double()
            @ torch.from_numpy(table).to(device).double().T)
    vals, idx = torch.topk(sims, 5)
    return idx.cpu().numpy(), vals.cpu().numpy()


def loop_phase(dev, card, tb_bench, tb_enc, native, big):
    """Phase 8: the online refinement loop on the card. Returns the summary;
    raises on any failed check."""
    import numpy as np
    import torch

    from repro_torch.cache import CacheConfig, SemanticRouteCache
    from repro_torch.core.refine import refine_with_gate
    from repro_torch.data.benchmarks import make_metatool_like, scale_tool_corpus
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.index import ToolIndexManager
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs import HealthMonitor, MetricsRegistry, RouteTracer
    from repro_torch.obs.summary import percentile_stats
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase
    from repro_torch.traffic import TrafficConfig, ZipfTrafficGenerator, agreement, drive

    out = {}
    pkg = port_pkg(dev)

    def leg_routes(leg, before, table, sizes):
        """The leg's topk_sim launches by route since `before`; blocks of
        the sizes in `sizes` over `table`'s rows must have taken the routes
        topk_route gives them, each of those routes at least once."""
        got = {r: n - before[r] for r, n in topk_kernel.launches_by_route.items()}
        n_t, d = table.shape
        probe = torch.empty((1, d), device=dev)  # 16-byte aligned, as the served tensors
        want = {topk_kernel.topk_route(n, n_t, d, 5, probe, probe) for n in sizes}
        if {r for r, n in got.items() if n} != want:
            raise AssertionError(f"{leg}: topk_sim launched {got}, expected the routes "
                                 f"{sorted(want)} that topk_route gives {n_t} rows")
        return got

    # ---- (a) the §7.2 loop on the card, against the JAX trajectory and the
    # same loop through the port on the CPU
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    mt = make_metatool_like(seed=0, n_queries=LOOP_QUERIES)
    mt_table = BagEncoder(mt.vocab, device="cpu").encode(mt.desc_tokens)
    reg = MetricsRegistry()
    tracer = RouteTracer(sample_every=16, seed=0)
    w = loop_world(pkg, mt, mt_table, "fused", metrics=reg, tracer=tracer)
    refine_ms = []
    w.controller.refine_fn = timed_on_card(refine_with_gate, refine_ms)
    on_card, card_reports, _ = run_loop(w, mt)
    cpu_world = loop_world(port_pkg("cpu"), mt, mt_table)
    on_cpu, cpu_reports, _ = run_loop(cpu_world, mt)
    rows = []
    for i, (c, p, ref) in enumerate(zip(on_card, on_cpu, LOOP_TRAJECTORY, strict=True)):
        if c[:3] != ref[:3] or p[:3] != ref[:3]:
            raise AssertionError(f"loop step {i}: card {c[:3]}, port CPU {p[:3]}, JAX {ref[:3]}")
        if abs(c[3] - ref[3]) > S1_NDCG_ATOL or abs(p[3] - ref[3]) > 1e-6:
            raise AssertionError(f"loop step {i}: NDCG@5 card {c[3]:.6f}, port CPU {p[3]:.6f}, "
                                 f"JAX {ref[3]:.6f}")
        row = dict(step=i, events=c[0], table_version=c[1], swapped=c[2], ndcg5_card=c[3],
                   ndcg5_cpu=p[3], ndcg5_jax=ref[3])
        if i:
            rc, rp = card_reports[i - 1], cpu_reports[i - 1]
            if (rc.triggered, rc.accepted, rc.swapped, rc.n_queries) != (
                    rp.triggered, rp.accepted, rp.swapped, rp.n_queries):
                raise AssertionError(f"loop step {i}: card {rc.reason!r}, CPU {rp.reason!r}")
            row.update(reason=rc.reason, gate_card=[rc.recall_before, rc.recall_after],
                       gate_cpu=[rp.recall_before, rp.recall_after])
        rows.append(row)
        log(f"loop step {i}: {c[0]} events, v{c[1]} {'SWAP' if c[2] else '----'} NDCG@5 card "
            f"{c[3]:.6f} port CPU {p[3]:.6f} JAX {ref[3]:.6f}"
            + (f" | {row['reason']}" if i else ""))
    v_good, ndcg_good = w.db.table_version, on_card[-1][3]
    # live_loop.py's act 2: a scrambled, shifted table bypasses the gate; the
    # drift detector flags it label-free, then the guard rolls it back
    ndcg_bad = []
    actions = inject_and_roll_back(w, mt, after_inject=lambda: ndcg_bad.append(
        heldout_ndcg(w, mt)))
    kinds = [e.kind for e in w.bus.events()]
    ndcg_restored = heldout_ndcg(w, mt)
    if not w.guard.rollbacks or "quality_drift" not in kinds or "rollback" not in kinds:
        raise AssertionError(f"act 2: guard {actions}, bus kinds {sorted(set(kinds))}")
    if kinds.index("quality_drift") > kinds.index("rollback"):
        raise AssertionError("act 2: the guard rolled back before drift was flagged")
    if abs(ndcg_restored - ndcg_good) > 1e-6:
        raise AssertionError(f"act 2: restored NDCG@5 {ndcg_restored:.6f} != good "
                             f"{ndcg_good:.6f}")
    log(f"loop act 2: injected v{v_good + 1} (NDCG@5 {ndcg_bad[0]:.6f}); guard {actions}; bus "
        f"quality_drift (seq {w.bus.last('quality_drift').seq}) before rollback (seq "
        f"{w.bus.last('rollback').seq}); restored v{w.db.table_version} NDCG@5 "
        f"{ndcg_restored:.6f} = good {ndcg_good:.6f}")
    traces = tracer.traces()
    out["loop"] = dict(rows=rows, refine_with_gate_ms=refine_ms, act2=dict(
        guard_actions=actions, ndcg_bad=ndcg_bad[0], ndcg_restored=ndcg_restored,
        bus_kinds=kinds), traces=len(traces),
        index_build_ms=reg.histogram("index_build_ms").summary(),
        routes=leg_routes("loop", before, mt_table, range(1, LOOP_EVAL + 1)),
        seconds=time.perf_counter() - t0)
    log(f"loop: refine_with_gate on the card (main thread) ms {[round(x, 3) for x in refine_ms]}; "
        f"{len(traces)} sampled traces, paths {sorted({t.path for t in traces})}; fused index "
        f"rebuilds {w.index.stats['rebuilds']}, build ms p50 "
        f"{reg.histogram('index_build_ms').percentile(50):.3f}; topk_sim by route "
        + json.dumps(out["loop"]["routes"]) + f" on {card}")
    close_world(w)
    close_world(cpu_world)

    # the controller's daemon thread refines and swaps while the main thread
    # serves: every result must be the exact top-5 of the table its version
    # names (tables recorded by a swap listener; checked after the run, as
    # a batch may serve a version before the listener has run). A failed
    # step is recorded and cleared by the next good one, so the run fails
    # on any step that failed, not only on the last
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    reg = MetricsRegistry()
    w = loop_world(pkg, mt, mt_table, "fused", metrics=reg)
    tables = {w.db.table_version: w.db.embeddings.copy()}

    def record_table(version):
        v, t = w.db.snapshot()
        tables[v] = t

    w.db.add_swap_listener(record_table)
    daemon_ms = []
    w.controller.refine_fn = timed_on_card(refine_with_gate, daemon_ms)
    served = []

    def keep(chunk, results):
        served.append((chunk, results))

    w.controller.start(interval_s=LOOP_THREAD_INTERVAL_S)
    try:
        deadline = time.perf_counter() + LOOP_THREAD_DEADLINE_S
        passes = 0
        while time.perf_counter() < deadline:
            serve_window(w, mt, mt.train_idx, check=keep)
            passes += 1
            if any(r.swapped for r in w.controller.reports) and passes >= LOOP_THREAD_PASSES:
                break
    finally:
        w.controller.stop()
    q_cache, n_checked, n_rule = {}, 0, 0
    for chunk, results in served:
        versions = {r.table_version for r in results}
        if len(versions) != 1:
            raise AssertionError(f"threaded loop: one batch served versions {versions}")
        v = versions.pop()
        key = tuple(int(x) for x in chunk)
        if key not in q_cache:
            q_cache[key] = w.enc.encode([mt.query_tokens[qi] for qi in chunk])
        idx, sc = dense_top5(q_cache[key], tables[v], dev)
        for j, r in enumerate(results):
            if r.tools != idx[j].tolist():
                if not same_ranking(r.tools, r.scores, idx[j], sc[j], NEAR_TIE):
                    raise AssertionError(f"threaded loop v{v}: {r.tools} vs {idx[j].tolist()}")
                n_rule += 1
            n_checked += 1
    swaps = sum(r.swapped for r in w.controller.reports)
    failed = [r.reason for r in w.controller.reports if r.reason.startswith("step failed")]
    loop_errors = w.bus.counts().get("loop_error", 0)
    health = HealthMonitor(routers=[w.router], controllers=[w.controller], indexes=[w.index],
                           stores=[w.store], bus=w.bus).snapshot()
    log("loop thread health " + json.dumps(health))
    if (w.controller.last_loop_error is not None or failed or loop_errors or swaps < 1
            or health["status"] != "ok"):
        raise AssertionError(f"threaded loop: last error {w.controller.last_loop_error!r}, "
                             f"failed steps {failed}, {loop_errors} loop_error events, "
                             f"health {health['status']!r}, {swaps} swaps in "
                             f"{len(w.controller.reports)} steps")
    out["loop_thread"] = dict(passes=passes, steps=len(w.controller.reports), swaps=swaps,
                              results_checked=n_checked, near_tie_rows=n_rule,
                              refine_with_gate_ms=daemon_ms, health=health,
                              routes=leg_routes("loop thread", before, mt_table,
                                                range(1, LOOP_BATCH + 1)),
                              seconds=time.perf_counter() - t0)
    log(f"loop thread: controller.start({LOOP_THREAD_INTERVAL_S}) beside {passes} serving "
        f"passes: {len(w.controller.reports)} steps, {swaps} swaps, no step failed, no "
        f"loop_error event, health ok; {n_checked} results equal to their version's exact "
        f"top-5 (near-tie rows {n_rule}); refine_with_gate on the daemon thread ms "
        f"{[round(x, 3) for x in daemon_ms]}; topk_sim by route "
        + json.dumps(out["loop_thread"]["routes"]) + f" on {card}")
    close_world(w)

    # ---- (b) latency under churn: a thread swaps between the table and a
    # jittered copy every CHURN_SWAP_S while the main thread times batches
    q_tb = tb_enc.encode(tb_bench.query_tokens)
    churn_rows = []
    for base in (native, big):
        n_t = base.shape[0]
        jitter = base + np.random.default_rng(0).normal(scale=1e-3, size=base.shape).astype(
            np.float32)
        jitter /= np.maximum(np.linalg.norm(jitter, axis=-1, keepdims=True), 1e-9)
        refs = [dense_top5(q_tb, t, dev) for t in (base, jitter)]
        nt = tb_bench.n_tools
        db = ToolsDatabase([ToolRecord(i, f"tool_{i}", tb_bench.desc_tokens[i % nt],
                                       int(tb_bench.tool_category[i % nt])) for i in range(n_t)],
                           base)
        reg = MetricsRegistry()
        index = ToolIndexManager(db, backend="fused", metrics=reg, device=dev)
        router = SemanticRouter(db, embed_fn=tb_enc.encode_one, embed_batch_fn=tb_enc.encode,
                                k=5, index=index, metrics=False, device=dev)
        content = {db.table_version: 0}
        n_q = len(tb_bench.query_tokens)
        before = dict(topk_kernel.launches_by_route)

        def timed_pass():
            for _ in range(2):
                router.route_batch(tb_bench.query_tokens[:CHURN_BATCH])
            ms, served = [], []
            for i in range(CHURN_CALLS):
                qi = [(i * CHURN_BATCH + j) % n_q for j in range(CHURN_BATCH)]
                t = time.perf_counter()
                res = router.route_batch([tb_bench.query_tokens[j] for j in qi])
                ms.append((time.perf_counter() - t) * 1e3)
                served.append((qi, res))
            # per query as control_bench.py reports it (the batch's time over
            # its queries); every query of a batch waits the whole batch
            return (percentile_stats([m / CHURN_BATCH for m in ms]), percentile_stats(ms),
                    served)

        quiet, quiet_batch, _ = timed_pass()
        stop = threading.Event()
        swap_ms = []  # each swap_table call: the host copy and the listeners' rebuild

        def churn():
            while not stop.is_set():
                which = (len(swap_ms) + 1) % 2
                t = time.perf_counter()
                content[db.swap_table((base, jitter)[which])] = which
                swap_ms.append((time.perf_counter() - t) * 1e3)
                time.sleep(CHURN_SWAP_S)

        builds_before = reg.histogram("index_build_ms").count()
        th = threading.Thread(target=churn, daemon=True)
        th.start()
        try:
            churned, churned_batch, served = timed_pass()
        finally:
            stop.set()
            th.join()
        n_rule = 0
        for qi, res in served:
            versions = {r.table_version for r in res}
            if len(versions) != 1:
                raise AssertionError(f"churn T={n_t}: one batch served versions {versions}")
            ref_idx, ref_sc = refs[content[versions.pop()]]
            for j, r in zip(qi, res):
                if r.tools != ref_idx[j].tolist():
                    if not same_ranking(r.tools, r.scores, ref_idx[j], ref_sc[j], NEAR_TIE):
                        raise AssertionError(f"churn T={n_t}: {r.tools} vs exact "
                                             f"{ref_idx[j].tolist()}")
                    n_rule += 1
        if churned.p99_ms > BUDGET_MS:
            raise AssertionError(f"churn T={n_t}: p99 {churned.p99_ms:.3f} ms per query over "
                                 f"the {BUDGET_MS} ms budget")
        build = reg.histogram("index_build_ms")
        row = dict(n_tools=n_t, batch=CHURN_BATCH, calls=CHURN_CALLS, quiet=quiet.as_dict(),
                   churn=churned.as_dict(), quiet_batch=quiet_batch.as_dict(),
                   churn_batch=churned_batch.as_dict(), swaps=len(swap_ms),
                   swap_table_ms=percentile_stats(swap_ms).as_dict(),
                   index_builds=build.count() - builds_before,
                   index_build_ms=build.summary(), near_tie_rows=n_rule,
                   routes=leg_routes(f"churn T={n_t}", before, base, [CHURN_BATCH]))
        churn_rows.append(row)
        log(f"churn T={n_t} batch {CHURN_BATCH}: per query p50/p99 quiet {quiet.p50_ms:.4f} / "
            f"{quiet.p99_ms:.4f} ms, under churn {churned.p50_ms:.4f} / {churned.p99_ms:.4f} ms "
            f"(budget {BUDGET_MS}); whole batch p50/p99 quiet {quiet_batch.p50_ms:.3f} / "
            f"{quiet_batch.p99_ms:.3f} ms, under churn {churned_batch.p50_ms:.3f} / "
            f"{churned_batch.p99_ms:.3f} ms (not gated: each query of a batch waits the "
            f"batch); {len(swap_ms)} swaps during the run (swap_table ms p50 "
            f"{row['swap_table_ms']['p50_ms']:.3f}), {row['index_builds']} fused rebuilds, build "
            f"ms p50 {build.percentile(50):.3f} p99 {build.percentile(99):.3f}; every result "
            f"the exact top-5 of its version's table (near-tie rows {n_rule}); topk_sim by "
            f"route " + json.dumps(row["routes"]) + f" on {card}")
        index.close()
    out["churn"] = churn_rows

    # ---- (c) the route cache in front of the fused backend
    t0 = time.perf_counter()
    cb = make_metatool_like(seed=0, n_queries=400)
    cb_enc = BagEncoder(cb.vocab, device=dev)
    table = scale_tool_corpus(cb_enc.encode(cb.desc_tokens), CACHE_TOOLS, seed=0, noise=0.2)
    records = [ToolRecord(i, f"t{i}", cb.desc_tokens[i % cb.n_tools], 0)
               for i in range(CACHE_TOOLS)]
    pool = [np.tile(t, -(-CACHE_QUERY_LEN // len(t)))
            for t in (cb.query_tokens[i] for i in cb.train_idx)]

    def build(cache, metrics=False):
        db = ToolsDatabase(list(records), table.copy())
        return SemanticRouter(db, embed_fn=cb_enc.encode_one, embed_batch_fn=cb_enc.encode,
                              k=5, backend="fused", metrics=metrics, cache=cache, device=dev)

    def warm(router, batch, cache=None):
        for m in CACHE_WARMUP:
            router.route_batch(batch[:m])
        if cache is not None:
            cache.clear()

    def traffic(zipf_s, **kw):
        cfg = TrafficConfig(zipf_s=zipf_s, pool_size=256, query_len=CACHE_QUERY_LEN,
                            batch_size=32, paraphrase_p=0.35, jitter_tokens=1, seed=3, **kw)
        return cfg, list(ZipfTrafficGenerator(cfg, pool=pool).stream(CACHE_BATCHES))

    before = dict(topk_kernel.launches_by_route)
    cache_rows = []
    for zipf_s in CACHE_ZIPF:
        _, batches = traffic(zipf_s)
        cache = SemanticRouteCache(CacheConfig(threshold=0.95), metrics=False)
        cached, bare = build(cache), build(None)
        warm(cached, batches[0], cache)
        warm(bare, batches[0])
        with no_gc():
            rep_c = drive(cached, batches, record=True)
        with no_gc():
            rep_b = drive(bare, batches, record=True)
        row = dict(zipf_s=zipf_s, queries=rep_c.queries, hit_rate=rep_c.hit_rate,
                   qps_cached=rep_c.qps, qps_bare=rep_b.qps, speedup=rep_c.qps / rep_b.qps,
                   agreement=agreement(rep_c.results, rep_b.results),
                   p50_cached_ms=rep_c.p50_ms, p99_cached_ms=rep_c.p99_ms,
                   p50_bare_ms=rep_b.p50_ms, p99_bare_ms=rep_b.p99_ms,
                   stale_serves=rep_c.stale_serves + rep_b.stale_serves)
        cache_rows.append(row)
        log(f"cache s={zipf_s}: hit {row['hit_rate']:.4f}, agreement {row['agreement']:.4f}, "
            f"qps {row['qps_cached']:.0f} cached vs {row['qps_bare']:.0f} bare "
            f"({row['speedup']:.3f}x), batch p99 {row['p99_cached_ms']:.3f} vs "
            f"{row['p99_bare_ms']:.3f} ms, stale {row['stale_serves']} on {card}")
        cached.close()
        bare.close()
    # churn: hot-set rotations plus content-identical swaps, rollbacks and
    # stage promotions between batches; the gateway's tripwire counts too
    cfg, batches = traffic(1.1, hot_set_rotate_every=2 * CACHE_SWAP_EVERY)
    creg = MetricsRegistry()
    cache = SemanticRouteCache(CacheConfig(threshold=0.95), metrics=False)
    router = build(cache, metrics=creg)
    warm(router, batches[0], cache)
    ops = {"table_swap": 0, "rollback": 0, "stage_swap": 0}

    def control_churn(i):
        if i == 0 or i % CACHE_SWAP_EVERY:
            return
        step = (i // CACHE_SWAP_EVERY) % 3
        if step == 0:
            version, live = router.db.snapshot()
            router.db.swap_table(live.copy(), expect_current=version)
            ops["table_swap"] += 1
        elif step == 1 and router.db.retained_versions():
            router.db.rollback(expect_current=router.db.table_version)
            ops["rollback"] += 1
        else:
            sv, stages = router.stage_set()
            router.set_stages(stages, expect_version=sv)
            ops["stage_swap"] += 1

    with no_gc():
        rep = drive(router, batches, on_batch=control_churn)
    tripwire = int(creg.counter("route_cache_stale_served_total").value())
    router.close()
    s11 = next(r for r in cache_rows if r["zipf_s"] == 1.1)
    churn_ratio = rep.p99_ms / s11["p99_bare_ms"]
    stale = sum(r["stale_serves"] for r in cache_rows) + rep.stale_serves
    out["cache"] = dict(n_tools=CACHE_TOOLS, rows=cache_rows, churn=dict(
        hit_rate=rep.hit_rate, qps=rep.qps, p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
        stale_serves=rep.stale_serves, tripwire=tripwire, ops=ops,
        invalidated=cache.stats["invalidated"]), churn_p99_over_bare=churn_ratio,
        stale_total=stale, seconds=time.perf_counter() - t0,
        routes=leg_routes("cache", before, table, range(1, 33)))
    log(f"cache churn: hit {rep.hit_rate:.4f}, batch p99 {rep.p99_ms:.3f} ms ({churn_ratio:.3f}x "
        f"bare; the reference's gate <= {CACHE_CHURN_P99_REF}x, not gated here), ops {ops}, "
        f"invalidated {cache.stats['invalidated']}, stale {rep.stale_serves}, "
        f"route_cache_stale_served_total {tripwire}; topk_sim by route (miss blocks of 1-32 "
        f"queries) " + json.dumps(out["cache"]["routes"]))
    log(f"cache s=1.1: speedup {s11['speedup']:.3f}x (the reference's gate >= "
        f"{CACHE_SPEEDUP_REF}x, not gated here), hit {s11['hit_rate']:.4f} (gate >= "
        f"{CACHE_HIT_FLOOR}), agreement {s11['agreement']:.4f} (gate >= "
        f"{CACHE_AGREEMENT_FLOOR}), stale {stale} (gate 0)")
    if stale or tripwire or s11["hit_rate"] < CACHE_HIT_FLOOR or (
            s11["agreement"] < CACHE_AGREEMENT_FLOOR):
        raise AssertionError(f"cache gates: stale {stale}, tripwire {tripwire}, hit "
                             f"{s11['hit_rate']:.4f}, agreement {s11['agreement']:.4f}")
    return out


@contextlib.contextmanager
def no_gc():
    """Collector pauses land on arbitrary batches and a short stream's p99
    is its max: collect first, then pause the collector."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def unit_rows(n, d, gen):
    import torch

    x = torch.randn((n, d), generator=gen, device=DEVICE)
    return (x / x.norm(dim=1, keepdim=True)).contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import convert
    from repro_torch.core.adapter import DIM, HIDDEN
    from repro_torch.core.features import OutcomeFeaturizer
    from repro_torch.core.evaluate import BenchmarkEvaluator
    from repro_torch.core.refine import RefineConfig, refine_with_gate
    from repro_torch.common.bucketing import pad_amount
    from repro_torch.core.reranker import LAYERS, rerank_topk_scored
    from repro_torch.core.retrieval import NEG_INF, topk_dense
    from repro_torch.data.benchmarks import (make_metatool_like, make_toolbench_like,
                                             scale_tool_corpus)
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.kernels.topk_sim.ref import topk_sim_ref
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.router.gateway import PHASES, SemanticRouter
    from repro_torch.router.scheduler import ContinuousBatcher, Request
    from repro_torch.router.stages import StageSet
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    t_start = time.perf_counter()
    # ---------------------------------------------------------------- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # ----------------------------------------------------------------- 2. build
    kernel_modules = {"topk_sim": topk_kernel, "flash_attention": flash_kernel,
                      "ssd_scan": ssd_kernel}
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernel_modules)) as pool:
        # one nvcc per source, all running together; a failed build raises here
        list(pool.map(lambda mod: mod.LIBRARY.load(), kernel_modules.values()))
    for name, mod in kernel_modules.items():
        info = mod.build_info
        log(f"build: {name} ready after {info['seconds']:.2f} s (cached={info['cached']}) "
            f"-> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"build: all kernels in {time.perf_counter() - t_build:.2f} s")

    # --------------------------------------------------- 3. kernels vs plain
    max_err = 0.0
    checks = []

    def check(name, q, t, k, tie=None, route=None):
        """Kernel against plain version: scores within SCORE_ATOL; indices
        exactly equal, or (clone tables, `tie` given) equal up to
        reordering inside adjacent plain-version scores closer than `tie`.
        The launch must take `route` (forced) or the one `topk_route` gives.
        Returns the kernel's (scores, indices)."""
        nonlocal max_err
        want = route or topk_kernel.topk_route(q.shape[0], t.shape[0], q.shape[1], k, t, q)
        before = dict(topk_kernel.launches_by_route)
        topk_kernel.reset_rescored()
        ks, ki = topk_kernel.topk_sim_cuda(q, t, k, route=route)
        torch.cuda.synchronize()
        n_launch = 1 if want == "cluster" else 2
        if topk_kernel.launches_by_route != {**before, want: before[want] + n_launch}:
            raise AssertionError(f"{name}: topk_sim not launched on the {want} route")
        n_rescored = topk_kernel.rescored() if want == "wgmma" else None
        rs, ri = topk_sim_ref(q, t, k)
        if tie is None and want == "cluster":
            # the cluster kernel sums each product over a tree of lanes, the
            # plain version in cuBLAS's order: they may swap float32 near-ties
            tie = NEAR_TIE
        if tie is None:
            if not torch.equal(ki, ri):
                raise AssertionError(f"{name} ({want}): indices differ from the plain version")
            err, n_tie_rows = compare_topk(ks, ki, rs, ri, 0.0)
            rule = "indices exact"
        else:
            err, n_tie_rows = compare_topk(ks, ki, rs, ri, tie)
            rule = f"rows reordered inside near-ties (<{tie:g}): {n_tie_rows}"
        max_err = max(max_err, err)
        checks.append(dict(case=name, route=want, shape=[q.shape[0], t.shape[0], q.shape[1], k],
                           max_abs_err=err, near_tie_rows=n_tie_rows, rescored=n_rescored))
        log(f"kernel check {name} {want} Q={q.shape[0]} T={t.shape[0]} D={q.shape[1]} k={k}: "
            f"max|ds|={err:.3g}, {rule}"
            + (f"; {n_rescored} (query, row) pairs rescored" if want == "wgmma" else ""))
        return ks, ki

    def check_routes(name, q, t, k, tie=None):
        """`check` on the route topk_route gives, then forced on every other
        route that can take the inputs; the wgmma route's scores and indices
        must equal the split route's bitwise."""
        chosen = topk_kernel.topk_route(q.shape[0], t.shape[0], q.shape[1], k, t, q)
        got = {chosen: check(name, q, t, k, tie=tie)}
        for r in topk_kernel.ROUTES:
            if r != chosen and topk_kernel.can_take(r, q, t, k):
                got[r] = check(name, q, t, k, tie=tie, route=r)
        if "wgmma" in got:
            (ws, wi), (ss, si) = got["wgmma"], got["split"]
            if not (torch.equal(ws, ss) and torch.equal(wi, si)):
                raise AssertionError(f"{name}: the wgmma route is not bitwise the split route")
            log(f"kernel check {name} Q={q.shape[0]} T={t.shape[0]} k={k}: wgmma route "
                f"bitwise equal to the split route")
        if "select" in got and "split" in got:
            (xs, xi), (ss, si) = got["select"], got["split"]
            if not (torch.equal(xs, ss) and torch.equal(xi, si)):
                raise AssertionError(f"{name}: the select route is not bitwise the split route")

    # each shape on the route topk_route gives it, then forced on the others
    # that can take it; D = 130 can only take the split route (D % 4 != 0)
    for n_q, n_t, d, k in [(1, 2413, 384, 5), (8, 2413, 384, 25), (64, 2413, 384, 25),
                           (33, 2047, 384, 128), (64, 300, 384, 5),
                           (8, topk_kernel.CLUSTER_MAX_T, 384, 25),
                           (1, topk_kernel.CLUSTER_MAX_T + 1, 384, 32), (64, 100_000, 384, 25),
                           (128, 100_000, 384, 5), (33, 100_003, 384, 25),
                           (8, 100_000, 384, 5), (16, 100_003, 384, 1),
                           (64, 100_000, 384, 5), (64, 100_000, 384, topk_kernel.WGMMA_MAX_K),
                           (5, 300, 64, 128), (8, 2413, 130, 25),
                           # the loop phase's: 199 tools, the cache's 25,000
                           (64, 199, 384, 5), (8, 199, 384, 5), (32, 25_000, 384, 5),
                           (8, 25_000, 384, 5)]:
        q, t = unit_rows(n_q, d, gen), unit_rows(n_t, d, gen)
        check_routes("random", q, t, k)
        if (n_q, n_t, k) == (33, 100_003, 25):  # all-zero rows, as the gateway pads a batch
            q = torch.cat([q[:24], torch.zeros((8, d), device=dev)]).contiguous()
            check_routes("zero-padded", q, t, 5)
        if d % 4 != 0 and topk_kernel.topk_route(n_q, n_t, d, k, t, q) != "split":
            raise AssertionError(f"D={d} must take the split route")
    # what only the select route takes: k past 128 (the re-ranker's C = 130
    # at k = 26), k = T, D past 1,024; its FMA chain and cuBLAS may order
    # float32 near-ties apart, so the near-tie rule applies
    for n_q, n_t, d, k in [(64, 2413, 384, 130), (8, 2413, 384, 130), (8, 2413, 384, 2413),
                           (8, 2413, 1536, 25), (33, 100_003, 384, 130)]:
        q, t = unit_rows(n_q, d, gen), unit_rows(n_t, d, gen)
        if topk_kernel.topk_route(n_q, n_t, d, k, t, q) != "select":
            raise AssertionError(f"k={k} D={d} must take the select route")
        check_routes("select", q, t, k, tie=NEAR_TIE)
    # one-hot rows tiled so that bitwise ties cross every tile, slice and
    # split boundary: lowest-index-first is the only right order
    base = torch.zeros((9, 128), device=dev)
    base[torch.arange(9), torch.arange(9)] = 1.0
    for reps in (11_111, topk_kernel.CLUSTER_MAX_T // 9):
        ties = base.repeat(reps, 1).contiguous()
        for n_q, k in [(40, 8), (4, 128), (4, 200)]:  # k = 200: the select route alone
            q = unit_rows(n_q, 128, gen)
            for route in topk_kernel.ROUTES:
                if not topk_kernel.can_take(route, q, ties, k):
                    continue
                ks, ki = topk_kernel.topk_sim_cuda(q, ties, k, route=route)
                rs, ri = topk_sim_ref(q, ties, k)
                if not torch.equal(ki, ri):
                    raise AssertionError(f"tie order differs from the plain version ({route})")
                best = q[:, :9].argmax(dim=1)
                if not torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=dev)[None, :]):
                    raise AssertionError(f"ties not resolved to the lowest index ({route})")
                err = float((ks - rs).abs().max())
                max_err = max(max_err, err)
                checks.append(dict(case="ties", route=route, shape=[n_q, ties.shape[0], 128, k],
                                   max_abs_err=err, near_tie_rows=0))
                log(f"kernel check ties {route} Q={n_q} T={ties.shape[0]} k={k}: exact, "
                    f"max|ds|={err:.3g}")

    flash_checks, ssd_checks = [], []

    def check_flash(name, q, k, v, causal=True, window=0, q_offset=0, route=None):
        """Kernel against plain version within FLASH_ATOL of the dtype; the
        launch must take the route `flash_route` gives (or `route`, forced)."""
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want = route or flash_kernel.flash_route(q.dtype, q.shape[2], q, k, v)
        before = dict(flash_kernel.launches_by_route)
        got = flash_kernel.flash_attention_cuda(q, k, v, route=route, **kw)
        torch.cuda.synchronize()
        if flash_kernel.launches_by_route != {**before, want: before[want] + 1}:
            raise AssertionError(f"flash_attention {name}: not launched on the {want} route")
        ref = attention_ref(q, k, v, **kw)
        dtype = str(q.dtype).replace("torch.", "")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name}: non-finite output ({want})")
        err = float((got.float() - ref.float()).abs().max())
        if not err <= FLASH_ATOL[dtype]:
            raise AssertionError(f"flash_attention {name}: max|d|={err:.3g} > "
                                 f"{FLASH_ATOL[dtype]} ({dtype}, {want})")
        flash_checks.append(dict(case=name, dtype=dtype, route=want, bh=q.shape[0],
                                 bhkv=k.shape[0], sq=q.shape[1], skv=k.shape[1], hd=q.shape[2],
                                 **kw, max_abs_err=err, atol=FLASH_ATOL[dtype]))
        log(f"kernel check flash_attention {name} {dtype} {want} q{list(q.shape)} "
            f"kv{list(k.shape)} {kw}: max|d|={err:.3g} (atol {FLASH_ATOL[dtype]})")

    def check_ssd(name, x, dt, a_log, bm, cm, chunk):
        """y within SSD_ATOL (+ one bf16 ulp when y is bf16), state within
        SSD_ATOL, against the plain version; one launch per phase."""
        before = ssd_kernel.launches
        y, st = ssd_kernel.ssd_scan_cuda(x, dt, a_log, bm, cm, chunk)
        torch.cuda.synchronize()
        if ssd_kernel.launches != before + len(ssd_kernel.PHASES):
            raise AssertionError(f"ssd_scan {name}: {ssd_kernel.launches - before} launches")
        ry, rst = ssd_scan_ref(x, dt, a_log, bm, cm, chunk)
        rtol = BF16_ULP if x.dtype == torch.bfloat16 else 0.0
        dy = (y.float() - ry.float()).abs()
        ok_y = bool((dy <= SSD_ATOL + rtol * ry.float().abs()).all())
        err_y, err_st = float(dy.max()), float((st - rst).abs().max())
        if not (ok_y and err_st <= SSD_ATOL):
            raise AssertionError(f"ssd_scan {name}: max|dy|={err_y:.3g}, "
                                 f"max|dstate|={err_st:.3g} (atol {SSD_ATOL}, rtol {rtol})")
        dtype = str(x.dtype).replace("torch.", "")
        ssd_checks.append(dict(case=name, dtype=dtype, bc_dtype=str(bm.dtype)[6:],
                               shape=list(x.shape), g=bm.shape[2], n=bm.shape[3], chunk=chunk,
                               bc_contiguous=bm.is_contiguous(),
                               max_abs_err_y=err_y, max_abs_err_state=err_st, atol=SSD_ATOL,
                               rtol_y=rtol))
        log(f"kernel check ssd_scan {name} {dtype} x{list(x.shape)} B/C {bm.dtype} "
            f"{'contiguous' if bm.is_contiguous() else 'strided'} G={bm.shape[2]} "
            f"N={bm.shape[3]} chunk={chunk}: max|dy|={err_y:.3g} "
            f"max|dstate|={err_st:.3g}")

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # the shapes of tests/test_kernels.py, then grouped-query attention and
    # ragged edges, in float32 (the fma route) and bf16 (the wgmma route)
    for case, bh, bhkv, sq, skv, hd, causal, window, q_offset in [
            ("test_kernels", 2, 2, 128, 128, 64, True, 0, 0),
            ("test_kernels", 3, 3, 200, 200, 64, True, 0, 0),
            ("test_kernels", 2, 2, 256, 256, 128, True, 64, 0),
            ("test_kernels", 1, 1, 1, 300, 64, True, 0, 299),
            ("test_kernels", 2, 2, 128, 128, 80, False, 0, 0),
            ("test_kernels", 1, 1, 96, 160, 64, True, 0, 64),
            ("gqa", 8, 4, 77, 77, 64, True, 16, 0),
            ("ragged", 2, 2, 77, 200, 64, False, 0, 0),
            ("ragged", 3, 1, 130, 260, 128, True, 70, 130),
            ("ragged", 2, 2, 300, 300, 80, True, 100, 0)]:
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(case, randn(bh, sq, hd, dtype=dtype), randn(bhkv, skv, hd, dtype=dtype),
                        randn(bhkv, skv, hd, dtype=dtype), causal, window, q_offset)
    # bf16 the wgmma kernel cannot take (hd % 8 != 0) goes to the fma kernel
    check_flash("hd 36", *(randn(4, 150, 36, dtype=torch.bfloat16) for _ in range(3)), True, 64)
    for b, s_len, h, p, g, n, chunk in [(2, 256, 4, 64, 1, 128, 64), (1, 512, 8, 64, 2, 64, 128),
                                        (2, 128, 2, 32, 1, 16, 32)]:
        check_ssd("test_kernels", randn(b, s_len, h, p),
                  0.1 + 0.5 * torch.rand((b, s_len, h), generator=gen, device=dev),
                  randn(h, scale=0.5), randn(b, s_len, g, n, scale=0.3),
                  randn(b, s_len, g, n, scale=0.3), chunk)
    # as ssm_block passes them: x, B and C column slices of one xBC tensor
    # (bf16 and strided), G < H, several tiles a sequence and a ragged tile
    for b, s_len, h, p, g, n, chunk, dtype in [(2, 384, 8, 64, 2, 16, 128, torch.bfloat16),
                                               (1, 2048, 50, 64, 1, 16, 256, torch.bfloat16),
                                               (1, 320, 6, 32, 3, 24, 32, torch.float32)]:
        xbc = randn(b, s_len, h * p + 2 * g * n, dtype=dtype)
        xbc[..., h * p:] *= 0.3  # B and C at the scale of the cases above
        x = xbc[..., :h * p].reshape(b, s_len, h, p)
        bm = xbc[..., h * p:h * p + g * n].reshape(b, s_len, g, n)
        cm = xbc[..., h * p + g * n:].reshape(b, s_len, g, n)
        dt = 0.1 + 0.5 * torch.rand((b, s_len, h), generator=gen, device=dev)
        check_ssd("xBC slices", x, dt, randn(h, scale=0.5), bm, cm, chunk)

    # the pool's model; its prefill gives the kernels their main-path inputs
    t0 = time.perf_counter()
    pool_cfg = pool_config()
    own_params = M.init(pool_cfg, gen, device=dev)
    torch.cuda.synchronize()
    log(f"pool model: {pool_cfg.name} {pool_cfg.n_layers} layers d_model={pool_cfg.d_model} "
        f"{pool_cfg.dtype}, {pool_cfg.param_count() / 1e9:.3f} B params, initialised from a "
        f"seeded generator on the card in {time.perf_counter() - t0:.1f} s")
    last = pool_cfg.n_layers - 1
    capture_tokens = torch.randint(0, pool_cfg.vocab_size, (1, CAPTURE_LEN), generator=gen,
                                   device=dev)
    # why the pool rescales wq, wk, wv: at the init's own heads-axis fan-in
    # (ROADMAP.md queue 3) the logits are large, and kernel and plain
    # version, both float32 logits, are measured against float64 here
    conditioning = []
    own = capture_prefill(pool_cfg, own_params, capture_tokens, {0, last})
    for layer in (0, last):
        (q, k, v), kw = own["flash"][layer]
        g = q.shape[0] // k.shape[0]
        logit_max = max(float((q[h].float() @ k[h // g].float().T).abs().max())
                        for h in range(q.shape[0])) / q.shape[2] ** 0.5
        exact = attention_ref(q.double(), k.double(), v.double(), **kw)
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = flash_kernel.flash_attention_cuda(qd, kd, vd, **kw).double()
            plain = attention_ref(qd, kd, vd, **kw).double()
            name = str(dtype).replace("torch.", "")
            row = dict(layer=layer, dtype=name, max_abs_logit=logit_max,
                       max_abs_out=float(exact.abs().max()),
                       kernel_vs_plain=float((got - plain).abs().max()),
                       kernel_vs_float64=float((got - exact).abs().max()),
                       plain_vs_float64=float((plain - exact).abs().max()),
                       atol=FLASH_ATOL[name])
            conditioning.append(row)
            log(f"init fan-in: layer {layer} {name}, max|logit| {logit_max:.1f}, max|out| "
                f"{row['max_abs_out']:.3g}: kernel vs plain {row['kernel_vs_plain']:.3g}, "
                f"kernel vs float64 {row['kernel_vs_float64']:.3g}, plain vs float64 "
                f"{row['plain_vs_float64']:.3g} (the checks' atol {FLASH_ATOL[name]}; "
                f"measured, not held to it)")
    del own, exact
    pool_params = M.attention_at_d_model_fan_in(pool_cfg, own_params)
    del own_params
    log("pool model: wq, wk, wv rescaled to a d_model fan-in (unit-scale logits)")
    captured = capture_prefill(pool_cfg, pool_params, capture_tokens, {0, last})
    for layer in (0, last):
        (q, k, v), kw = captured["flash"][layer]
        check_flash(f"{pool_cfg.name} layer {layer}", q, k, v, **kw)
        check_flash(f"{pool_cfg.name} layer {layer} on the fma kernel", q, k, v, **kw,
                    route="fma")
        check_flash(f"{pool_cfg.name} layer {layer} in float32", q.float(), k.float(),
                    v.float(), **kw)
        args, _ = captured["ssd"][layer]
        check_ssd(f"{pool_cfg.name} layer {layer}", *args)
        check_ssd(f"{pool_cfg.name} layer {layer} in float32",
                  *(a.float() if isinstance(a, torch.Tensor) else a for a in args))

    # the whole model, reduced, with the kernels against the plain versions
    small = reduced(pool_cfg, n_kv_heads=2, sliding_window=16)
    small_params = M.attention_at_d_model_fan_in(small, M.init(small, gen, device=dev))
    toks = torch.randint(0, small.vocab_size, (2, 40), generator=gen, device=dev)

    def run_small():
        logits, cache = M.prefill(small, small_params, {"tokens": toks[:, :36]},
                                  max_cache_len=48)
        outs = [logits]
        for pos in range(36, 40):
            logits, cache = M.decode_step(small, small_params, cache,
                                          {"token": toks[:, pos:pos + 1], "pos": pos})
            outs.append(logits)
        return outs + [cache[key] for key in sorted(cache)]

    with_kernels = run_small()
    with plain_kernels():
        with_plain = run_small()
    model_err = max(float((a - b).abs().max()) for a, b in zip(with_kernels, with_plain))
    for a, b in zip(with_kernels, with_plain):
        torch.testing.assert_close(a, b, atol=SSD_ATOL, rtol=SSD_ATOL)
    log(f"model check {small.name} (kv-heads 2, window 16, float32): prefill + 4 decode "
        f"steps with the kernels equal the plain versions, max|d|={model_err:.3g} "
        f"(atol = rtol = {SSD_ATOL})")

    # ------------------------------------------------------ 4. the serving path
    t0 = time.perf_counter()
    bench = make_toolbench_like(seed=0)
    enc = BagEncoder(bench.vocab, device=dev)
    native = enc.encode(bench.desc_tokens)
    big = scale_tool_corpus(native, N_TOOLS, seed=0)
    q_all = enc.encode(bench.query_tokens)
    log(f"data: ToolBench-like {bench.n_tools} tools / {bench.n_queries} queries, "
        f"scaled to {big.shape[0]} tools ({big.nbytes / 1e6:.1f} MB f32) in "
        f"{time.perf_counter() - t0:.1f} s")
    # clone tables: near-ties within 1e-5 are real here, so the rule applies
    for n_q, k in [(64, 25), (64, 5), (8, 5)]:
        check_routes("clones", torch.from_numpy(q_all[:n_q]).to(dev),
                     torch.from_numpy(big).to(dev), k, tie=NEAR_TIE)

    def records(n):
        nt = bench.n_tools
        return [ToolRecord(i, f"tool_{i}", bench.desc_tokens[i % nt],
                           int(bench.tool_category[i % nt])) for i in range(n)]

    db = ToolsDatabase(records(N_TOOLS), big)
    rng = np.random.default_rng(0)
    adapter = {
        "w1": (rng.normal(size=(DIM, HIDDEN)) * np.sqrt(2.0 / DIM)).astype(np.float32),
        "b1": (rng.normal(size=(HIDDEN,)) * 0.01).astype(np.float32),
        "w2": (rng.normal(size=(HIDDEN, DIM)) * 0.05).astype(np.float32),
        "b2": (rng.normal(size=(DIM,)) * 0.01).astype(np.float32),
    }
    mlp = {}
    for li, (din, dout) in enumerate(zip(LAYERS[:-1], LAYERS[1:])):
        mlp[f"w{li}"] = (rng.normal(size=(din, dout)) * np.sqrt(2.0 / din)).astype(np.float32)
        mlp[f"b{li}"] = (rng.normal(size=(dout,)) * 0.1).astype(np.float32)
    train = bench.train_idx
    train_toks = [bench.query_tokens[j] for j in train]
    retrieved = np.argsort(-(q_all[train] @ native.T), axis=1, kind="stable")[:, :5]
    featurizer = OutcomeFeaturizer.fit(q_all[train], train_toks,
                                       bench.relevance_matrix()[train], retrieved,
                                       bench.tool_category)
    stage_sets = {
        "bare": None,
        "adapter": convert.stages_from_jax(adapter_params=adapter, device=dev),
        "rerank": convert.stages_from_jax(mlp_params=mlp, featurizer=featurizer, device=dev),
    }
    db_native = ToolsDatabase(records(bench.n_tools), native)

    def router(table_db, backend, stages, registry=False):
        r = SemanticRouter(table_db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode,
                           k=5, backend=backend, stages=stages, metrics=registry,
                           device=dev)
        if not r.index.wait_ready():
            raise AssertionError(f"{backend} index never became fresh")
        return r

    def serve(r, bs):
        """Route every query in batches of `bs`; (results, per-batch ms)."""
        out, ms = [], []
        for s in range(0, bench.n_queries, bs):
            t = time.perf_counter()
            out.extend(r.route_batch(bench.query_tokens[s:s + bs]))
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    def agree(a, b, what):
        """Fused results against dense ones: same versions, same ranking up
        to reordering inside near-ties; returns rows that used the rule."""
        n_rule = 0
        for x, y in zip(a, b, strict=True):
            if (x.table_version, x.stage_version) != (y.table_version, y.stage_version):
                raise AssertionError(f"{what}: versions differ")
            if x.tools != y.tools:
                if not same_ranking(x.tools, x.scores, y.tools, y.scores, NEAR_TIE):
                    raise AssertionError(f"{what}: {x.tools} vs dense {y.tools}")
                n_rule += 1
            elif max(abs(s - t) for s, t in zip(x.scores, y.scores)) > SCORE_ATOL:
                raise AssertionError(f"{what}: scores differ")
        return n_rule

    runs, profiled = [], []
    topk_kernel.launches = 0  # main path starts: count only its launches
    topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
    topk_kernel.reset_rescored()
    t_serve = time.perf_counter()
    for cfg in ("bare", "adapter", "rerank"):
        table_db = db_native if cfg == "rerank" else db
        dense = router(table_db, "dense", stage_sets[cfg])
        for bs in BATCH_SIZES:
            reg = MetricsRegistry()
            fused = router(table_db, "fused", stage_sets[cfg], reg)
            fused.route_batch(bench.query_tokens[:bs])  # warm-up, not timed
            res, ms = serve(fused, bs)
            if fused.index.last_path() != "index:fused":
                raise AssertionError(f"{cfg}/{bs}: served by {fused.index.last_path()}")
            ref, _ = serve(dense, bs)
            n_rule = agree(res, ref, f"{cfg} batch {bs}")
            phase_p50 = {
                name: reg.histogram("route_phase_ms", phase=name).percentile(50)
                for name in PHASES
                if reg.histogram("route_phase_ms", phase=name).count()
            }
            runs.append(dict(config=cfg, n_tools=table_db.embeddings.shape[0], batch=bs,
                             batches=len(ms), p50_ms=float(np.percentile(ms, 50)),
                             p99_ms=float(np.percentile(ms, 99)), phase_p50_ms=phase_p50,
                             near_tie_rows=n_rule))
            log(f"serve {cfg:7s} T={table_db.embeddings.shape[0]} batch={bs}: "
                f"{len(res)} results, batch p50 {runs[-1]['p50_ms']:.3f} ms "
                f"p99 {runs[-1]['p99_ms']:.3f} ms; phase p50 ms "
                + json.dumps({k: round(v, 4) for k, v in phase_p50.items()})
                + f"; equal to dense (rows reordered inside near-ties: {n_rule})")
            fused.close()
        dense.close()

    # a CAS swap lands: later batches carry the new version, served by a
    # rebuilt fused index, and still equal the dense backend's results
    fused = router(db, "fused", None)
    dense = router(db, "dense", None)
    v0 = db.table_version
    db.swap_table(scale_tool_corpus(native, N_TOOLS, seed=1), expect_current=v0)
    res, _ = serve(fused, 64)
    ref, _ = serve(dense, 64)
    if any(r.table_version != v0 + 1 for r in res) or fused.index.last_path() != "index:fused":
        raise AssertionError("swap: results not served by a rebuilt fused index")
    n_rule = agree(res, ref, "after swap")
    log(f"swap: table v{v0} -> v{v0 + 1}; fused index rebuilt "
        f"(rebuilds={fused.index.stats['rebuilds']}), results equal to dense "
        f"(rows reordered inside near-ties: {n_rule})")
    fused.close()
    dense.close()
    main_launches = topk_kernel.launches
    serve_routes = dict(topk_kernel.launches_by_route)
    serve_rescored = topk_kernel.rescored()
    log(f"serving path: {time.perf_counter() - t_serve:.1f} s, topk_sim launches "
        f"{main_launches}, by route " + json.dumps(serve_routes) + f"; {serve_rescored} "
        f"(query, row) pairs rescored in float32 on the wgmma route")
    # the 100,000-tool batches take the route topk_route gives their size
    # (wgmma from WGMMA_MIN_Q queries up, split below), the re-ranker's
    # native 2,413 tools the cluster route
    sizes = {bs for bs in BATCH_SIZES} | {bench.n_queries % bs for bs in BATCH_SIZES} - {0}
    t_big = torch.from_numpy(big[:1]).to(dev)
    want_routes = {topk_kernel.topk_route(n, N_TOOLS, big.shape[1], 5, t_big, t_big)
                   for n in sizes} | {"cluster"}
    if main_launches == 0 or {r for r, n in serve_routes.items() if n} != want_routes:
        raise AssertionError(f"the serving path launched topk_sim {serve_routes}, expected "
                             f"the routes {sorted(want_routes)}")

    # where a batch's time goes on the card: device time per batch, by
    # kernel, and the host-clock time of the same 20 batches (the profiler
    # adds host overhead, so the idle share read here is an upper estimate)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fused = router(db, "fused", None)
    for bs in BATCH_SIZES:
        n = bench.n_queries
        batches = [[bench.query_tokens[(i * bs + j) % n] for j in range(bs)]
                   for i in range(20)]
        fused.route_batch(batches[0])
        torch.cuda.synchronize()
        wall = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in batches:
                t = time.perf_counter()
                fused.route_batch(b)
                wall.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        per_kernel = {
            e.key: e.self_device_time_total / len(batches) / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        }
        busy = sum(per_kernel.values())
        wall_mean = float(np.mean(wall))
        profiled.append(dict(batch=bs, batches=len(batches), busy_ms=busy,
                             wall_mean_ms=wall_mean,
                             wall_p50_ms=float(np.percentile(wall, 50)),
                             idle_share=1 - busy / wall_mean, per_kernel_ms=per_kernel))
        log(f"profile bare T={N_TOOLS} batch={bs}: device busy {busy:.4f} ms per batch, "
            f"host clock of the same {len(batches)} profiled batches mean "
            f"{wall_mean:.4f} ms p50 {profiled[-1]['wall_p50_ms']:.4f} ms, device idle "
            f"share 1 - busy/mean = {profiled[-1]['idle_share']:.4f}; per kernel ms "
            + json.dumps({k[:60]: round(v, 4) for k, v in per_kernel.items()}))
    fused.close()

    # ------------------------------------------------------------------ 5. pool
    dense_native = router(db_native, "dense", None)
    pool_router = router(db_native, "fused", None)
    routed = []  # batch sizes of the pool's route_batch calls
    route_batch = pool_router.route_batch

    def counted_route(queries, *args, **kwargs):
        routed.append(len(queries))
        return route_batch(queries, *args, **kwargs)

    pool_router.route_batch = counted_route
    max_len = POOL_PROMPT_LENS[1] + 2 * POOL_NEW_TOKENS
    batcher = ContinuousBatcher(pool_cfg, pool_params, n_slots=POOL_SLOTS, max_len=max_len,
                                router=pool_router, device=dev)
    prefill_ms, decode_ms, tick_ms = [], [], []
    prefill, decode = batcher._prefill, batcher._decode

    def timed(fn, into):
        def wrapper(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("pool: non-finite logits")
            return logits, cache
        return wrapper

    batcher._prefill, batcher._decode = timed(prefill, prefill_ms), timed(decode, decode_ms)
    rng = np.random.default_rng(0)
    lens = rng.integers(POOL_PROMPT_LENS[0], POOL_PROMPT_LENS[1] + 1, POOL_REQUESTS)
    requests = [Request(request_id=i, prompt=rng.integers(0, pool_cfg.vocab_size, int(n)),
                        max_new_tokens=POOL_NEW_TOKENS,
                        query_tokens=bench.query_tokens[i % bench.n_queries])
                for i, n in enumerate(lens)]
    for req in requests:
        batcher.submit(req)
    torch.cuda.synchronize()
    for mod in kernel_modules.values():
        mod.launches = 0  # the pool path starts: count only its launches
    flash_kernel.launches_by_route = dict.fromkeys(flash_kernel.ROUTES, 0)
    topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
    t_pool = time.perf_counter()
    while batcher.queue or any(slot is not None for slot in batcher.slots):
        t = time.perf_counter()
        batcher.tick()
        tick_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t_pool
    pool_launches = {name: mod.launches for name, mod in kernel_modules.items()}
    pool_flash_routes = dict(flash_kernel.launches_by_route)
    pool_topk_routes = dict(topk_kernel.launches_by_route)
    done = sorted(batcher.completed, key=lambda r: r.request_id)
    if [r.request_id for r in done] != list(range(POOL_REQUESTS)):
        raise AssertionError(f"pool: {len(done)} of {POOL_REQUESTS} requests completed")
    for r in done:
        if len(r.generated) != POOL_NEW_TOKENS or not all(
                0 <= t < pool_cfg.vocab_size for t in r.generated):
            raise AssertionError(f"pool: request {r.request_id} generated {r.generated}")
    # one launch per layer and prefill for flash, one per phase for the
    # scan, one per routed batch for topk_sim (2,413 tools: the cluster route)
    expect = {"flash_attention": POOL_REQUESTS * pool_cfg.n_layers,
              "ssd_scan": POOL_REQUESTS * pool_cfg.n_layers * len(ssd_kernel.PHASES),
              "topk_sim": len(routed)}
    expect_routes = {"wgmma": POOL_REQUESTS * pool_cfg.n_layers, "fma": 0}
    expect_topk = {"cluster": len(routed), "split": 0, "wgmma": 0, "select": 0}
    if (pool_launches != expect or pool_flash_routes != expect_routes
            or pool_topk_routes != expect_topk or len(prefill_ms) != POOL_REQUESTS):
        raise AssertionError(f"pool: launches {pool_launches}, flash by route "
                             f"{pool_flash_routes}, topk_sim by route {pool_topk_routes}, "
                             f"expected {expect}, {expect_routes} and {expect_topk} "
                             f"({len(prefill_ms)} prefills, {len(routed)} routed batches)")
    n_rule = agree([r.route_result for r in done],
                   dense_native.route_batch([r.query_tokens for r in done]), "pool routing")
    generated = sum(len(r.generated) for r in done)
    pool_stats = dict(
        model=pool_cfg.name, dtype=pool_cfg.dtype, layers=pool_cfg.n_layers,
        requests=POOL_REQUESTS, slots=POOL_SLOTS, max_len=max_len,
        prompt_lens=[int(n) for n in lens], new_tokens=POOL_NEW_TOKENS, ticks=len(tick_ms),
        seconds=pool_s, generated_tokens=generated, generated_tokens_per_s=generated / pool_s,
        prefill_ms=list(prefill_ms), decode_ms_p50=float(np.percentile(decode_ms, 50)),
        decode_ms_p99=float(np.percentile(decode_ms, 99)), decode_ms=list(decode_ms),
        routed_batches=routed, launches=pool_launches,
        flash_launches_by_route=pool_flash_routes, topk_launches_by_route=pool_topk_routes,
        routing_near_tie_rows=n_rule,
        prefill_tokens_per_s=float(lens.sum() / (sum(prefill_ms) / 1e3)))
    log(f"pool: {POOL_REQUESTS} requests drained in {len(tick_ms)} ticks, {pool_s:.2f} s; "
        f"{generated} tokens, {generated / pool_s:.1f} generated tokens/s; launches "
        + json.dumps(pool_launches) + " (flash by route " + json.dumps(pool_flash_routes)
        + ", topk_sim by route " + json.dumps(pool_topk_routes) + f"; {len(routed)} routed batches {routed}); tools equal "
        f"to the dense backend's (rows reordered inside near-ties: {n_rule})")
    log("pool prefill ms per request (prompt tokens): " + ", ".join(
        f"{ms:.1f} ({int(n)})" for ms, n in zip(prefill_ms, lens)))
    log("pool decode ms per tick: " + ", ".join(f"{ms:.1f}" for ms in decode_ms))
    log(f"pool decode step p50 {pool_stats['decode_ms_p50']:.2f} ms, p99 "
        f"{pool_stats['decode_ms_p99']:.2f} ms over {len(decode_ms)} ticks; prefill "
        f"{pool_stats['prefill_tokens_per_s']:.0f} prompt tokens/s")

    # where the pool's time goes: a second drain of 4 requests under the
    # profiler; busy = device time of all kernels and copies, against the
    # host clock of the same ticks (the profiler adds host overhead)
    for i, n in enumerate(lens[:POOL_SLOTS]):
        batcher.submit(Request(request_id=POOL_REQUESTS + i,
                               prompt=rng.integers(0, pool_cfg.vocab_size, int(n)),
                               max_new_tokens=POOL_NEW_TOKENS))
    torch.cuda.synchronize()
    wall = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while batcher.queue or any(slot is not None for slot in batcher.slots):
            t = time.perf_counter()
            batcher.tick()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
    per_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in per_kernel)
    pool_stats["profiled"] = dict(
        ticks=len(wall), wall_ms=float(sum(wall)), busy_ms=busy,
        idle_share=1 - busy / float(sum(wall)),
        top_kernels_ms={k[:80]: v for k, v in per_kernel[:8]})
    log(f"profile pool: {len(wall)} ticks (4 prefills + decode), host clock "
        f"{sum(wall):.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{pool_stats['profiled']['idle_share']:.4f}; top kernels ms "
        + json.dumps({k[:60]: round(v, 2) for k, v in per_kernel[:8]}))
    pool_router.close()
    dense_native.close()

    # how one 2,048-token prefill splits between host and card: three
    # prefills on the host clock, then one under the profiler (device time
    # by kernel; the profiler adds host overhead to its own host clock)
    alone_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        M.prefill(pool_cfg, pool_params, {"tokens": capture_tokens})
        torch.cuda.synchronize()
        alone_ms.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        M.prefill(pool_cfg, pool_params, {"tokens": capture_tokens})
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy = sum(by_kernel.values())
    own = {name: sum(ms for key, ms in by_kernel.items() if name in key)
           for name in ("flash_attention_wgmma", "flash_attention_fwd", "ssd_scan_states",
                        "ssd_scan_carry", "ssd_scan_output")}
    pool_stats["prefill_alone"] = dict(
        tokens=CAPTURE_LEN, host_ms=alone_ms, profiled_host_ms=profiled_ms, busy_ms=busy,
        idle_share=1 - busy / profiled_ms, kernel_ms=own)
    log(f"prefill alone, {CAPTURE_LEN} tokens: host clock " + ", ".join(
        f"{ms:.1f}" for ms in alone_ms) + f" ms; under the profiler {profiled_ms:.1f} ms, device "
        f"busy {busy:.2f} ms (idle share {1 - busy / profiled_ms:.4f}); device ms by kernel "
        + json.dumps({k: round(v, 3) for k, v in own.items()}))

    # -------------------------------------------------------------- 6. pipeline
    # the offline OATS pipeline on the card, then its refined table served;
    # this path's launches are counted from here on
    for mod in kernel_modules.values():
        mod.launches = 0
    topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
    t_pipe = time.perf_counter()
    pipe_benches = {"make_metatool_like": make_metatool_like(0), "make_toolbench_like": bench}
    pipe_rows, pipe_fits = [], {}
    for bname, pb in pipe_benches.items():
        ev_card = BenchmarkEvaluator(pb, device=dev)
        ev_cpu = BenchmarkEvaluator(pb, device="cpu")
        for preset in PIPELINE_PRESETS:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = ev_card.rankings_for(preset)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            pipe_fits[(bname, preset)] = res
            row = dict(bench=bname, preset=preset, device="card", seconds=fit_s,
                       ndcg5=res.metrics["ndcg@5"], recall1=res.metrics["recall@1"])
            if preset in PIPELINE_BANDS[bname]:
                lo, hi = PIPELINE_BANDS[bname][preset]
                row["band"] = [lo, hi]
                if not lo <= row["ndcg5"] <= hi:
                    raise AssertionError(f"{bname} {preset}: NDCG@5 {row['ndcg5']:.6f} outside "
                                         f"the JAX package's band [{lo}, {hi}]")
            pipe_rows.append(row)
            log(f"pipeline {bname} {preset} on the card: NDCG@5 {row['ndcg5']:.6f}, Recall@1 "
                f"{row['recall1']:.6f}, fit + rank {fit_s:.2f} s"
                + (f"; inside the JAX band {row['band']}" if "band" in row else "")
                + f" on {card}")
        # S1 through the port on the CPU, in this process: same gate, NDCG@5
        # within S1_NDCG_ATOL, differing rows only inside near-ties
        card_s1 = pipe_fits[(bname, "oats-s1")]
        t = time.perf_counter()
        cpu_s1 = ev_cpu.rankings_for("oats-s1")
        cpu_s = time.perf_counter() - t
        g_card, g_cpu = card_s1.pipeline.refine_result, cpu_s1.pipeline.refine_result
        if bool(g_card.accepted) != bool(g_cpu.accepted):
            raise AssertionError(f"{bname}: the gate accepted={bool(g_card.accepted)} on the "
                                 f"card but {bool(g_cpu.accepted)} on the CPU")
        d_ndcg = abs(card_s1.metrics["ndcg@5"] - cpu_s1.metrics["ndcg@5"])
        if d_ndcg > S1_NDCG_ATOL:
            raise AssertionError(f"{bname}: S1 NDCG@5 card {card_s1.metrics['ndcg@5']:.6f} vs "
                                 f"CPU {cpu_s1.metrics['ndcg@5']:.6f}")
        test_q = ev_cpu.query_emb[ev_cpu.test_idx]
        n_rule = 0
        for j in np.flatnonzero((card_s1.rankings != cpu_s1.rankings).any(axis=1)):
            sc_card = test_q[j] @ card_s1.pipeline.tool_table.T
            sc_cpu = test_q[j] @ cpu_s1.pipeline.tool_table.T
            a_idx, b_idx = card_s1.rankings[j], cpu_s1.rankings[j]
            if not same_ranking(a_idx, sc_card[a_idx], b_idx, sc_cpu[b_idx], NEAR_TIE):
                raise AssertionError(f"{bname} S1 test row {j}: card {a_idx.tolist()} vs CPU "
                                     f"{b_idx.tolist()}")
            n_rule += 1
        table_err = float(np.abs(card_s1.pipeline.tool_table - cpu_s1.pipeline.tool_table).max())
        pipe_rows.append(dict(bench=bname, preset="oats-s1", device="cpu", seconds=cpu_s,
                              ndcg5=cpu_s1.metrics["ndcg@5"],
                              recall1=cpu_s1.metrics["recall@1"],
                              accepted=bool(g_cpu.accepted), card_accepted=bool(g_card.accepted),
                              gate_before=float(g_card.recall_before),
                              gate_after=float(g_card.recall_after),
                              table_max_abs_err=table_err, near_tie_rows=n_rule))
        log(f"pipeline {bname} oats-s1 on the CPU: NDCG@5 {cpu_s1.metrics['ndcg@5']:.6f} "
            f"(card - CPU {card_s1.metrics['ndcg@5'] - cpu_s1.metrics['ndcg@5']:+.2e}), "
            f"Recall@1 {cpu_s1.metrics['recall@1']:.6f}; "
            f"gate accepted on both ({bool(g_card.accepted)}), Recall@5 "
            f"{float(g_card.recall_before):.6f} -> {float(g_card.recall_after):.6f} on the card; "
            f"tables within {table_err:.3g}; test rows ranked apart inside near-ties: {n_rule}")
        # refine_with_gate alone on the card, at this benchmark's fit split
        train = pb.train_idx
        perm = np.random.default_rng(0).permutation(len(train))
        n_val = max(int(round(0.15 * len(train))), 1)
        fit_i, val_i = train[np.sort(perm[n_val:])], train[np.sort(perm[:n_val])]
        rel_all = pb.relevance_matrix()
        cm_all = pb.candidate_mask()
        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        args = (on(ev_cpu.tool_emb), on(ev_cpu.query_emb[fit_i]), on(rel_all[fit_i]),
                on(ev_cpu.query_emb[val_i]), on(rel_all[val_i]), RefineConfig(),
                on(cm_all[fit_i]), on(cm_all[val_i]))
        refine_ms = [cuda_ms(lambda: refine_with_gate(*args), iters=5, warmup=2)
                     for _ in range(3)]
        pipe_rows[-1]["refine_with_gate_ms"] = refine_ms
        log(f"pipeline {bname}: refine_with_gate on the card {min(refine_ms):.3f} ms (runs "
            + ", ".join(f"{x:.3f}" for x in refine_ms) + f"; fit split {len(fit_i)} queries x "
            f"{pb.n_tools} tools, 3 iterations) on {card}")

    # serve ToolBench-like's refined table through a fused-backend router
    # after a CAS swap, against the dense backend on the same table
    s2 = pipe_fits[("make_toolbench_like", "oats-s2")].pipeline
    refined = np.ascontiguousarray(s2.tool_table, np.float32)
    db_pipe = ToolsDatabase(records(bench.n_tools), native)
    test_toks = [bench.query_tokens[j] for j in bench.test_idx]
    fused, dense = router(db_pipe, "fused", None), router(db_pipe, "dense", None)
    v0 = db_pipe.table_version
    db_pipe.swap_table(refined, expect_current=v0)
    pipe_serve = {}
    for bs in BATCH_SIZES:
        blocks = [test_toks[s:s + bs] for s in range(0, len(test_toks), bs)]
        res = [r for toks in blocks for r in fused.route_batch(toks)]
        ref = [r for toks in blocks for r in dense.route_batch(toks)]
        if fused.index.last_path() != "index:fused" or any(r.table_version != v0 + 1 for r in res):
            raise AssertionError("pipeline: the refined table was not served by the fused index")
        pipe_serve[bs] = agree(res, ref, f"refined table batch {bs}")
        log(f"pipeline serve: ToolBench-like's refined table (v{v0 + 1}) at batch {bs}: "
            f"{len(res)} test queries equal to the dense backend (rows reordered inside "
            f"near-ties: {pipe_serve[bs]})")
    fused.close()
    dense.close()
    # the S2 re-ranker at k = 26 over the same table: C = 130 candidates,
    # which only the select route takes
    before_select = topk_kernel.launches_by_route["select"]
    stages_s2 = StageSet(mlp_params=s2.mlp_params, featurizer=s2.featurizer)
    rr = SemanticRouter(db_pipe, embed_fn=enc.encode_one, embed_batch_fn=enc.encode,
                        k=RERANK_K, backend="fused", stages=stages_s2, metrics=False, device=dev)
    batches = [test_toks[s:s + 64] for s in range(0, len(test_toks), 64)]
    routed_rr = [rr.route_batch(toks) for toks in batches]
    rr.close()
    select_calls = (topk_kernel.launches_by_route["select"] - before_select) // 2
    if select_calls < 1 or any(len(r.tools) != RERANK_K for b in routed_rr for r in b):
        raise AssertionError(f"pipeline: the k={RERANK_K} re-rank made {select_calls} select calls")
    pipe_launches = topk_kernel.launches
    pipe_routes = dict(topk_kernel.launches_by_route)
    pipe_s = time.perf_counter() - t_pipe
    # the check: the router's candidates (the select route, here on the same
    # padded block) against the dense backend's under the near-tie rule, and
    # its results against the plain re-rank of those candidates (the MLP's
    # logits amplify the candidates' float32 rounding, so the re-rank is held
    # to its own inputs); these launches do not count
    table_dev = torch.from_numpy(refined).to(dev)
    n_cand_rule = 0
    for toks, got in zip(batches, routed_rr):
        n_pad = pad_amount(len(toks))
        q_in = np.concatenate([enc.encode(toks), np.zeros((n_pad, refined.shape[1]), np.float32)])
        toks_in = list(toks) + [np.zeros(0, np.int64)] * n_pad
        q_t = torch.from_numpy(q_in).to(dev)
        fs, fi = topk_kernel.topk_sim_cuda(q_t, table_dev, 5 * RERANK_K)
        ds, di = topk_dense(q_t, table_dev, 5 * RERANK_K)
        n = len(toks)
        n_cand_rule += compare_topk(fs[:n], fi[:n], ds[:n], di[:n], NEAR_TIE)[1]
        feats = s2.featurizer.features(q_in, toks_in, fi.cpu().numpy(), fs.cpu().numpy())
        ti, ts = rerank_topk_scored(s2.mlp_params, torch.from_numpy(feats).to(dev), fi,
                                    RERANK_K, valid=fs > NEG_INF / 2)
        for j, r in enumerate(got):
            if r.tools != ti[j].tolist() or max(
                    abs(x - y) for x, y in zip(r.scores, ts[j].tolist())) > SCORE_ATOL:
                raise AssertionError(f"re-rank k={RERANK_K} row {j}: {r.tools} vs the plain "
                                     f"re-rank {ti[j].tolist()}")
    topk_kernel.launches, topk_kernel.launches_by_route = pipe_launches, dict(pipe_routes)
    log(f"pipeline serve: the S2 re-ranker at k={RERANK_K} asked for C={RERANK_K * 5}: "
        f"{select_calls} calls on topk_sim's select route; its candidates equal to the dense "
        f"backend's (rows reordered inside near-ties: {n_cand_rule}) and the results to the "
        f"plain re-rank of them")
    log(f"pipeline path: {pipe_s:.1f} s, topk_sim launches {pipe_launches}, by route "
        + json.dumps(pipe_routes))
    if pipe_routes["select"] == 0 or pipe_launches == 0:
        raise AssertionError(f"the pipeline path launched topk_sim {pipe_routes}")

    # ------------------------------------------------------------------ 8. loop
    # the online refinement loop, the churn legs and the route cache, all
    # through the fused backend; this path's launches are counted from here
    for mod in kernel_modules.values():
        mod.launches = 0
    topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
    t_loop = time.perf_counter()
    loop = loop_phase(dev, card, bench, enc, native, big)
    loop_launches = topk_kernel.launches
    loop_routes = dict(topk_kernel.launches_by_route)
    loop["seconds"] = time.perf_counter() - t_loop
    log(f"loop path: {loop['seconds']:.1f} s, topk_sim launches {loop_launches}, by route "
        + json.dumps(loop_routes))
    if loop_launches == 0 or any(mod.launches for name, mod in kernel_modules.items()
                                 if name != "topk_sim"):
        raise AssertionError(f"the loop path launched topk_sim {loop_routes}")

    # ----------------------------------------------------------------- 7. times
    def served_call_ms(q_np, table, k, calls=50):
        """One call as FusedBackend makes it (queries up from numpy, the
        kernel, both results down), on each large-table route in turns: host
        clock of the call alone and after a 2 ms idle gap, as batches arrive,
        and the host dispatch (to the wrapper's return); medians over rounds
        of `calls`."""
        out = {}
        for _ in range(TIME_ROUNDS):
            for r in ("wgmma", "split"):
                for gap in (0.0, 0.002):
                    ms, dispatch = [], []
                    for _ in range(calls):
                        torch.cuda.synchronize()
                        time.sleep(gap)
                        t = time.perf_counter()
                        got = topk_kernel.topk_sim_cuda(torch.from_numpy(q_np).to(dev), table, k,
                                                        route=r)
                        dispatch.append(time.perf_counter() - t)
                        got[0].cpu(), got[1].cpu()
                        ms.append(time.perf_counter() - t)
                    name = f"{r}{'_after_gap' if gap else ''}"
                    out.setdefault(name, []).append(float(np.median(ms)) * 1e3)
                    out.setdefault(f"{r}_dispatch", []).append(float(np.median(dispatch)) * 1e3)
        return {name: float(np.median(v)) for name, v in out.items()}

    table_big = torch.from_numpy(big).to(dev)
    table_native = torch.from_numpy(native).to(dev)
    shapes = []
    for n_q, table, k in [(8, table_big, 5), (64, table_big, 5),
                          (8, table_native, 25), (64, table_native, 25)]:
        q = torch.from_numpy(q_all[:n_q]).to(dev)
        n_t, d = table.shape
        route = topk_kernel.topk_route(n_q, n_t, d, k, table, q)
        fns = {"kernel": lambda: topk_kernel.topk_sim_cuda(q, table, k),
               "library": lambda: torch.topk(q @ table.T, k)}
        if table is table_big:  # both large-table routes, forced, in the same turns
            for r in ("wgmma", "split"):
                fns[r] = functools.partial(topk_kernel.topk_sim_cuda, q, table, k, route=r)
        rounds = alternating(fns)
        med = {name: float(np.median(t)) for name, t in rounds.items()}
        ms, lib = med["kernel"], med["library"]
        plain = cuda_ms(lambda: topk_sim_ref(q, table, k))
        extra, resc = {}, 0
        if table is table_big:
            topk_kernel.reset_rescored()
            topk_kernel.topk_sim_cuda(q, table, k, route="wgmma")
            resc = topk_kernel.rescored()
            # device time per launch of each pass, for both routes
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for r in ("wgmma", "split"):
                    for _ in range(20):
                        fns[r]()
                torch.cuda.synchronize()
            passes = {name: e.self_device_time_total / 1e3 / e.count
                      for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      for name in ("topk_sim_wgmma", "topk_sim_partial", "topk_sim_merge")
                      if name in e.key}
            below = {r: sum(a < b for a, b in zip(rounds["wgmma"], rounds[r]))
                     for r in ("split", "library")}
            served = served_call_ms(q_all[:n_q], table, k)
            extra = dict(route_ms={r: med[r] for r in ("wgmma", "split")},
                         wgmma_below_rounds=below, rescored_per_call=resc,
                         device_ms_per_launch=passes, served_call_ms=served)
        bounds = topk_bound(n_q, n_t, d, k, rescored=resc)
        bound_ms, bound_by = bounds["tensor_cores" if route == "wgmma" else "cuda_cores"]
        shapes.append(dict(shape=[n_q, n_t, d, k], route=route, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=bound_ms, bound_by=bound_by,
                           bound_cuda_cores_ms=bounds["cuda_cores"][0],
                           bound_tensor_cores_ms=bounds["tensor_cores"][0], rounds_ms=rounds,
                           **extra))
        log(f"time topk_sim Q={n_q} T={n_t} D={d} k={k} ({route}): kernel median {ms:.4f} ms "
            f"(rounds " + ", ".join(f"{t:.4f}" for t in rounds["kernel"])
            + f"), torch.topk(q@t.T) median {lib:.4f} ms (rounds "
            + ", ".join(f"{t:.4f}" for t in rounds["library"])
            + f"), kernel below it in {sum(a < b for a, b in zip(rounds['kernel'], rounds['library']))} "
            f"of {TIME_ROUNDS} rounds; plain {plain:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
            f"CUDA cores {bounds['cuda_cores'][0]:.4f}, tensor cores "
            f"{bounds['tensor_cores'][0]:.4f}) on {card}")
        if extra:
            log(f"time topk_sim Q={n_q} T={n_t} k={k}: wgmma route median {med['wgmma']:.4f} ms "
                f"(rounds " + ", ".join(f"{t:.4f}" for t in rounds["wgmma"]) + f"), split route "
                f"median {med['split']:.4f} ms (rounds "
                + ", ".join(f"{t:.4f}" for t in rounds["split"]) + f"); wgmma below split in "
                f"{extra['wgmma_below_rounds']['split']} and below torch.topk in "
                f"{extra['wgmma_below_rounds']['library']} of {TIME_ROUNDS} rounds; "
                f"{resc} (query, row) pairs rescored a call; device ms per launch "
                + json.dumps({key: round(v, 4) for key, v in passes.items()}) + f" on {card}")
            log(f"served call topk_sim Q={n_q} T={n_t} k={k} (queries up, kernel, results "
                f"down; host clock, medians of {TIME_ROUNDS} rounds of 50 in turns): "
                + json.dumps({key: round(v, 4) for key, v in served.items()}) + f" on {card}")
    head = shapes[1]  # the bare path's full batch: Q=64 over 100,000 tools

    # the routes as the table grows (the crossover sets CLUSTER_MAX_T) and,
    # at 100,000 tools, as the batch grows (it sets WGMMA_MIN_Q)
    crossover = []
    for n_q in (8, 64):
        q = torch.from_numpy(q_all[:n_q]).to(dev)
        for n_t in CROSSOVER_T:
            table = table_big[:n_t]
            rounds = alternating({r: functools.partial(topk_kernel.topk_sim_cuda, q, table, 25,
                                                       route=r) for r in topk_kernel.ROUTES},
                                 rounds=3, iters=100)
            row = dict(n_q=n_q, n_t=n_t, k=25, **{f"{r}_ms": float(np.median(t))
                                                  for r, t in rounds.items()})
            crossover.append(row)
            log(f"crossover topk_sim Q={n_q} T={n_t} k=25: " + ", ".join(
                f"{r} {row[r + '_ms']:.4f} ms" for r in topk_kernel.ROUTES)
                + f" (medians of 3 rounds in turns) on {card}")
    for n_q, k in ([(n_q, 5) for n_q in CROSSOVER_Q]
                   + [(n_q, k) for n_q in (16, 64) for k in CROSSOVER_K if k != 5]):
        q = torch.from_numpy(q_all[:n_q]).to(dev)
        rounds = alternating({r: functools.partial(topk_kernel.topk_sim_cuda, q, table_big, k,
                                                   route=r)
                              for r in ("wgmma", "split")}, rounds=3, iters=100)
        row = dict(n_q=n_q, n_t=N_TOOLS, k=k, **{f"{r}_ms": float(np.median(t))
                                                 for r, t in rounds.items()})
        crossover.append(row)
        log(f"crossover topk_sim Q={n_q} T={N_TOOLS} k={k}: wgmma {row['wgmma_ms']:.4f} ms, "
            f"split {row['split_ms']:.4f} ms (medians of 3 rounds in turns) on {card}")
    # one small call: host dispatch against device time. Host: the host
    # clock of 200 back-to-back calls (the card keeps up, so this is the
    # time to issue one); device: the profiler's kernel time per launch
    host_split = []
    for n_q in (8, 64):
        q = torch.from_numpy(q_all[:n_q]).to(dev)
        call = functools.partial(topk_kernel.topk_sim_cuda, q, table_native, 25)
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            call()
        host_ms = (time.perf_counter() - t) * 1e3 / 200
        torch.cuda.synchronize()
        event_ms = cuda_ms(call, iters=200)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                call()
            torch.cuda.synchronize()
        dev_ms = {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "topk_sim" in e.key}
        host_split.append(dict(n_q=n_q, n_t=table_native.shape[0], k=25, host_ms=host_ms,
                               event_ms=event_ms, device_ms_per_launch=dev_ms))
        log(f"topk_sim Q={n_q} T={table_native.shape[0]} k=25, one call: host dispatch "
            f"{host_ms:.4f} ms, CUDA-event time {event_ms:.4f} ms, device time per launch "
            + json.dumps({k[:40]: round(v, 5) for k, v in dev_ms.items()}) + f" on {card}")

    # the select route at the re-ranker's shape: a batch of 64 over the
    # native 2,413 tools, C = 5 x 26 = 130 candidates
    sel_q = torch.from_numpy(q_all[:64]).to(dev)
    sel_k = 5 * RERANK_K
    sel_rounds = alternating({
        "kernel": lambda: topk_kernel.topk_sim_cuda(sel_q, table_native, sel_k),
        "library": lambda: torch.topk(sel_q @ table_native.T, sel_k)})
    sel_ms = float(np.median(sel_rounds["kernel"]))
    sel_lib = float(np.median(sel_rounds["library"]))
    sel_plain = cuda_ms(lambda: topk_sim_ref(sel_q, table_native, sel_k))
    sel_bound, sel_by = topk_bound(64, table_native.shape[0], sel_q.shape[1], sel_k)["cuda_cores"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            topk_kernel.topk_sim_cuda(sel_q, table_native, sel_k)
        torch.cuda.synchronize()
    sel_passes = {name: e.self_device_time_total / 1e3 / e.count
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  for name in ("topk_sim_select_scores", "topk_sim_select_topk") if name in e.key}
    log(f"time topk_sim Q=64 T={table_native.shape[0]} D={sel_q.shape[1]} k={sel_k} (select): "
        f"kernel median {sel_ms:.4f} ms (rounds "
        + ", ".join(f"{t:.4f}" for t in sel_rounds["kernel"])
        + f"), torch.topk(q@t.T) median {sel_lib:.4f} ms (rounds "
        + ", ".join(f"{t:.4f}" for t in sel_rounds["library"]) + f"); plain {sel_plain:.4f} ms; "
        f"bound {sel_bound:.4f} ms ({sel_by}); device ms per launch "
        + json.dumps({k: round(v, 4) for k, v in sel_passes.items()}) + f" on {card}")

    # the new kernels at the full-width shapes of layer 0's prefill (bf16)
    (q, k, v), kw = captured["flash"][0]
    g = q.shape[0] // k.shape[0]
    q4 = q.view(1, q.shape[0], q.shape[1], q.shape[2])
    k4, v4 = (t.repeat_interleave(g, dim=0).view(q4.shape) for t in (k, v))
    mask = attention_mask(q.shape[1], k.shape[1], True, kw["window"], 0, dev)
    # both kernels on the same bf16 inputs, in turns (wgmma, fma, fma, wgmma)
    by_route = {r: [] for r in ("wgmma", "fma", "fma", "wgmma")}
    for r in ("wgmma", "fma", "fma", "wgmma"):
        by_route[r].append(cuda_ms(
            lambda r=r: flash_kernel.flash_attention_cuda(q, k, v, route=r, **kw), iters=100))
    f_ms_by_route = {r: min(ts) for r, ts in by_route.items()}
    f_ms = f_ms_by_route[flash_kernel.flash_route(q.dtype, q.shape[2], q, k, v)]
    f_plain = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), iters=100)
    f_bound, f_by = flash_bound(q, k, v, True, kw["window"], 0)
    log(f"time flash_attention q{list(q.shape)} kv{list(k.shape)} {q.dtype} window "
        f"{kw['window']}: wgmma kernel {f_ms_by_route['wgmma']:.4f} ms (runs "
        + ", ".join(f"{t:.4f}" for t in by_route["wgmma"]) + f"), fma kernel "
        f"{f_ms_by_route['fma']:.4f} ms (runs " + ", ".join(f"{t:.4f}" for t in by_route["fma"])
        + f"), plain {f_plain:.4f} ms, SDPA (same mask, kv repeated) {f_lib:.4f} ms, bound "
        f"{f_bound:.4f} ms ({f_by}) on {card}")
    ssd_args, _ = captured["ssd"][0]
    x0 = ssd_args[0]
    s_bound, s_by = ssd_bound(*ssd_args[:5])
    # the three launches of one prepared call (the kernels), and a whole
    # call (checks and allocations on the host too)
    ctx = ssd_kernel.prepare(*ssd_args)
    s_ms = cuda_ms(lambda: [ssd_kernel.launch_phase(ctx, ph) for ph in ssd_kernel.PHASES],
                   iters=100)
    s_call_ms = cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*ssd_args), iters=100)
    # a phase alone is shorter than its host dispatch, so each phase's time
    # is the profiler's device time per launch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            ssd_kernel.ssd_scan_cuda(*ssd_args)
        torch.cuda.synchronize()
    s_phase_ms = {phase: sum(e.self_device_time_total for e in prof.key_averages()
                             if f"ssd_scan_{phase}" in e.key) / 1e3 / 50
                  for phase in ssd_kernel.PHASES}
    s_device_ms = sum(s_phase_ms.values())
    s_plain = cuda_ms(lambda: ssd_scan_ref(*ssd_args))
    log(f"time ssd_scan x{list(x0.shape)} {x0.dtype} N={ssd_args[3].shape[-1]} chunk "
        f"{ssd_args[5]}: kernels {s_ms:.4f} ms (CUDA events over the three launches; a whole "
        f"call {s_call_ms:.4f} ms), device {s_device_ms:.4f} ms "
        "(profiler, per phase " + json.dumps({ph: round(v, 4) for ph, v in s_phase_ms.items()})
        + f"), plain {s_plain:.4f} ms, no library call, bound {s_bound:.4f} ms ({s_by}) on {card}")

    kernels = [dict(
        name="topk_sim", route="cuda", source="src/repro_torch/kernels/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:89",
        launches=main_launches + pool_launches["topk_sim"] + pipe_launches + loop_launches,
        max_abs_err=max_err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        bound_cuda_cores_ms=head["bound_cuda_cores_ms"],
        bound_tensor_cores_ms=head["bound_tensor_cores_ms"],
        shape=head["shape"], route_of_shape=head["route"], shapes=shapes, checks=checks,
        index_agreement="exact except reordering inside near-ties (rows counted in checks); "
                        "the wgmma route bitwise equal to the split route",
        launches_by_path={"serve": main_launches, "pool": pool_launches["topk_sim"],
                          "pipeline": pipe_launches, "loop": loop_launches},
        launches_by_route={"serve": serve_routes, "pool": pool_topk_routes,
                           "pipeline": pipe_routes, "loop": loop_routes},
        rescored={"serve": serve_rescored},
        crossover=crossover, host_vs_device=host_split,
    ), dict(
        name="topk_sim (select route)", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:89", launches=pipe_routes["select"],
        max_abs_err=max(c["max_abs_err"] for c in checks if c["route"] == "select"),
        ms=sel_ms, plain_ms=sel_plain, bound_ms=sel_bound, bound_by=sel_by, library_ms=sel_lib,
        shape=[64, table_native.shape[0], sel_q.shape[1], sel_k], rounds_ms=sel_rounds,
        device_ms_per_launch=sel_passes,
        library=f"torch.topk(q @ t.T, {sel_k})",
        launches_path="pipeline: the S2 re-ranker at k = 26 over the refined table",
    ), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:112",
        launches=pool_launches["flash_attention"],
        max_abs_err=max(c["max_abs_err"] for c in flash_checks), ms=f_ms, plain_ms=f_plain,
        bound_ms=f_bound, bound_by=f_by, library_ms=f_lib,
        shape=dict(bh=q.shape[0], bhkv=k.shape[0], s=q.shape[1], hd=q.shape[2],
                   window=kw["window"], dtype=str(q.dtype)),
        library="scaled_dot_product_attention with the same boolean mask, kv repeated",
        ms_by_route=f_ms_by_route, launches_by_route=pool_flash_routes, checks=flash_checks,
    ), dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:102",
        launches=pool_launches["ssd_scan"],
        max_abs_err=max(max(c["max_abs_err_y"], c["max_abs_err_state"]) for c in ssd_checks),
        ms=s_ms, plain_ms=s_plain, bound_ms=s_bound, bound_by=s_by, library_ms=None,
        shape=dict(x=list(x0.shape), g=ssd_args[3].shape[2], n=ssd_args[3].shape[3],
                   chunk=ssd_args[5], dtype=str(x0.dtype)),
        tile=ssd_kernel.TILE, call_ms=s_call_ms, device_ms=s_device_ms,
        device_ms_by_phase=s_phase_ms,
        checks=ssd_checks,
    )]
    summary = dict(card=card, seconds=time.perf_counter() - t_start, runs=runs,
                   profiled=[{k: v for k, v in p.items() if k != "per_kernel_ms"}
                             for p in profiled],
                   pool={k: v for k, v in pool_stats.items() if k != "decode_ms"},
                   model_check_max_abs_err=model_err, init_fan_in=conditioning,
                   pipeline=dict(rows=pipe_rows, serve_near_tie_rows=pipe_serve,
                                 rerank_candidates_near_tie_rows=n_cand_rule,
                                 seconds=pipe_s),
                   loop=loop)
    log("summary " + json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
