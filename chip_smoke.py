#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a Hopper card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX and nothing of the JAX
package `repro`. Phases, each of which fails the run by raising:

  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile the hand-written kernels from `src/repro_torch`;
  3. kernels — hold each kernel against its plain PyTorch version on the
               card, at the main path's shapes and at edge cases;
  4. serve   — route 600 ToolBench-like queries over a 100,000-tool table
               through `SemanticRouter(backend="fused")`, bare and with an
               adapter, in batches of 8 and of 64; re-rank at the native
               2,413 tools; a CAS table swap. Results must equal those of
               the dense backend on the card, and the kernel's launch count
               must rise during this phase;
  5. times   — CUDA-event times of each kernel, its plain version and the
               library call, beside the bound computed from this run's
               shapes; per-phase p50 and per-batch p50/p99 of the gateway.

The second-to-last line is the `kernels` JSON object, the last line
`{"ok": true, "device": {...}}`. TF32 is switched off for matmuls and
convolutions: every float32 product here runs in full float32.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores; the kernel's float32 FMAs run on the latter
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
NEAR_TIE = 1e-5  # clone tables: adjacent plain-version scores closer than this may swap
SCORE_ATOL = 1e-5
N_TOOLS = 100_000
BATCH_SIZES = (8, 64)
DEVICE = "cuda"


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


def topk_bound(n_q: int, n_t: int, d: int, k: int):
    """(ms, "bytes" | "operations"): the least time for this call's work."""
    nbytes = 4 * (n_q * d + n_t * d) + n_q * k * (4 + 8)
    flops = 2 * n_q * n_t * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.core.reranker import LAYERS
    from repro_torch.data.benchmarks import make_toolbench_like, scale_tool_corpus
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.kernels.topk_sim.ref import topk_sim_ref
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.router.gateway import PHASES, SemanticRouter
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
    topk_kernel.build()
    info = topk_kernel.build_info
    log(f"build: topk_sim {info['seconds']:.2f} s (cached={info['cached']}) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # --------------------------------------------------- 3. kernels vs plain
    max_err = 0.0
    checks = []

    def check(name, q, t, k, tie=None):
        """Kernel against plain version: scores within SCORE_ATOL; indices
        exactly equal, or (clone tables, `tie` given) equal up to
        reordering inside adjacent plain-version scores closer than `tie`."""
        nonlocal max_err
        ks, ki = topk_kernel.topk_sim_cuda(q, t, k)
        torch.cuda.synchronize()
        rs, ri = topk_sim_ref(q, t, k)
        if tie is None:
            if not torch.equal(ki, ri):
                raise AssertionError(f"{name}: indices differ from the plain version")
            err, n_tie_rows = compare_topk(ks, ki, rs, ri, 0.0)
            rule = "indices exact"
        else:
            err, n_tie_rows = compare_topk(ks, ki, rs, ri, tie)
            rule = f"rows reordered inside near-ties (<{tie:g}): {n_tie_rows}"
        max_err = max(max_err, err)
        checks.append(dict(case=name, shape=[q.shape[0], t.shape[0], q.shape[1], k],
                           max_abs_err=err, near_tie_rows=n_tie_rows))
        log(f"kernel check {name} Q={q.shape[0]} T={t.shape[0]} D={q.shape[1]} k={k}: "
            f"max|ds|={err:.3g}, {rule}")

    for n_q, n_t, d, k in [(1, 2413, 384, 5), (8, 2413, 384, 25), (64, 100_000, 384, 25),
                           (128, 100_000, 384, 5), (33, 100_003, 384, 25),
                           (64, 100_000, 384, 5), (5, 300, 64, 128)]:
        check("random", unit_rows(n_q, d, gen), unit_rows(n_t, d, gen), k)
    # one-hot rows tiled so that bitwise ties cross every tile and split
    # boundary: lowest-index-first is the only right order
    base = torch.zeros((9, 128), device=dev)
    base[torch.arange(9), torch.arange(9)] = 1.0
    ties = base.repeat(11_111, 1).contiguous()
    for n_q, k in [(40, 8), (4, 128)]:
        q = unit_rows(n_q, 128, gen)
        ks, ki = topk_kernel.topk_sim_cuda(q, ties, k)
        rs, ri = topk_sim_ref(q, ties, k)
        if not torch.equal(ki, ri):
            raise AssertionError("tie order differs from the plain version")
        best = q[:, :9].argmax(dim=1)
        if not torch.equal(ki, best[:, None] + 9 * torch.arange(k, device=dev)[None, :]):
            raise AssertionError("ties not resolved to the lowest index")
        err = float((ks - rs).abs().max())
        max_err = max(max_err, err)
        checks.append(dict(case="ties", shape=[n_q, ties.shape[0], 128, k],
                           max_abs_err=err, near_tie_rows=0))
        log(f"kernel check ties Q={n_q} T={ties.shape[0]} k={k}: exact, max|ds|={err:.3g}")

    # ------------------------------------------------------ 4. the main path
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
    check("clones", torch.from_numpy(q_all[:64]).to(dev), torch.from_numpy(big).to(dev),
          25, tie=NEAR_TIE)

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
    log(f"main path: {time.perf_counter() - t_serve:.1f} s, topk_sim launches {main_launches}")
    if main_launches == 0:
        raise AssertionError("the main path never launched the topk_sim kernel")

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

    # ----------------------------------------------------------------- 5. times
    table_big = torch.from_numpy(big).to(dev)
    table_native = torch.from_numpy(native).to(dev)
    shapes = []
    for n_q, table, k in [(8, table_big, 5), (64, table_big, 5),
                          (8, table_native, 25), (64, table_native, 25)]:
        q = torch.from_numpy(q_all[:n_q]).to(dev)
        n_t, d = table.shape
        ms = cuda_ms(lambda: topk_kernel.topk_sim_cuda(q, table, k))
        plain = cuda_ms(lambda: topk_sim_ref(q, table, k))
        lib = cuda_ms(lambda: torch.topk(q @ table.T, k))
        bound, bound_by = topk_bound(n_q, n_t, d, k)
        shapes.append(dict(shape=[n_q, n_t, d, k], ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_by=bound_by))
        log(f"time topk_sim Q={n_q} T={n_t} D={d} k={k}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, torch.topk(q@t.T) {lib:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}) on {card}")
    head = shapes[1]  # the bare path's full batch: Q=64 over 100,000 tools
    kernels = [dict(
        name="topk_sim", route="cuda", source="src/repro_torch/kernels/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:89", launches=main_launches,
        max_abs_err=max_err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        shape=head["shape"], shapes=shapes, checks=checks,
        index_agreement="exact except reordering inside near-ties (rows counted in checks)",
    )]
    summary = dict(card=card, seconds=time.perf_counter() - t_start, runs=runs,
                   profiled=[{k: v for k, v in p.items() if k != "per_kernel_ms"}
                             for p in profiled])
    log("summary " + json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
