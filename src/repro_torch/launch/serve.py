"""Serving launcher: the OATS gateway in front of a backend pool.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --requests 32 --max-new-tokens 8                 # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --requests 8 --max-new-tokens 4                  # on the CPU

Counterpart of `repro/launch/serve.py`, with the same arguments, printed
lines and shutdown order. It wires together the full paper pipeline
(Fig. 2): a synthetic MetaTool-like tool database, the OATS offline
refinement job (Stage 1 + validation gate + atomic table swap), the
serving path (embed -> top-K -> attach tools, on the fused backend the
`topk_sim` kernel), and a backend model pool of any family doing real
prefill + greedy decode (on the card the `flash_attention` and `ssd_scan`
kernels in every prefill, and the VLM's cross-attention through
`flash_attention` in decode too; codebook prompts [1, 32, K] and zero
image embeddings, as the reference feeds them), with the telemetry plane
around it: SLO engine, JIT profiler, flight recorder, sampling profiler
and the `ObsServer`.

`--device` is `cuda` unless the caller asks for the CPU; without a card
the launcher raises (`resolve_device`), it never carries on on the CPU.
`--backend fused` is the counterpart of the reference's `pallas`. Like the
reference, the launcher draws the model's weights with `init` as they are
and does not rescale the attention init (ROADMAP.md queue 3, "the
attention init's fan-in"); `chip_smoke.py`'s pool phase does. Unlike the
reference, the SIGTERM handler it installs is put back on exit, so a
process that calls `main` twice does not keep the first run's teardown,
and on the card it launches the fused backend's routes once before the
profiler's baseline (`ToolIndexManager.warm`): CUDA loads a route's
kernels at its first launch, and a load after the baseline would count as
a production retrace.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.pipeline import OATSPipeline, PipelineConfig, STAGE_PRESETS
from repro_torch.data.benchmarks import make_metatool_like, scale_tool_corpus
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.index import BACKENDS
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.obs import (
    EventBus,
    FlightRecorder,
    HealthMonitor,
    JitProfiler,
    ObsServer,
    QualityConfig,
    QualityMonitor,
    RouteTracer,
    SamplingProfiler,
    SLOEngine,
    TimeSeriesRing,
    get_registry,
    stamp_router_costs,
)
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.latency import percentile_stats
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

__all__ = ["PROMPT_LEN", "MAX_CACHE_LEN", "build_router", "generate", "main", "pool_config",
           "printed_results"]

PROMPT_LEN = 32  # the stub-tokenized request the pool prefills
MAX_CACHE_LEN = 64  # KV slots the prefill sizes for the decode steps


def build_router(
    bench,
    stage: str = "oats-s1",
    k: int = 5,
    backend: str = "dense",
    num_tools: int = 0,
    seed: int = 0,
    tracer=None,
    bus=None,
    quality=None,
    cache=None,
    cleanups=None,
    device=None,
):
    """Gateway over the refined table; `backend` picks the index scorer.

    `num_tools > bench.n_tools` tiles + perturbs the refined table to that
    size (`scale_tool_corpus`) — the MCP-registry-scale demo. Scaled row i
    is a clone of base tool `i % bench.n_tools` (provenance by modulo).

    `cleanups`, when passed, collects the detach handles of any listeners
    this function registers on the database (bus/quality watches) so the
    caller can unregister them at shutdown instead of leaking them across
    instances. The pipeline fits and the router serves on `device`
    (`None`: the card).
    """
    device = resolve_device(device)
    detach = (cleanups.append if cleanups is not None else lambda fn: None)
    enc = BagEncoder(bench.vocab, device=device)
    # offline control plane: fit the requested OATS stage, then deploy it
    pipe = OATSPipeline.fit(bench, PipelineConfig(stages=STAGE_PRESETS[stage], k=k), enc,
                            device=device)
    if num_tools and num_tools < bench.n_tools:
        raise SystemExit(
            f"--num-tools {num_tools} is below the native table size "
            f"({bench.n_tools}); the scaler only tiles up — "
            f"use --n-tools for a smaller benchmark"
        )
    if num_tools and num_tools > bench.n_tools:
        base_t = bench.n_tools
        table = scale_tool_corpus(np.asarray(pipe.tool_table), num_tools, seed=seed)
        records = [
            ToolRecord(
                i,
                f"tool_{i % base_t}" + ("" if i < base_t else f"_clone{i // base_t}"),
                bench.desc_tokens[i % base_t],
                int(bench.tool_category[i % base_t]),
            )
            for i in range(num_tools)
        ]
        db = ToolsDatabase(records, table)  # refined table baked in at scale
        if bus is not None:
            detach(bus.watch_db(db))
        if quality is not None:
            detach(quality.watch_db(db))
    else:
        records = [
            ToolRecord(i, f"tool_{i}", bench.desc_tokens[i], int(bench.tool_category[i]))
            for i in range(bench.n_tools)
        ]
        db = ToolsDatabase(records, enc.encode(bench.desc_tokens))
        # watch BEFORE the deploy swap: every table move — this one, later
        # controller swaps, guard rollbacks, out-of-band deploys — must land
        # on the bus (and refresh the drift detector's reference stats)
        if bus is not None:
            detach(bus.watch_db(db))
        if quality is not None:
            detach(quality.watch_db(db))
        # the §7.2 deploy step, exercised; the db was constructed just above
        # so version 0 is the only possible live version — the CAS still
        # guards against this block ever being reordered after serving starts
        db.swap_table(pipe.tool_table, expect_current=0)
    router = SemanticRouter(
        db,
        embed_fn=lambda toks: enc.encode_one(toks),
        embed_batch_fn=enc.encode,  # one encoder call per route_batch
        k=k,
        backend=backend,
        tracer=tracer,
        bus=bus,
        quality=quality,
        cache=cache,
        device=device,
    )
    # purge version-dead cache entries eagerly on swap/stage_swap (lookup
    # stamps already make stale serves impossible; this reclaims memory and
    # emits the `cache_invalidated` event the runbook watches)
    if cache is not None and bus is not None:
        detach(cache.watch(bus))
    # demo timing should reflect the index path, not the mid-build fallback
    if not router.index.wait_ready(timeout_s=300.0):
        print(
            f"WARNING: {backend} index never became fresh "
            f"(stats: {router.index.stats}); serving the exact dense fallback"
        )
    return router, pipe


def pool_config(arch: str, smoke: bool) -> ModelConfig:
    """The backend model: `arch` at full width, or reduced with `smoke`."""
    cfg = get_config(arch)
    return reduced(cfg) if smoke else cfg


def generate(
    cfg: ModelConfig, params, prompt: torch.Tensor, max_new_tokens: int
) -> Tuple[List[Union[int, List[int]]], List[torch.Tensor]]:
    """One request through the pool, as the reference's launcher runs it:
    prefill `prompt` [1, S] ([1, S, K] for a codebook model; a VLM's with
    zero image embeddings [1, I, d_model], as the reference feeds) with a
    `MAX_CACHE_LEN`-slot cache, take the greedy token, then
    `max_new_tokens - 1` greedy decode steps at positions S, S+1, ...
    Returns (the tokens, each an int or a list of K ids, and each step's
    last-position logits [1, 1, (K,) V]); at least one token, from the
    prefill."""
    batch = {"tokens": prompt}
    if cfg.cross_attn_every:
        batch["image_embeds"] = torch.zeros((1, cfg.n_image_tokens, cfg.d_model),
                                            device=prompt.device)
    logits, cache = M.prefill(cfg, params, batch, max_cache_len=MAX_CACHE_LEN)
    steps = [logits[:, -1:]]
    tok = torch.argmax(steps[-1], dim=-1)  # [1, 1] or [1, 1, K]
    tokens = [tok]
    for step in range(max_new_tokens - 1):
        logits, cache = M.decode_step(cfg, params, cache,
                                      {"token": tok, "pos": prompt.shape[1] + step})
        steps.append(logits[:, -1:])
        tok = torch.argmax(steps[-1], dim=-1)
        tokens.append(tok)
    return [t.reshape(-1).tolist() if cfg.n_codebooks else int(t) for t in tokens], steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pipeline, the router and the pool "
                         "run on (default: the CUDA card; raises without "
                         "one); pass cpu to run on the CPU")
    ap.add_argument("--stage", default="oats-s1", choices=sorted(STAGE_PRESETS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--route-batch", type=int, default=16,
                    help="queries per batched route_batch call")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--n-tools", type=int, default=199)
    ap.add_argument("--n-queries", type=int, default=800)
    ap.add_argument("--backend", default="dense", choices=sorted(BACKENDS),
                    help="index scorer behind route_batch (repro_torch.index); "
                         "fused is the hand-written topk_sim kernel, the "
                         "counterpart of the JAX package's pallas backend")
    ap.add_argument("--num-tools", type=int, default=0,
                    help="tile+perturb the tool table to this size "
                         "(> --n-tools; 0 = no scaling) — the index-at-scale demo")
    ap.add_argument("--learn", action="store_true",
                    help="after serving, run one learning-plane step "
                         "(repro_torch.learn) over the logged outcomes: the "
                         "recommend_stages density plan decides whether the "
                         "adapter/re-ranker even train, and any promotion "
                         "is held-out-gated and hot-swapped into the router")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics (Prometheus), /health (JSON; 503 on "
                         "a failing daemon loop), and /events on "
                         "127.0.0.1:PORT (0 = ephemeral port, printed)")
    ap.add_argument("--trace-every", type=int, default=8,
                    help="route-trace sampling rate (~1-in-N batches)")
    ap.add_argument("--trace-export", metavar="PATH", default=None,
                    help="write sampled route traces as JSONL on exit "
                         "(render with `python -m repro_torch.obs.report PATH`)")
    ap.add_argument("--dump-dir", metavar="DIR", default=None,
                    help="flight-recorder black-box dumps land here on "
                         "slo_burn/quality_drift/loop_error/rollback/"
                         "demotion or a fatal crash (postmortem: "
                         "`python -m repro_torch.obs.report replay DIR`)")
    ap.add_argument("--profile-daemons", action="store_true",
                    help="opt-in sampling wall-clock profiler over the "
                         "cadence daemons (exported at /profile)")
    ap.add_argument("--route-cache", action="store_true",
                    help="front route_batch with SemanticRouteCache: "
                         "near-duplicate queries are served the cached "
                         "top-K without paying embed-adjacent score+rerank "
                         "(exact version-stamped invalidation; see "
                         "repro_torch.cache for the config tradeoffs)")
    ap.add_argument("--cache-threshold", type=float, default=0.95,
                    help="min cosine(stored query, new query) to serve a "
                         "cached decision (the correctness knob)")
    ap.add_argument("--cache-capacity", type=int, default=65536,
                    help="retained key slots; one decision occupies "
                         "n_tables (8) slots, LRU-evicted beyond this")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # refuse what cannot run before any work: no card
    device = resolve_device(args.device)
    cfg = pool_config(args.arch, args.smoke)

    # telemetry plane: metrics go to the process registry (the router
    # records into it by default), lifecycle events to one shared bus,
    # sampled traces to a bounded ring; the judgement layer (timeseries
    # ring + SLO engine + quality monitor) watches all three
    bus = EventBus()
    tracer = RouteTracer(sample_every=max(args.trace_every, 1), seed=args.seed)
    quality = QualityMonitor(QualityConfig(drift_every=4),
                             registry=get_registry(), bus=bus)
    cleanups = []
    cache = None
    if args.route_cache:
        from repro_torch.cache import CacheConfig, SemanticRouteCache

        cache = SemanticRouteCache(
            CacheConfig(threshold=args.cache_threshold,
                        capacity=args.cache_capacity, seed=args.seed),
            metrics=get_registry(), bus=bus,
        )

    print("== building tool benchmark + OATS control plane ==")
    bench = make_metatool_like(seed=args.seed, n_tools=args.n_tools, n_queries=args.n_queries)
    router, pipe = build_router(
        bench, args.stage, backend=args.backend, num_tools=args.num_tools,
        seed=args.seed, tracer=tracer, bus=bus, quality=quality,
        cache=cache, cleanups=cleanups, device=device,
    )
    print(f"== index backend: {args.backend} over {len(router.db)} tools ==")

    ring = TimeSeriesRing(get_registry(), bus=bus)
    slo_engine = SLOEngine(ring, bus=bus, registry=get_registry())
    monitor = HealthMonitor(routers=[router], indexes=[router.index], bus=bus,
                            slo=slo_engine)
    # live load telemetry over the gateway's hot path: the router build
    # above loaded the kernel library (fused backend), and on the card the
    # warm-up below launches every route a route_batch can take (each padded
    # bucket up to --route-batch, at k and at a live re-ranker's k x the
    # candidate multiplier), so CUDA's lazy loads of the routes' kernels
    # land before the first collect(), the warmup baseline; anything counted
    # after it (a new route, a library load) is the port's production retrace
    router.index.warm(args.route_batch, (router.k, router.k * router.candidate_multiplier))
    profiler = JitProfiler(registry=get_registry())
    profiler.collect()
    stamp_router_costs(profiler, router, batch_size=args.route_batch)
    recorder = None
    if args.dump_dir:
        recorder = FlightRecorder(
            args.dump_dir, bus=bus, registry=get_registry(), tracer=tracer,
            ring=ring, slo=slo_engine, health=monitor, profiler=profiler,
            routers=[router],
        )
        print(f"== flight recorder armed: dumps -> {args.dump_dir} ==")
    sampler = SamplingProfiler() if args.profile_daemons else None
    obs_server = None
    if args.metrics_port is not None:
        # the ring's cadence is also the SLO judgement cadence (and the
        # load-probe poll): one daemon snapshots the registry, counts
        # post-warmup loads and first launches, and evaluates burn rates on
        # every tick
        ring.start(
            interval_s=1.0,
            on_tick=lambda r: (profiler.collect(), slo_engine.evaluate()),
        )
        if sampler is not None:
            sampler.watch_thread(ring.thread(), "timeseries-ring")
            sampler.start()
        obs_server = ObsServer(monitor, get_registry(), bus,
                               port=args.metrics_port,
                               slo=slo_engine, tracer=tracer,
                               recorder=recorder, profiler=profiler,
                               sampler=sampler).start()
        print(f"== obs: http://{obs_server.host}:{obs_server.port}"
              f"{{/metrics,/health,/events,/slo,/traces,/dumps,/profile}} ==")

    # orderly teardown, shared by the normal exit path and the signal path:
    # recorder first (stop turning shutdown noise into dumps), then the
    # cadence daemons, then the HTTP surface, then the db listeners this
    # process attached — idempotent end to end, so signal-then-finally is
    # safe
    def _shutdown(*_sig):
        if recorder is not None:
            recorder.stop()
        if sampler is not None:
            sampler.stop()
        ring.stop()
        if obs_server is not None:
            obs_server.stop()
        while cleanups:
            cleanups.pop()()

    previous = None
    try:
        # orderly stop on SIGTERM; signal handlers only install from the
        # main thread (tests drive main() from workers — skip there)
        previous = signal.signal(signal.SIGTERM,
                                 lambda *sig: (_shutdown(), sys.exit(143)))
    except ValueError:
        pass

    # fatal-exception hook: anything that kills the serving body below
    # becomes one black-box dump before the process dies — the launcher
    # analogue of the controllers' daemon-loop crash hook
    try:
        return _serve_body(args, cfg, device, bench, router, pipe, bus, tracer, quality,
                           monitor)
    except BaseException as exc:
        if recorder is not None and not isinstance(exc, SystemExit):
            recorder.record_crash(exc, source="launch.serve")
        raise
    finally:
        _shutdown()
        router.close()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _serve_body(args, cfg, device, bench, router, pipe, bus, tracer, quality, monitor):
    print("== loading backend pool ==")
    params = M.init(cfg, torch.Generator(device).manual_seed(args.seed), device)
    if device.type == "cuda":
        # the init's kernels run behind the host; without this wait the
        # first route_batch, whose results come back to the host, waits
        # for them and its selection latency counts the pool's init
        torch.cuda.synchronize(device)

    test = bench.test_idx[: args.requests]
    hits, lat = 0, []
    t_start = time.time()
    rng = np.random.default_rng(args.seed)
    # 1) router: select tools (the paper's single-digit-ms path), batched —
    #    each route_batch call scores a whole block of queries in one top-K
    #    pass (on the fused backend, the topk_sim kernel)
    bs = max(args.route_batch, 1)
    results = []
    for lo in range(0, len(test), bs):
        chunk = test[lo : lo + bs]
        results.extend(router.route_batch([bench.query_tokens[q] for q in chunk]))
    base_t = bench.n_tools  # scaled tool i is a clone of base tool i % base_t
    for qi, res in zip(test, results):
        lat.append(res.latency_ms)
        hits += int(any(t % base_t == bench.relevant[qi][0] for t in res.tools))
        # 2) backend: prefill the (stub-tokenized) request + decode new
        #    tokens; a codebook model takes K ids a position, a VLM zero
        #    image embeddings (in generate), as in the reference
        prompt_shape = (1, PROMPT_LEN, cfg.n_codebooks) if cfg.n_codebooks else (1, PROMPT_LEN)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, prompt_shape)).to(device)
        generate(cfg, params, prompt, args.max_new_tokens)
        # 3) feedback: log the outcome for the next refinement cycle
        for t in res.tools:
            router.record_outcome(bench.query_tokens[qi], t, int(t in bench.relevant[qi]))

    stats = percentile_stats(lat)
    print(
        f"served {len(test)} requests in {time.time() - t_start:.1f}s | "
        f"router R@{router.k}: {hits / len(test):.3f} | "
        f"selection p50={stats.p50_ms:.2f}ms p99={stats.p99_ms:.2f}ms"
    )
    print(f"outcome log: {len(router.outcome_log)} events (feeds the next cron refinement)")
    print(f"index stats: {router.index.stats}")
    if router.cache is not None:
        print(f"route cache: hit_rate={router.cache.hit_rate():.3f} "
              f"stats={router.cache.stats}")
    print(f"health: {monitor.snapshot()['status']} | bus events: {bus.counts()}")
    q = quality.summary()
    drift = q["drift_score"]
    print(f"quality: drift_score={drift:.3f} "
          f"(drifting={q['drifting']})" if drift is not None
          else "quality: no drift reference")
    if args.trace_export:
        n = tracer.export_jsonl(args.trace_export)
        print(f"wrote {n} route traces to {args.trace_export} "
              f"(render: python -m repro_torch.obs.report {args.trace_export})")

    if args.learn:
        from repro_torch.control import OutcomeStore
        from repro_torch.learn import LearnConfig, LearningController

        print("== learning plane: one density-gated step over the outcome log ==")
        store = OutcomeStore(n_tools=len(router.db))
        store.drain_router(router)
        learner = LearningController(
            router.db, store, router, pipe.encoder.encode,
            config=LearnConfig(min_new_events=1, min_queries=10),
            bus=bus,
        )
        report = learner.step()
        plan = report.plan
        print(f"plan: density {plan.density:.2f} ev/tool -> "
              f"{sorted(plan.stages)} ({plan.reason})")
        for stage, d in sorted(report.decisions.items()):
            print(f"  {stage:8s}: {d.action} {d.reason}")
        print(f"live stages: {sorted(report.active) or '(none)'} "
              f"(stage v{report.stage_version})")
    # shutdown (recorder -> daemons -> server -> listeners -> router) runs
    # in main()'s finally via _shutdown, shared with the SIGTERM path
    return stats


def printed_results(text: str) -> dict:
    """What `main` printed, read back: R@5 ("r5"), the serving seconds and
    selection p50/p99 ("serve_s", "selection_ms"), the outcome-log count,
    the index stats, the route cache's line, the health status, the plan,
    each stage's decision line, the live stages and the traces written.
    The JAX package's launcher prints the same lines."""
    import ast
    import re

    got = {"decisions": []}
    for line in text.splitlines():
        if line.startswith("served "):
            got["r5"] = float(re.search(r"router R@\d+: ([0-9.]+)", line).group(1))
            got["serve_s"] = float(re.search(r"in ([0-9.]+)s", line).group(1))
            got["selection_ms"] = [float(x) for x in re.findall(r"p(?:50|99)=([0-9.]+)ms", line)]
        elif line.startswith("outcome log:"):
            got["outcomes"] = int(line.split()[2])
        elif line.startswith("index stats: "):
            got["index"] = ast.literal_eval(line[len("index stats: "):])
        elif line.startswith("route cache: "):
            got["cache"] = line
        elif line.startswith("health: "):
            got["health"] = line.split()[1]
        elif line.startswith(("plan: ", "live stages: ")):
            got[line.split(":")[0]] = line
        elif re.match(r"  \w+ *: ", line):
            got["decisions"].append(line)
        elif line.startswith("wrote "):
            got["traces"] = int(line.split()[1])
    return got


if __name__ == "__main__":
    main()
