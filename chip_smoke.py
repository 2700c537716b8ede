#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path, model pool (every family),
offline OATS pipeline, online refinement loop, learning plane, IVF backend,
serve launcher, training path, runtime checks and multi-device runtime once
on one NVIDIA card.

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
               bitwise against the split route, select also at k = 130
               (over 2,413 to 100,003 rows), k = T and D = 1,536, which
               only it takes; and flash attention
               on both its kernels: wgmma for bf16, fma for float32 and for
               bf16 with hd % 8 != 0, each launch checked against the route
               `topk_route` or `flash_route` gives; the SSD scan also on
               strided bf16 slices of one xBC tensor, as ssm_block passes
               them); the flash
               attention and SSD scan kernels also at the inputs that a
               2,048-token prompt gives them in layers 0 and 31 of
               full-width hymba-1.5b, and the whole reduced model with the
               kernels against the same model with the plain versions; the
               launcher's shapes too: topk_sim at batch 16 over 100,000
               and 199 tools, flash at hymba-1.5b's and qwen2.5-3b's
               32-token prefill, the scan at hymba-1.5b's.
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
  9. learn   — (run before 7) benchmarks/learn_bench.py's density sweep
               through fused routers (MetaTool-like, 600 tools, windows
               of 0.2 / 0.5 / 1.0 of 2,800 train queries, 400 test
               queries, five trainer seeds): refine-only NDCG@5 within
               S1_NDCG_ATOL of the JAX package's, the +adapter and
               +reranker means over the seeds inside its bands, no gated
               promotion regressing past scenarios.REGRESSION_TOL; trainer seconds
               and gate margins under GATE_TIE printed; then
               examples/live_loop.py --stages' three acts with their
               asserts, the learning controller on its daemon thread
               beside serving (no failed step, no train_failed, no
               loop_error, health ok), and batches of 64 at 2,413 tools
               stage-free and with the adapter and the re-ranker live
               (C = 25: cluster);
 10. ivf     — (run before 7) IVF over the 100,000-tool table: cold and
               warm builds (seconds, k-means iterations), Recall@5 >=
               0.98 against the fused backend's exact top-5, batches of 64
               and 8 in turns with a fused router, and a swap and a
               rollback under load with async_rebuild (batches served
               exact and by the index counted, every result's scores the
               similarities of the table its version names, no build
               failure);
 11. launch  — (run before 7) `repro_torch.launch.serve.main` in process,
               as a user runs it (LAUNCH_RUNS): (a) full-width hymba-1.5b
               behind the fused router over 100,000 tools with the route
               cache, the learning step and the whole obs plane, (b)
               full-width qwen2.5-3b after S3's fit; each again with
               --smoke --device cpu, which must print the same R@5 (bar
               rows reordered inside near-ties, counted), outcome count,
               index stats, cache line, plan, decisions, traces and dumps
               (burns of the 10 ms latency SLO apart: the CPU's batches
               over 100,000 tools take ~40 ms), health ok on the card; (b)
               deploys a table S3's adapter transformed, trained from one
               seed's draws (a CPU generator) on each device: the two
               tables within TRAINED_TABLE_ATOL and R@5 held as (a)'s;
               run (c)'s stage decisions equal, their held-out NDCG@5
               within DECISION_ATOL; every kernel call on the route its route
               function gives, one flash and one scan call a layer a
               request; the topk_sim probe counts the library plus every
               route launched so far, and a JitProfiler baselined after
               (a) counts nothing over a second identical serving pass; no
               nvcc run; prints the selection p50/p99, prefill and decode
               ms, the library loads and first launches, and route_batch
               at batch 16 over 100,000 tools with the full obs plane
               against a bare router, in turns;
 12. families — (run before 7) the pool's other families at full width
               in bf16, seeded (FAMILIES): musicgen-medium whole (4
               codebooks), dbrx-132b 4 of 40 layers, llama-3.2-vision-90b
               10 of 100 (two groups of four self layers and a gated cross
               layer over 1,600 image tokens, gates opened), arctic-480b 1
               of 35 (MoE beside the dense residual): the first three
               through `ContinuousBatcher` (16 routed requests of
               1,100-2,048 prompt tokens, 16 new, 4 slots; flash once a
               self layer a prefill and, causal=False, once a cross layer a
               prefill and a tick, all on wgmma; topk_sim once a routed
               batch on cluster; the MoE's share of assignments dropped for
               capacity a prefill and a tick), then each family's
               2,048-token prompt through `M.prefill` and greedy
               `decode_step`s (8; arctic 4) held against a teacher-forced
               `forward` at tests/test_torch_bf16.py's tolerance (MoE: with
               the capacity at T, where nothing drops; at the config's
               capacity printed), the flash kernel against its plain
               version at a captured self-attention input and at the VLM's
               cross-attention inputs of the prefill and of a decode step,
               timed with plain, SDPA and the bound; then the launcher in
               process (musicgen-medium at full width, dbrx-132b and
               llama-3.2-vision-90b at --smoke) on the card and the CPU,
               printing the same results; each family's params freed
               before the next;
 13. train   — (run before 7) the kernel ops' repair: a reduced model's
               forward on the card with grad-requiring params raises (the
               kernels have no backward); the reduced hymba, dbrx and VLM
               `loss_fn` gradients on the card within 1e-4 of the CPU's
               norm, leaf by leaf (1e-3 with the scan); then
               `repro_torch.launch.train.main` in process at full-width,
               full-depth hymba-1.5b, bf16 (TRAIN_ARGS): one step from the
               reference's init as the launcher draws it (its gradient
               norm, ~3e18, recorded: the attention fan-in fault), then
               from the init with wq, wk, wv at a d_model fan-in with AdamW
               (`--optimizer auto`) and with Adafactor: the loss must fall;
               step ms p50/p99 between card syncs, tokens/s, peak memory,
               model-FLOPs share (6 N tokens / step at 989 TFLOP/s) and the
               idle share of TRAIN_PROFILE_STEPS profiled steps; then a
               Trainer (reduced hymba, bf16) saved after two steps and
               restored into a fresh one, whose steps 3 and 4 must be
               within 1e-3 of the uninterrupted run's. No kernel launches
               on this path (every `launches_by_path` has "train": 0);
 14. runtime — (run before 7) the port's runtime checks: the retrace leg
               (`repro_torch.analysis.retrace --smoke`) in a fresh process
               over the 100,000-tool table through the fused backend, whose
               `topk_sim` probe must grow within the routes `topk_route`
               gives its padded buckets (+ 1 if the library was not
               loaded when the sweep began) and by 0 on a second sweep; the lockgraph leg in process at the native 2,413
               tools (fused): 0 cycles, 0 dispatch under a lock, 0 thread
               errors; and an upload planted under a tracked lock, which
               the watch must catch;
 15. mesh    — (run before 7) the multi-device runtime. (a) World size 1
               over NCCL, mesh (1, 1) ("data", "model"): dbrx-132b (4 of
               40 layers) through a 2,048-token prefill with
               moe_impl="shard_map" against "gspmd"; musicgen-medium
               (whole) through 8 decode steps with decode_attn="seq_shard"
               (policy tp_kvs) against the baseline, both at
               tests/test_torch_bf16.py's logits tolerance; the
               ToolBench-like table's refinement sharded over "model"
               within 1e-5; `Trainer(mesh=)` against one device; the MoE
               block's and its all-reduce's ms; the flash kernel against
               its plain version at both prefills' layer 0 and last layer
               inputs. (b) Two gloo ranks sharing the card (this script
               again, `--mesh-worker`), mesh (1, 2): the same checks against
               (a)'s results, dbrx at capacity factor 8 with each rank
               holding only its 8 of 16 experts (cut as they are drawn,
               its memory printed), the flash check at its own prefills, the
               refinement
               over uneven row blocks (1,207 + 1,206), and two
               data-parallel Trainer steps of full-width hymba-1.5b (2
               layers, float32) on a (2, 1) mesh, gradients, losses and
               params within 1e-4 of (a)'s one device;
 16. dryrun  — (run before 7) the dry-run (`repro_torch.launch.dryrun`,
               fake tensors over a fake process group) against the card.
               (a) Three programs at world size 1 (`--mesh 1x1`), each
               first dry-run in a process of its own, then run on the card
               on seeded bf16 tensors with the plain attention and scan
               (`use_kernel=False`, as the dry-run's): full-width hymba-1.5b's
               AdamW train step on 2 x 1,024 tokens (phase 13's, no remat,
               from the d_model fan-in), its 2,048-token prefill at batch 1
               and a decode step with that cache. The dry-run's FLOPs a
               device must equal FlopCounterMode's on the card exactly, its
               peak (argument + temp + output bytes) must be within
               DRYRUN_MEMORY_GAP of `max_memory_allocated()` from a reset
               with the inputs placed, less what earlier phases still
               hold (both printed), and the card's ms
               (CUDA events between syncs, median of DRYRUN_TIME_ROUNDS) is
               printed beside the roofline terms, their ratio the
               program's roofline share (recorded, no limit). (c) The
               same three as DTensor programs on the card over the (1, 1)
               mesh of an NCCL group of one (the partitioner's path:
               `common.sharding`'s project / blockwise / token_nll and the
               constraint points): the dry-run's own `CostMode` counts
               their FLOPs on the card, equal to the dry-run's, the peak
               within DRYRUN_MEMORY_GAP, no collective. (b) The
               production meshes, host-only (DRYRUN_PRODUCTION, processes
               of their own started with the phase, `--no-probe`): each
               must exit 0 and write its record; its FLOPs and argument
               bytes a device, collectives by kind and dominant term are
               printed. No kernel launches on this path;
  7. times   — CUDA-event times of each kernel, its plain version and the
               library call, beside the bound computed from this run's
               shapes (topk_sim against torch.topk(q @ t.T) in five
               alternating rounds of 200 calls, medians, at 100,000 tools
               with the wgmma and split routes forced in the same turns,
               each pass's profiler device time and the rows rescored a
               call; its routes as the table grows and, at 100,000 tools,
               as the batch grows; the host dispatch of one small call
               against its device time; the select route at the
               re-ranker's 64 x 2,413 and 64 x 100,000 at k = 130 and at
               8 x 2,413 x D = 1,536, k = 25, each pass's device time
               beside its own bound; flash attention's two kernels on
               the same bf16 inputs, in turns; each SSD scan phase's device
               time; the launcher's shapes); per-phase p50 and per-batch
               p50/p99 of the gateway.

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
import math
import os
import subprocess
import sys
import tempfile
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
FLASH_BF16_RTOL = 1e-2  # ||kernel - plain|| / ||plain|| in bf16: one rounding ~3e-3
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
# MetaTool-like (seed 0, 2,400 queries, 199 tools) through
# `repro_torch.scenarios` (its LOOP_* settings). The JAX package's
# trajectory as (events, table_version, swapped, NDCG@5), the first entry
# before any step (measured on a CPU by `python tests/test_torch_control.py`;
# the card's machine has no JAX).
LOOP_TRAJECTORY = (
    (0, 0, False, 0.804511), (1400, 1, True, 0.858980), (2800, 2, True, 0.884811),
    (4200, 2, False, 0.884811), (5600, 2, False, 0.884811), (7000, 3, True, 0.894755),
    (8400, 3, False, 0.894755))
LOOP_THREAD_INTERVAL_S, LOOP_THREAD_DEADLINE_S, LOOP_THREAD_PASSES = 0.05, 120.0, 6
BUDGET_MS = 10.0  # the paper's per-query routing budget
CHURN_BATCH, CHURN_CALLS, CHURN_SWAP_S = 64, 64, 0.002  # control_bench's churn leg
# the route cache (benchmarks/cache_bench.py's full settings)
CACHE_TOOLS, CACHE_BATCHES, CACHE_ZIPF = 25_000, 150, (0.8, 1.1, 1.4)
CACHE_QUERY_LEN, CACHE_SWAP_EVERY = 24, 15
CACHE_WARMUP = (1, 2, 4, 8, 16, 32)
CACHE_HIT_FLOOR, CACHE_AGREEMENT_FLOOR = 0.90, 0.98  # gates (s = 1.1)
CACHE_SPEEDUP_REF, CACHE_CHURN_P99_REF = 2.0, 2.5  # the reference's gates: printed only
# the learning plane (phase 9), at benchmarks/learn_bench.py's full settings
# (`repro_torch.scenarios`' LEARN_* settings), held to the JAX package's
# readings there (`scenarios.LEARN_REFINE_ONLY`, `scenarios.LEARN_BANDS`);
# the port's means are over trainer seeds 0-4
LEARN_SEEDS = tuple(range(5))
GATE_TIE = 1e-6  # a gate margin this small may flip between devices: counted
LEARN_LATENCY_CALLS = 64  # learn_bench's all-stages leg: batches of 64 at 2,413 tools
LEARN_DAEMON_INTERVAL_S, LEARN_DAEMON_DEADLINE_S = 0.05, 180.0
# IVF (phase 10) at N_TOOLS, the default IVFConfig (C ~ 4 sqrt(T), nprobe 8)
IVF_RECALL_FLOOR = 0.98  # tests/test_index.py's floor against exact
IVF_CALLS = 64  # timed batches per size
IVF_SWAP_BATCHES = 8  # index-served batches before and after each swap
# the serve launcher (phase 11), `repro_torch.launch.serve.main` in process
# as a user runs it: (a) full-width hymba-1.5b behind the fused router over
# 100,000 tools with the whole obs plane; (b) qwen2.5-3b, the launcher's
# default, with S3's fit (adapter and re-ranker trained on each device from
# one seed's draws; the adapted table deployed). Each again with --smoke
# --device cpu: the router does not depend on --smoke
LAUNCH_RUNS = {
    "a": ["--arch", "hymba-1.5b", "--backend", "fused", "--num-tools", "100000",
          "--requests", "16", "--route-batch", "16", "--max-new-tokens", "8", "--route-cache",
          "--learn", "--metrics-port", "0", "--trace-every", "1", "--profile-daemons"],
    "b": ["--arch", "qwen2.5-3b", "--stage", "oats-s3", "--backend", "fused"],
}
LAUNCH_CARD_ARGS = ()  # more arguments of the card runs (a CPU rehearsal adds --smoke)
# (c) `python -m repro_torch.launch.serve` in a process of its own, on the
# card and on the CPU: in a fresh process no route has launched before the
# launcher's warm-up, and the ring ticks through serving and the learning
# step. 480 requests over 200 tools in 30 batches, whose near-duplicate
# queries the route cache serves, and 2,400 outcome events, 12 a tool, past
# the re-ranker's density of 10: the learning step trains. At --smoke: the
# pool at full width is runs (a) and (b)'s.
LAUNCH_FRESH = ["--smoke", "--backend", "fused", "--n-tools", "200", "--n-queries", "2400",
                "--requests", "480", "--route-batch", "16", "--max-new-tokens", "8",
                "--route-cache", "--learn", "--metrics-port", "0"]
LAUNCH_FRESH_TIMEOUT_S = 240
LAUNCH_FRESH_MIN_SERVE_S = 2.0  # two ring ticks (1 s) after the first served batch
LATENCY_SLO = "route_p99_budget"  # default_slos()' 10 ms batch budget
LAUNCH_OBS_ROUNDS, LAUNCH_OBS_BATCHES = 10, 200  # the obs plane, its parts, a bare router
TRAINED_TABLE_ATOL = 1e-4  # run (b): S3's adapter, one seed, card against CPU
DECISION_ATOL = 2e-3  # run (c): held-out NDCG@5, printed to 3 places: 1e-3 + rounding
# the pool's other families (phase 12), full width, bf16, seeded; depth cut
# only where one card's 80 GB forces it: arch -> (layers kept, batcher leg
# and launcher run, decode steps of the direct leg)
FAMILIES = {
    "musicgen-medium": (None, True, 8),  # whole: 48 layers, ~1.8 B params
    "dbrx-132b": (4, True, 8),  # 4 of 40 layers, ~28 GB
    "llama-3.2-vision-90b": (10, True, 8),  # two groups of 4 self + 1 cross layer
    "arctic-480b": (1, False, 4),  # 1 of 35 layers (MoE + dense residual), ~27 GB
}
FAMILY_REQUESTS = 16  # the batcher leg: 1,100-2,048 prompt tokens, 16 new, 4 slots
FAMILY_LAUNCH = ["--backend", "fused", "--requests", "8", "--route-batch", "8",
                 "--max-new-tokens", "4", "--n-queries", "400"]
FAMILY_LAUNCH_CARD = {"musicgen-medium": (), "dbrx-132b": ("--smoke",),
                      "llama-3.2-vision-90b": ("--smoke",)}  # full dbrx / llama: 264 / 180 GB
BF16_LOGIT_ATOL = 3e-2  # tests/test_torch_bf16.py: 3e-2 + two bf16 ulps of the row's max
# the training path (phase 13): `repro_torch.launch.train.main` in process,
# as a user runs it, at full-width, full-depth hymba-1.5b (bf16), once with
# each optimizer; batch and length fit 80 GB with AdamW's float32 moments
# and the plain attention's [B, H, S, S] tensors kept for backward. The
# reference's init does not train: its attention fan-in (ROADMAP.md queue
# 3) makes the first gradient norm ~3e18 at 32 layers, so the clip leaves
# no update above the optimizers' eps or half a bf16 ulp, and larger lrs
# diverge (scripts/train_lr_sweep.py). So the measured runs start from the
# init with wq, wk, wv at a d_model fan-in (`M.attention_at_d_model_fan_in`,
# as the pool's phase serves), and one short run from the init as it is
# records the fault
TRAIN_ARGS = ["--arch", "hymba-1.5b", "--batch-size", "2", "--seq-len", "1024",
              "--steps", "12", "--lr", "3e-3"]
TRAIN_REFERENCE_STEPS = 1  # the run from the reference's init: its first gradient norm
TRAIN_CARD_ARGS = ()  # more arguments of the card runs (a CPU rehearsal adds --smoke)
TRAIN_OPTIMIZERS = ("auto", "adafactor")  # auto: AdamW below 3e10 params
TRAIN_PROFILE_STEPS = 2  # steps under torch.profiler a run, for the idle share
# the save / restore leg: a Trainer saved after 2 steps and restored into a
# fresh one, whose steps 3 and 4 must follow the uninterrupted run's; reduced
# hymba-1.5b in bf16 (the checkpoint goes through zlib at ~13 MB/s: 2 layers
# at full width take 21 s to save, the full model would take minutes)
TRAIN_RESUME_OPT, TRAIN_RESUME_ATOL = "adafactor", 1e-3
# the runtime checks (phase 14): the retrace leg in a fresh process over the
# 100,000-tool table, the lockgraph leg in process at the native 2,413 tools
LOCKGRAPH_ITERS = 12
RETRACE_TIMEOUT_S = 300
# the multi-device runtime (phase 15): (a) world size 1 over NCCL, (b) two
# gloo ranks sharing the card; models seeded alike in every process, bf16,
# full width; dbrx at phase 12's depth, each rank holding its E/m experts
MESH_SEED = 0
MESH_PREFILL_LEN = 2048
MESH_DECODE_PROMPT, MESH_DECODE_STEPS = 1024, 8  # musicgen-medium, whole
MESH_REFINE_ATOL = 1e-5  # tests/test_distributed.py's refinement tolerance
MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ = 2, 512  # hymba-1.5b full width, float32, batch 2
MESH_TRAIN_ATOL = 1e-4  # grads (||d|| / ||ref|| a leaf), losses and params (max|d|)
MESH_WORKER_TIMEOUT_S = 600
# the dry-run against the card (phase 16): (a) world-size-1 programs of
# full-width hymba-1.5b, (kind, the dry-run's shape, global batch, tokens);
# the decode step reads the prefill's cache (2,049 slots, windowed to 1,024)
DRYRUN_ARCH = "hymba-1.5b"
DRYRUN_PROGRAMS = (("train", "train_4k", 2, 1024), ("prefill", "prefill_32k", 1, 2048),
                   ("decode", "decode_32k", 1, 2049))
DRYRUN_MEMORY_GAP = 0.10  # |card peak - dry-run peak| / card peak
DRYRUN_TIME_ROUNDS = 3
DRYRUN_SEED = 0
# (b) the production meshes, host-only: (arch, shapes, mesh, more arguments)
DRYRUN_PRODUCTION = (
    ("qwen2.5-3b", "train_4k,prefill_32k,decode_32k", "single", ()),
    ("hymba-1.5b", "long_500k", "single", ()),
    ("dbrx-132b", "prefill_32k", "single", ("--moe-impl", "shard_map")),
    ("musicgen-medium", "decode_32k", "single", ("--decode-attn", "seq_shard",
                                                 "--policy", "tp_kvs")),
    ("llama-3.2-vision-90b", "prefill_32k", "single", ()),
    ("hymba-1.5b", "long_500k", "multi", ()),
)
DRYRUN_TIMEOUT_S = 420


def log(*parts) -> None:
    print(*parts, flush=True)


def flash_error(got, ref) -> dict:
    """A flash output against its plain version: max|d|, max|plain|, the
    limit on max|d| and ||d|| / ||plain||. The limit is FLASH_ATOL of the
    dtype; in bf16 also two bf16 ulps of max|plain| (2**-6 of its power of
    two), since both versions round to bf16 and differ by an element's ulp.
    A few per cent off throughout (a tail tile dropped or left unmasked)
    fails that limit, or the bf16 norm limit FLASH_BF16_RTOL, at any scale."""
    dtype = str(got.dtype).replace("torch.", "")
    d, r = got.float() - ref.float(), ref.float()
    max_ref = float(r.abs().max())
    limit = FLASH_ATOL[dtype]
    if dtype == "bfloat16" and max_ref > 0.0:
        limit = min(limit, 2 * BF16_ULP * 2.0 ** math.floor(math.log2(max_ref)))
    return dict(max_abs_err=float(d.abs().max()), max_abs_ref=max_ref, atol=limit,
                rel_norm=float(d.norm() / r.norm()) if max_ref > 0.0 else 0.0)


def flash_within(e: dict, dtype: str) -> bool:
    return e["max_abs_err"] <= e["atol"] and (dtype != "bfloat16"
                                               or e["rel_norm"] <= FLASH_BF16_RTOL)


def check_flash_call(name, q, k, v, causal=True, window=0, q_offset=0, route=None) -> dict:
    """The flash kernel against its plain version within `flash_error`'s
    limits; the launch must take the route `flash_route` gives (or `route`,
    forced). The plain version runs in float32 on the same input values,
    so a bf16 output is held for its own rounding alone: against the plain
    version's bf16 output two roundings may differ by one bf16 ulp, which
    is more than FLASH_ATOL once |out| >= 4. Returns the check's record;
    raises outside the limits."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = route or flash_kernel.flash_route(q.dtype, q.shape[2], q, k, v)
    before = dict(flash_kernel.launches_by_route)
    got = flash_kernel.flash_attention_cuda(q, k, v, route=route, **kw)
    torch.cuda.synchronize()
    if flash_kernel.launches_by_route != {**before, want: before[want] + 1}:
        raise AssertionError(f"flash_attention {name}: not launched on the {want} route")
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    dtype = str(q.dtype).replace("torch.", "")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {name}: non-finite output ({want})")
    e = flash_error(got, ref)
    said = (f"max|d|={e['max_abs_err']:.3g} (limit {e['atol']:.3g}; max|plain| "
            f"{e['max_abs_ref']:.3g}), ||d||/||plain||={e['rel_norm']:.3g}"
            + (f" (limit {FLASH_BF16_RTOL})" if dtype == "bfloat16" else ""))
    if not flash_within(e, dtype):
        raise AssertionError(f"flash_attention {name}: {said} ({dtype}, {want})")
    log(f"kernel check flash_attention {name} {dtype} {want} q{list(q.shape)} "
        f"kv{list(k.shape)} {kw}: {said}")
    return dict(case=name, dtype=dtype, route=want, bh=q.shape[0], bhkv=k.shape[0],
                sq=q.shape[1], skv=k.shape[1], hd=q.shape[2], **kw, **e)


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
    (query, row) pairs (2D FLOPs each), as this run's data needed. The
    bytes and FLOPs are the kernel's own count, `topk_sim.kernel.cost`."""
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    work = topk_kernel.cost(n_q, n_t, d, k)
    nbytes, flops = work["bytes_accessed"], work["flops"]
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
            if i in wanted:  # the kernel's arguments: the op's use_kernel is not one
                captured[key][i] = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                          for a in args),
                                    {k: v for k, v in kwargs.items() if k != "use_kernel"})
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

    def plain(fn):  # the layers pass use_kernel=None themselves: override it
        return lambda *args, **kwargs: fn(*args, **{**kwargs, "use_kernel": False})

    originals = layers.flash_attention, ssm.ssd_ops
    layers.flash_attention = plain(flash_ops.flash_attention)
    ssm.ssd_ops = types.SimpleNamespace(ssd_scan=plain(ssd_ops.ssd_scan))
    try:
        yield
    finally:
        layers.flash_attention, ssm.ssd_ops = originals


def timed_on_card(fn, into):
    """`fn`, appending each call's milliseconds, between card syncs, to `into`."""
    import torch

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn(*args, **kwargs)
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


def check_leg_routes(leg, before, table, sizes, dev, k=5):
    """The leg's topk_sim launches by route since `before`; blocks of the
    sizes in `sizes` over `table`'s rows (k candidates) must have taken the
    routes topk_route gives them, each of those routes at least once."""
    import torch

    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    got = {r: n - before[r] for r, n in topk_kernel.launches_by_route.items()}
    n_t, d = table.shape
    probe = torch.empty((1, d), device=dev)  # 16-byte aligned, as the served tensors
    want = {topk_kernel.topk_route(n, n_t, d, k, probe, probe) for n in sizes}
    if {r for r, n in got.items() if n} != want:
        raise AssertionError(f"{leg}: topk_sim launched {got}, expected the routes "
                             f"{sorted(want)} that topk_route gives {n_t} rows")
    return got


def loop_phase(dev, card, tb_bench, tb_enc, native, big):
    """Phase 8: the online refinement loop on the card. Returns the summary;
    raises on any failed check."""
    import numpy as np
    import torch

    from repro_torch import scenarios as scn
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
    pkg = scn.port_pkg(dev)
    leg_routes = functools.partial(check_leg_routes, dev=dev)

    # ---- (a) the §7.2 loop on the card, against the JAX trajectory and the
    # same loop through the port on the CPU
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    mt = make_metatool_like(seed=0, n_queries=scn.LOOP_QUERIES)
    mt_table = BagEncoder(mt.vocab, device="cpu").encode(mt.desc_tokens)
    reg = MetricsRegistry()
    tracer = RouteTracer(sample_every=16, seed=0)
    w = scn.loop_world(pkg, mt, mt_table, "fused", metrics=reg, tracer=tracer)
    refine_ms = []
    w.controller.refine_fn = timed_on_card(refine_with_gate, refine_ms)
    on_card, card_reports, _ = scn.run_loop(w, mt)
    cpu_world = scn.loop_world(scn.port_pkg("cpu"), mt, mt_table)
    on_cpu, cpu_reports, _ = scn.run_loop(cpu_world, mt)
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
    actions = scn.inject_and_roll_back(w, mt, after_inject=lambda: ndcg_bad.append(
        scn.heldout_ndcg(w, mt)))
    kinds = [e.kind for e in w.bus.events()]
    ndcg_restored = scn.heldout_ndcg(w, mt)
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
        routes=leg_routes("loop", before, mt_table, range(1, scn.LOOP_EVAL + 1)),
        seconds=time.perf_counter() - t0)
    log(f"loop: refine_with_gate on the card (main thread) ms {[round(x, 3) for x in refine_ms]}; "
        f"{len(traces)} sampled traces, paths {sorted({t.path for t in traces})}; fused index "
        f"rebuilds {w.index.stats['rebuilds']}, build ms p50 "
        f"{reg.histogram('index_build_ms').percentile(50):.3f}; topk_sim by route "
        + json.dumps(out["loop"]["routes"]) + f" on {card}")
    scn.close_world(w)
    scn.close_world(cpu_world)

    # the controller's daemon thread refines and swaps while the main thread
    # serves: every result must be the exact top-5 of the table its version
    # names (tables recorded by a swap listener; checked after the run, as
    # a batch may serve a version before the listener has run). A failed
    # step is recorded and cleared by the next good one, so the run fails
    # on any step that failed, not only on the last
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    reg = MetricsRegistry()
    w = scn.loop_world(pkg, mt, mt_table, "fused", metrics=reg)
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
            scn.serve_window(w, mt, mt.train_idx, check=keep)
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
                                                range(1, scn.LOOP_BATCH + 1)),
                              seconds=time.perf_counter() - t0)
    log(f"loop thread: controller.start({LOOP_THREAD_INTERVAL_S}) beside {passes} serving "
        f"passes: {len(w.controller.reports)} steps, {swaps} swaps, no step failed, no "
        f"loop_error event, health ok; {n_checked} results equal to their version's exact "
        f"top-5 (near-tie rows {n_rule}); refine_with_gate on the daemon thread ms "
        f"{[round(x, 3) for x in daemon_ms]}; topk_sim by route "
        + json.dumps(out["loop_thread"]["routes"]) + f" on {card}")
    scn.close_world(w)

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


def learn_phase(dev, card, tb_bench, tb_enc, native):
    """Phase 9: the learning plane on the card. Returns the summary; raises
    on any failed check."""
    import numpy as np
    import torch

    from repro_torch import scenarios as scn
    from repro_torch.core.adapter import init_adapter
    from repro_torch.core.features import OutcomeFeaturizer
    from repro_torch.core.reranker import init_mlp
    from repro_torch.data.benchmarks import make_metatool_like
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs.summary import percentile_stats
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.stages import StageSet
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    out, pkg, gate_ties = {}, scn.port_pkg(dev), []
    bench = make_metatool_like(seed=0, n_tools=scn.LEARN_TOOLS, n_queries=scn.LEARN_QUERIES)

    def note_margin(where, margin):
        if abs(margin) < GATE_TIE:
            gate_ties.append(dict(where=where, margin=margin))
            log(f"learn gate near-tie: {where} margin {margin:.3g} (< {GATE_TIE}: may flip "
                f"between devices)")

    # ---- (a) learn_bench's density sweep through fused routers (cluster)
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    points = scn.density_sweep(pkg, bench, scn.LEARN_FRACTIONS, scn.LEARN_TEST,
                              trainer_seeds=LEARN_SEEDS, backend="fused")
    failures = []
    for i, pt in enumerate(points):
        nd = pt["ndcg_at_5"]
        means = {st: float(np.mean(v)) for st, v in pt["ndcg_by_seed"].items()}
        if abs(nd["refine_only"] - scn.LEARN_REFINE_ONLY[i]) > S1_NDCG_ATOL:
            failures.append(f"point {i}: refine-only {nd['refine_only']:.6f} vs JAX "
                            f"{scn.LEARN_REFINE_ONLY[i]:.6f}")
        for st, (lo, hi) in scn.LEARN_BANDS[i].items():
            if not lo <= means[st] <= hi:
                failures.append(f"point {i}: {st} mean over seeds {means[st]:.4f} outside the "
                                f"JAX band [{lo}, {hi}]")
        if pt["promotion_regressed"]:
            failures.append(f"point {i}: promotion {pt['promoted']} regressed to "
                            f"{pt['ndcg_promoted']:.4f}")
        for st, m in pt["gate_margins"].items():
            note_margin(f"sweep point {i} {st}", m)
        log(f"learn sweep {pt['density']:.2f} ev/tool ({pt['events']} events), plan "
            f"{pt['plan']}: NDCG@5 refine-only {nd['refine_only']:.6f} (JAX "
            f"{scn.LEARN_REFINE_ONLY[i]:.6f}), +adapter {nd['plus_adapter']:.4f} (mean over "
            f"seeds {means['plus_adapter']:.4f}, JAX band {scn.LEARN_BANDS[i]['plus_adapter']}), "
            f"+reranker "
            f"{nd['plus_rerank']:.4f} (mean {means['plus_rerank']:.4f}, band "
            f"{scn.LEARN_BANDS[i]['plus_rerank']}); promoted {pt['promoted'] or '(none)'} -> "
            f"{pt['ndcg_promoted']:.4f}, gate margins "
            + json.dumps({k: round(v, 6) for k, v in pt["gate_margins"].items()})
            + f"; trainer s adapter {[round(x, 2) for x in pt['train_s']['adapter']]}, reranker "
            f"{[round(x, 2) for x in pt['train_s']['rerank']]}; refine {pt['refine_s']:.3f} s")
    if failures:
        raise AssertionError("learn sweep: " + "; ".join(failures))
    out["sweep"] = dict(points=points, seconds=time.perf_counter() - t0,
                        routes=check_leg_routes("learn sweep", before,
                                                np.zeros((scn.LEARN_TOOLS, 384)),
                                                [1, scn.LOOP_BATCH, 512], dev))

    # ---- (b) live_loop.py --stages' three acts, fused router (cluster)
    t0 = time.perf_counter()
    before = dict(topk_kernel.launches_by_route)
    acts, w = scn.stages_acts(pkg, bench)
    note_margin("act 2 adapter", acts["act2"]["gate_margin"])
    log(f"learn acts: sparse window suppressed both stages; dense window promoted adapter/"
        f"v{acts['act2']['artifact']} (held-out gate {acts['act2']['ndcg_current']:.6f} -> "
        f"{acts['act2']['ndcg_candidate']:.6f}), heldout NDCG@5 {acts['ndcg_sparse']:.6f} -> "
        f"{acts['ndcg_dense']:.6f}; corrupted StageSet {acts['ndcg_bad']:.6f}, guard "
        f"{acts['guard_actions']}, restored {acts['ndcg_restored']:.6f} (good "
        f"{acts['ndcg_dense']:.6f}); step s " + json.dumps(
            [dict(act=st["act"], s=round(st["seconds"], 3), decisions=st["decisions"])
             for st in acts["steps"]]) + f" on {card}")

    # ---- (c) the same learner on its daemon thread beside serving: the
    # window refills past the plan's 10K-event adapter threshold and the
    # adapter retrains there; every step on the daemon is timed
    daemon_steps, n_reports = [], len(w.learner.reports)
    step_on_main = w.learner.step

    def timed_step():
        t = time.perf_counter()
        rep = step_on_main()
        daemon_steps.append(dict(seconds=time.perf_counter() - t, reason=rep.reason,
                                 decisions={k: d.action for k, d in rep.decisions.items()},
                                 margins={k: d.ndcg_candidate - d.ndcg_current
                                          for k, d in rep.decisions.items()
                                          if d.ndcg_candidate is not None}))
        return rep

    w.learner.step = timed_step
    trained = {"promoted", "gate_rejected", "table_moved", "activation_conflict"}
    passes, t_daemon = 0, time.perf_counter()
    w.learner.start(interval_s=LEARN_DAEMON_INTERVAL_S)
    try:
        deadline = time.perf_counter() + LEARN_DAEMON_DEADLINE_S
        while time.perf_counter() < deadline:
            scn.serve_and_log(w.router, bench, bench.train_idx)
            passes += 1
            if any(set(st["decisions"].values()) & trained for st in daemon_steps):
                break
    finally:
        w.learner.stop()
    daemon_s = time.perf_counter() - t_daemon
    reports = w.learner.reports[n_reports:]
    failed = [r.reason for r in reports if r.reason.startswith("step failed")]
    loop_errors = w.bus.counts().get("loop_error", 0)
    health = pkg.Health(routers=[w.router], controllers=[w.learner], indexes=[w.router.index],
                        stores=[w.store], bus=w.bus).snapshot()
    train_failed = [st for st in acts["steps"] + daemon_steps
                    if "train_failed" in st["decisions"].values()]
    trained_steps = [st for st in daemon_steps if set(st["decisions"].values()) & trained]
    for st in trained_steps:
        for stage, m in st["margins"].items():
            note_margin(f"daemon {stage}", m)
    if (failed or loop_errors or w.learner.last_loop_error is not None or train_failed
            or not trained_steps or health["status"] != "ok"):
        raise AssertionError(f"learn daemon: failed steps {failed}, {loop_errors} loop_error "
                             f"events, train_failed {train_failed}, trained steps "
                             f"{len(trained_steps)}, health {health['status']!r} (index "
                             f"{health['index']}, serving {health['serving']}, stores "
                             f"{health['stores']}; decisions "
                             f"{[st['decisions'] for st in daemon_steps]})")
    quiet = [st["seconds"] for st in daemon_steps if st not in trained_steps]
    log(f"learn daemon: start({LEARN_DAEMON_INTERVAL_S}) beside {passes} serving passes in "
        f"{daemon_s:.1f} s: {len(daemon_steps)} steps, none failed, no loop_error, health ok; "
        f"training steps "
        + json.dumps([dict(s=round(st["seconds"], 3), decisions=st["decisions"])
                      for st in trained_steps])
        + f"; other steps p50 {float(np.median(quiet)) * 1e3 if quiet else 0:.3f} ms")
    out["acts"] = dict(acts, seconds=time.perf_counter() - t0, daemon=dict(
        passes=passes, seconds=daemon_s, steps=daemon_steps, health=health),
        routes=check_leg_routes("learn acts", before, np.zeros((scn.LEARN_TOOLS, 384)),
                                [1, scn.LOOP_BATCH, 512], dev))
    w.router.close()

    # ---- (d) learn_bench's latency leg: batches of 64 at 2,413 tools, stage
    # free and with both stages live (re-ranker candidates C = 25: cluster)
    before = dict(topk_kernel.launches_by_route)
    db = ToolsDatabase([ToolRecord(i, f"tool_{i}", tb_bench.desc_tokens[i],
                                   int(tb_bench.tool_category[i]))
                        for i in range(tb_bench.n_tools)], native)
    router = SemanticRouter(db, embed_fn=tb_enc.encode_one, embed_batch_fn=tb_enc.encode, k=5,
                            backend="fused", metrics=False, device=dev)
    queries = list(tb_bench.query_tokens)

    def timed_pass():
        for _ in range(2):
            router.route_batch(queries[:scn.LOOP_BATCH])
        ms = []
        with no_gc():
            for i in range(LEARN_LATENCY_CALLS):
                batch = [queries[(i * scn.LOOP_BATCH + j) % len(queries)]
                         for j in range(scn.LOOP_BATCH)]
                t = time.perf_counter()
                router.route_batch(batch)
                ms.append((time.perf_counter() - t) * 1e3)
        return percentile_stats(ms)

    bare = timed_pass()
    fit_idx = tb_bench.train_idx[:200]
    fit_q = tb_enc.encode([tb_bench.query_tokens[i] for i in fit_idx])
    retrieved = np.argsort(-(fit_q @ native.T), axis=1, kind="stable")[:, :5]
    featurizer = OutcomeFeaturizer.fit(fit_q, [tb_bench.query_tokens[i] for i in fit_idx],
                                       tb_bench.relevance_matrix()[fit_idx], retrieved,
                                       tb_bench.tool_category, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    router.set_stages(StageSet(adapter_params=init_adapter(gen), mlp_params=init_mlp(gen),
                               featurizer=featurizer), expect_version=0)
    staged = timed_pass()
    router.close()
    out["latency"] = dict(n_tools=tb_bench.n_tools, batch=scn.LOOP_BATCH, calls=LEARN_LATENCY_CALLS,
                          no_stages=bare.as_dict(), all_stages=staged.as_dict(),
                          routes=check_leg_routes("learn latency", before, native, [scn.LOOP_BATCH],
                                                  dev, k=25))
    log(f"learn latency T={tb_bench.n_tools} batch {scn.LOOP_BATCH}: per batch p50/p99 stage-free "
        f"{bare.p50_ms:.3f} / {bare.p99_ms:.3f} ms, adapter + re-ranker (C = 25) "
        f"{staged.p50_ms:.3f} / {staged.p99_ms:.3f} ms; per query p99 "
        f"{staged.p99_ms / scn.LOOP_BATCH:.4f} ms (budget {BUDGET_MS}); topk_sim by route "
        + json.dumps(out["latency"]["routes"]) + f" on {card}")
    if staged.p99_ms / scn.LOOP_BATCH > BUDGET_MS:
        raise AssertionError(
            f"learn latency: p99 per query {staged.p99_ms / scn.LOOP_BATCH:.3f} ms")
    out["gate_ties"] = gate_ties
    log(f"learn gate near-ties (|margin| < {GATE_TIE}): {len(gate_ties)}")
    return out


def ivf_phase(dev, card, tb_bench, tb_enc, big, q_all):
    """Phase 10: the IVF backend and the manager's background rebuild at
    N_TOOLS on the card. Returns the summary; raises on any failed check."""
    import numpy as np
    import torch

    from repro_torch import scenarios as scn
    from repro_torch.index import FusedBackend, IVFBackend
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs.summary import percentile_stats
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    out = {}
    before = dict(topk_kernel.launches_by_route)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t

    # ---- builds: cold, warm on a gently moved table, and cold on it
    moved = big + np.random.default_rng(0).normal(scale=1e-3, size=big.shape).astype(np.float32)
    moved /= np.maximum(np.linalg.norm(moved, axis=-1, keepdims=True), 1e-9)
    cold, cold_s = timed(lambda: IVFBackend(big, 0, device=dev))
    warm, warm_s = timed(lambda: IVFBackend(moved, 1, warm_start=cold.warm_start_state(),
                                            device=dev))
    cold_moved, cold_moved_s = timed(lambda: IVFBackend(moved, 1, device=dev))
    sizes = cold._sizes_host
    out["build"] = dict(n_clusters=cold.n_clusters, max_cluster=cold._max_cluster,
                        mean_cluster=float(sizes.mean()), cold_s=cold_s,
                        cold_iters=cold.kmeans_iters_run, warm_s=warm_s,
                        warm_iters=warm.kmeans_iters_run, cold_moved_s=cold_moved_s,
                        cold_moved_iters=cold_moved.kmeans_iters_run)
    log(f"ivf build T={big.shape[0]}: {cold.n_clusters} clusters (mean {sizes.mean():.1f} rows, "
        f"largest {cold._max_cluster}), cold {cold_s:.3f} s in "
        f"{cold.kmeans_iters_run} k-means iterations; on a table moved by 1e-3: warm "
        f"{warm_s:.3f} s in {warm.kmeans_iters_run}, cold {cold_moved_s:.3f} s in "
        f"{cold_moved.kmeans_iters_run}")
    # not gated: on this clone table near-duplicate rows keep flipping
    # between clusters, so k-means runs its full budget cold or warm (the JAX
    # package's build does the same at this size); the warm start's
    # convergence is held on the CPU (tests/test_torch_index.py)

    # ---- Recall@5 against the fused backend's exact result
    fused = FusedBackend(big, 0, device=dev)
    exact, approx, approx_s = [], [], []
    for lo in range(0, len(q_all), scn.LOOP_BATCH):
        exact.append(fused.topk(q_all[lo:lo + scn.LOOP_BATCH], 5)[1])
        s_, i_ = cold.topk(q_all[lo:lo + scn.LOOP_BATCH], 5)
        approx.append(i_)
        approx_s.append(s_)
    exact, approx, approx_s = (np.concatenate(x) for x in (exact, approx, approx_s))
    recall = float(np.mean([len(set(a) & set(b)) / 5 for a, b in zip(exact, approx)]))
    want = np.einsum("qkd,qd->qk", big[approx].astype(np.float64), q_all.astype(np.float64))
    score_err = float(np.abs(approx_s - want).max())
    out["recall"] = dict(queries=len(q_all), recall_at_5=recall, score_max_abs_err=score_err,
                         rows_equal_to_exact=float((exact == approx).all(axis=1).mean()))
    log(f"ivf recall@5 against the fused backend's exact top-5 over {len(q_all)} queries: "
        f"{recall:.4f} (floor {IVF_RECALL_FLOOR}); rows equal to exact "
        f"{out['recall']['rows_equal_to_exact']:.4f}; returned scores against float64 "
        f"similarities: max abs err {score_err:.3g}")
    if recall < IVF_RECALL_FLOOR or score_err > SCORE_ATOL:
        raise AssertionError(f"ivf recall {recall:.4f}, score error {score_err:.3g}")

    # ---- batches of 64 and 8 through an IVF router and a fused router, in turns
    nt = tb_bench.n_tools
    records = [ToolRecord(i, f"tool_{i}", tb_bench.desc_tokens[i % nt],
                          int(tb_bench.tool_category[i % nt])) for i in range(big.shape[0])]
    routers = {kind: SemanticRouter(ToolsDatabase(list(records), big), embed_fn=tb_enc.encode_one,
                                    embed_batch_fn=tb_enc.encode, k=5, backend=kind,
                                    metrics=False, device=dev)
               for kind in ("ivf", "fused")}
    if not routers["ivf"].index.wait_ready(120.0):
        raise AssertionError("ivf router: the first background build never landed")
    queries = list(tb_bench.query_tokens)
    rows = []
    for batch in (scn.LOOP_BATCH, 8):
        ms = {kind: [] for kind in routers}
        for kind, router in routers.items():
            for _ in range(2):
                router.route_batch(queries[:batch])
        with no_gc():
            for i in range(IVF_CALLS):
                qs = [queries[(i * batch + j) % len(queries)] for j in range(batch)]
                for kind in (("ivf", "fused") if i % 2 == 0 else ("fused", "ivf")):
                    t = time.perf_counter()
                    routers[kind].route_batch(qs)
                    ms[kind].append((time.perf_counter() - t) * 1e3)
        if routers["ivf"].index.last_path() != "index:ivf":
            raise AssertionError(f"ivf router served {routers['ivf'].index.last_path()}")
        row = {kind: percentile_stats(v).as_dict() for kind, v in ms.items()}
        row["batch"] = batch
        rows.append(row)
        log(f"ivf batch {batch} over {big.shape[0]} tools: per batch p50/p99 ivf "
            f"{row['ivf']['p50_ms']:.3f} / {row['ivf']['p99_ms']:.3f} ms, fused "
            f"{row['fused']['p50_ms']:.3f} / {row['fused']['p99_ms']:.3f} ms (in turns)")
    out["batches"] = rows
    routers["fused"].close()

    # ---- a swap and a rollback under load: the main thread serves batches
    # of 64 while another thread swaps; with async_rebuild the exact
    # fallback serves each new version until its background build lands
    router = routers["ivf"]
    db, manager = router.db, router.index
    tables = {db.table_version: big}
    refs = {id(big): dense_top5(q_all, big, dev), id(moved): dense_top5(q_all, moved, dev)}
    go, done, swap_ms = [threading.Event(), threading.Event()], [threading.Event(),
                                                                   threading.Event()], []
    errors = []

    def swapper():
        try:
            for step, new in enumerate((moved, big)):
                go[step].wait()
                v = db.table_version
                tables[v + 1] = new
                t = time.perf_counter()
                if step == 0:
                    db.swap_table(new, expect_current=v)
                else:
                    db.rollback(expect_current=v)
                swap_ms.append((time.perf_counter() - t) * 1e3)
                done[step].set()
        except Exception as exc:  # surfaced below
            errors.append(exc)
            for ev in done:
                ev.set()

    served, stage, count, i = [], 0, 0, 0
    build_iters = []
    th = threading.Thread(target=swapper, daemon=True)
    th.start()
    deadline = time.perf_counter() + 120.0
    try:
        while stage < 3 and time.perf_counter() < deadline:
            qi = [(i * scn.LOOP_BATCH + j) % len(queries) for j in range(scn.LOOP_BATCH)]
            i += 1
            t = time.perf_counter()
            res = router.route_batch([queries[j] for j in qi])
            ms = (time.perf_counter() - t) * 1e3
            path = manager.last_path()
            served.append((qi, res, path, ms, stage))
            fresh = stage == 0 or (done[stage - 1].is_set() and
                                   res[0].table_version == max(tables))
            if path == "index:ivf" and fresh:
                count += 1
            if count >= IVF_SWAP_BATCHES:
                if stage >= 1:
                    build_iters.append(manager._backend.kmeans_iters_run)
                if stage < 2:
                    go[stage].set()
                stage, count = stage + 1, 0
    finally:
        for ev in go:
            ev.set()
        th.join()
    if errors or stage < 3:
        raise AssertionError(f"ivf swap under load: stage {stage}, errors {errors}")
    n_exact = n_index = n_rule = 0
    hits = []
    for qi, res, path, ms, st in served:
        versions = {r.table_version for r in res}
        if len(versions) != 1:
            raise AssertionError(f"ivf swap: one batch served versions {versions}")
        table = tables[versions.pop()]
        ref_idx, ref_sc = refs[id(table)]
        for j, r in zip(qi, res):
            got = np.asarray(r.tools)
            want_sc = table[got].astype(np.float64) @ q_all[j].astype(np.float64)
            if np.abs(np.asarray(r.scores) - want_sc).max() > SCORE_ATOL:
                raise AssertionError(f"ivf swap ({path}): scores are not the similarities of "
                                     f"the table their version names")
            if path == "exact" and r.tools != ref_idx[j].tolist():
                if not same_ranking(r.tools, r.scores, ref_idx[j], ref_sc[j], NEAR_TIE):
                    raise AssertionError(f"ivf swap (exact): {r.tools} vs {ref_idx[j].tolist()}")
                n_rule += 1
            if path == "index:ivf":
                hits.append(len(set(r.tools) & set(ref_idx[j].tolist())) / 5)
        n_exact += path == "exact"
        n_index += path == "index:ivf"
    exact_ms = [x[3] for x in served if x[2] == "exact"]
    index_ms = [x[3] for x in served if x[2] == "index:ivf"]
    swap_recall = float(np.mean(hits))
    out["swap"] = dict(batches=len(served), served_exact=n_exact, served_index=n_index,
                       exact_by_stage=[sum(1 for x in served if x[2] == "exact" and x[4] == st)
                                       for st in range(3)],
                       exact_batch_ms=percentile_stats(exact_ms).as_dict(),
                       index_batch_ms=percentile_stats(index_ms).as_dict(),
                       first_exact_ms=exact_ms[0] if exact_ms else None,
                       swap_table_ms=swap_ms, rebuild_iters=build_iters,
                       recall_at_5=swap_recall, near_tie_rows=n_rule, stats=dict(manager.stats))
    log(f"ivf swap under load: {len(served)} batches of {scn.LOOP_BATCH}, {n_exact} served exact "
        f"(by stage {out['swap']['exact_by_stage']}) while a background build ran, {n_index} "
        f"by the index; exact batches p50/p99 {out['swap']['exact_batch_ms']['p50_ms']:.3f} / "
        f"{out['swap']['exact_batch_ms']['p99_ms']:.3f} ms (the first, with the snapshot's "
        f"upload, {out['swap']['first_exact_ms']:.3f}), index batches "
        f"{out['swap']['index_batch_ms']['p50_ms']:.3f} / "
        f"{out['swap']['index_batch_ms']['p99_ms']:.3f} ms; swap_table ms "
        f"{[round(x, 2) for x in swap_ms]}; rebuilt k-means iterations {build_iters} (warm "
        f"started; cold {cold.kmeans_iters_run}); recall@5 of index batches {swap_recall:.4f}; "
        f"every result's scores the similarities of its version's table; manager "
        + json.dumps(manager.stats))
    if manager.stats["build_failures"] or n_exact < 1 or swap_recall < IVF_RECALL_FLOOR:
        raise AssertionError(f"ivf swap: {manager.stats}, {n_exact} exact batches, recall "
                             f"{swap_recall:.4f}, rebuild iterations {build_iters}")
    router.close()
    tail = len(q_all) % scn.LOOP_BATCH or scn.LOOP_BATCH  # the exact reference's last block
    out["routes"] = check_leg_routes("ivf", before, big, [scn.LOOP_BATCH, 8, tail], dev)
    log("ivf: topk_sim by route (the exact reference and the fused router) "
        + json.dumps(out["routes"]) + f" on {card}")
    return out


@contextlib.contextmanager
def recording_launcher():
    """Inside the block, record every `route_batch` (router, queries,
    results) and every call of the three kernels on the launcher's path with
    the route its route function gives and the launches it made."""
    from repro_torch.index import fused_backend
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.models import layers, ssm
    from repro_torch.router.gateway import SemanticRouter

    rec = dict(batches=[], topk=[], flash=[], ssd=[])
    route_batch, topk, flash = (SemanticRouter.route_batch, fused_backend.topk_sim,
                                layers.flash_attention)
    ssd = ssm.ssd_ops.ssd_scan

    def counted(key, mod, fn, want):
        def wrapper(*args, **kwargs):
            route = want(*args)
            before = dict(getattr(mod, "launches_by_route", {"all": mod.launches}))
            out = fn(*args, **kwargs)
            after = getattr(mod, "launches_by_route", {"all": mod.launches})
            rec[key].append(dict(shape=[list(a.shape) for a in args[:2]], want=route,
                                 launched={r: n - before[r] for r, n in after.items()
                                           if n != before[r]}))
            return out
        return wrapper

    def recorded_route_batch(self, queries, *args, **kwargs):
        results = route_batch(self, queries, *args, **kwargs)
        rec["batches"].append((self, list(queries), results))
        return results

    SemanticRouter.route_batch = recorded_route_batch
    fused_backend.topk_sim = counted(
        "topk", topk_kernel, topk,
        lambda q, t, k: topk_kernel.topk_route(q.shape[0], t.shape[0], q.shape[1], k, t, q))
    layers.flash_attention = counted(
        "flash", flash_kernel, flash,
        lambda q, k, v, *_: flash_kernel.flash_route(q.dtype, q.shape[-1], q, k, v))
    ssm.ssd_ops.ssd_scan = counted("ssd", ssd_kernel, ssd, lambda *_: "all")
    try:
        yield rec
    finally:
        SemanticRouter.route_batch = route_batch
        fused_backend.topk_sim, layers.flash_attention = topk, flash
        ssm.ssd_ops.ssd_scan = ssd


def run_launcher(argv, on_card):
    """One in-process `repro_torch.launch.serve.main(argv)`: its printed
    lines, the recording of its batches and kernel calls, and on the card
    each prefill's and decode step's milliseconds between card syncs."""
    import io

    from repro_torch.launch import serve
    from repro_torch.models import model as M

    run = dict(argv=list(argv), prefill_ms=[], decode_ms=[])
    originals = M.prefill, M.decode_step
    if on_card:
        M.prefill = timed_on_card(M.prefill, run["prefill_ms"])
        M.decode_step = timed_on_card(M.decode_step, run["decode_ms"])
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with recording_launcher() as rec, contextlib.redirect_stdout(out):
            serve.main(argv)
    finally:
        M.prefill, M.decode_step = originals
    run.update(seconds=time.perf_counter() - t, text=out.getvalue(), rec=rec,
               printed=serve.printed_results(out.getvalue()))
    return run


def trains_adapter(argv) -> bool:
    """True when the launcher's `--stage` (default oats-s1) trains S3's
    adapter, which transforms the deployed table."""
    from repro_torch.core.pipeline import STAGE_PRESETS

    stage = argv[argv.index("--stage") + 1] if "--stage" in argv else "oats-s1"
    return "adapter" in STAGE_PRESETS[stage]


def launch_parity(name, card_run, cpu_run, n_requests):
    """Card against CPU: the same versions and tools a request, or a
    ranking reordered inside near-ties (< NEAR_TIE, counted); R@5 equal but
    for such rows; the same outcome count, index stats, cache line, plan,
    decisions, live stages, traces and dumps (count and reasons); health ok
    on the card, with no burn of the latency SLO (LATENCY_SLO), and on the
    CPU ok or degraded by burns of that SLO alone, whose 10 ms budget the
    CPU's batches over 100,000 tools do not meet (the SLO judges the
    device's speed; its dumps are counted apart). Where the deployed table
    was trained (S3's adapter transforms it; one seed draws the same model
    on both devices), the two tables must agree within TRAINED_TABLE_ATOL.
    Returns (rows that needed the near-tie rule, the two deployed tables'
    max abs difference)."""
    import numpy as np

    card_res = [r for _, _, res in card_run["rec"]["batches"] for r in res]
    cpu_res = [r for _, _, res in cpu_run["rec"]["batches"] for r in res]
    table_diff = float(np.abs(card_run["rec"]["batches"][0][0].db.embeddings
                              - cpu_run["rec"]["batches"][0][0].db.embeddings).max())
    if trains_adapter(card_run["argv"]) and not table_diff <= TRAINED_TABLE_ATOL:
        raise AssertionError(f"launch ({name}): the card's trained table is {table_diff:.3g} "
                             f"from the CPU's (one seed; atol {TRAINED_TABLE_ATOL})")
    n_rule = 0
    for x, y in zip(card_res, cpu_res, strict=True):
        if (x.table_version, x.stage_version) != (y.table_version, y.stage_version):
            raise AssertionError(f"launch ({name}): versions differ card vs CPU")
        if x.tools != y.tools:
            if not same_ranking(x.tools, x.scores, y.tools, y.scores, NEAR_TIE):
                raise AssertionError(f"launch ({name}): card {x.tools} vs CPU {y.tools}")
            n_rule += 1
    a, b = card_run["printed"], cpu_run["printed"]
    if abs(a["r5"] - b["r5"]) * n_requests > n_rule + 1e-9:
        raise AssertionError(f"launch ({name}): R@5 {a['r5']} on the card, {b['r5']} on the CPU")
    same = ("outcomes", "index", "cache", "plan", "decisions", "live stages", "traces", "dumps")
    for key in same:
        if a.get(key) != b.get(key):
            raise AssertionError(f"launch ({name}): {key} {a.get(key)!r} on the card, "
                                 f"{b.get(key)!r} on the CPU")
    # the card must meet the latency budget; the CPU, which serves a batch
    # over 100,000 tools in ~40 ms, may burn that SLO alone
    if a["health"] != "ok" or a["latency_burns"] or not (
            b["health"] == "ok" or b["health"] == "degraded" and b["latency_burns"]):
        raise AssertionError(f"launch ({name}): health {a['health']} / {b['health']}, latency "
                             f"SLO burns {a['latency_burns']} / {b['latency_burns']}")
    return n_rule, table_diff


def same_decisions(a, b, atol: float) -> bool:
    """Two runs' printed stage-decision lines are equal word for word, but
    for the numbers in them (held-out NDCG@5), which may differ by `atol`."""
    import re

    number = re.compile(r"-?\d+\.\d+")
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if number.sub("#", x) != number.sub("#", y):
            return False
        if any(abs(float(p) - float(q)) > atol
               for p, q in zip(number.findall(x), number.findall(y))):
            return False
    return True


def launch_phase(dev, card, ever_launched, first_launch_ms):
    """Phase 11: the serve launcher, runs (a) and (b) on the card and on the
    CPU, the probe and a second serving pass, the obs plane's cost, and run
    (c) in fresh processes. `ever_launched` holds the topk_sim routes
    launched before this phase, `first_launch_ms` phase 2's first launch of
    each route. Returns the summary; raises on any failed check."""
    import tempfile

    import numpy as np

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.nvcc import LIBRARIES
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.launch import serve
    from repro_torch.obs import list_dumps

    modules = {"topk_sim": topk_kernel, "flash_attention": flash_kernel, "ssd_scan": ssd_kernel}
    builds = sum(lib.builds for lib in LIBRARIES.values())
    out = dict(runs={}, launches=dict.fromkeys(modules, 0),
               topk_routes=dict.fromkeys(topk_kernel.ROUTES, 0),
               flash_routes=dict.fromkeys(flash_kernel.ROUTES, 0))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in LAUNCH_RUNS.items():
            for where in ("card", "cpu"):
                on_card = where == "card"
                args = list(argv) + [
                    "--trace-export", f"{tmp}/{name}-{where}.jsonl",
                    "--dump-dir", f"{tmp}/{name}-{where}-dumps"]
                args += (["--device", str(dev), *LAUNCH_CARD_ARGS] if on_card
                         else ["--smoke", "--device", "cpu"])
                if on_card:  # this path's launches: the card runs' own
                    for mod in modules.values():
                        mod.launches = 0
                    topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
                    flash_kernel.launches_by_route = dict.fromkeys(flash_kernel.ROUTES, 0)
                run = run_launcher(args, on_card)
                # dumps by reason, but for burns of the 10 ms latency SLO,
                # which judge the device's own speed: counted apart
                dumps = [(d.manifest["reason"], (d.manifest.get("trigger") or {}).get("slo"))
                         for d in list_dumps(f"{tmp}/{name}-{where}-dumps")]
                run["printed"]["dumps"] = sorted(r for r, slo in dumps if slo != LATENCY_SLO)
                run["printed"]["latency_burns"] = sum(slo == LATENCY_SLO for _, slo in dumps)
                runs[(name, where)] = run
                for line in run["text"].splitlines():
                    log(f"launch ({name}, {where}) | {line}")
                if not on_card:
                    continue
                # the kernels: each call on the route its route function
                # gives; one flash and one scan call a layer a prefill
                launches = {k: mod.launches for k, mod in modules.items()}
                for key in ("topk", "flash"):
                    for call in run["rec"][key]:
                        n = 1 if key == "flash" or call["want"] == "cluster" else 2
                        if call["launched"] != {call["want"]: n}:
                            raise AssertionError(f"launch ({name}): {key} call {call['shape']} "
                                                 f"launched {call['launched']}, expected "
                                                 f"{n} on {call['want']}")
                if any(call["launched"] != {"all": len(ssd_kernel.PHASES)}
                       for call in run["rec"]["ssd"]):
                    raise AssertionError(f"launch ({name}): an ssd_scan call did not launch "
                                         f"its three phases")
                cfg = serve.pool_config(argv[argv.index("--arch") + 1],
                                        "--smoke" in LAUNCH_CARD_ARGS)
                n_req = sum(len(b[2]) for b in run["rec"]["batches"])
                want = {"flash_attention": n_req * cfg.n_layers,
                        "ssd_scan": n_req * cfg.n_layers * len(ssd_kernel.PHASES)
                        if cfg.has_ssm else 0,
                        "topk_sim": sum(sum(c["launched"].values()) for c in run["rec"]["topk"])}
                if launches != want or not launches["topk_sim"] or len(run["prefill_ms"]) != n_req:
                    raise AssertionError(f"launch ({name}): launches {launches}, expected {want} "
                                         f"({len(run['prefill_ms'])} prefills)")
                for k in modules:
                    out["launches"][k] += launches[k]
                for r, n in topk_kernel.launches_by_route.items():
                    out["topk_routes"][r] += n
                for r, n in flash_kernel.launches_by_route.items():
                    out["flash_routes"][r] += n
                run["launches"] = launches
                run["topk_routes"] = dict(topk_kernel.launches_by_route)
                if name == "a":
                    out["profile"] = launch_probe_checks(dev, run, ever_launched)
                    out["obs_cost"] = launch_obs_cost(dev, card, run)
            card_run, cpu_run = runs[(name, "card")], runs[(name, "cpu")]
            n_req = sum(len(b[2]) for b in card_run["rec"]["batches"])
            trained = trains_adapter(argv)
            n_rule, table_diff = launch_parity(name, card_run, cpu_run, n_req)
            p = card_run["printed"]
            summary = dict(
                argv=card_run["argv"], seconds=card_run["seconds"], cpu_seconds=cpu_run["seconds"],
                printed=dict(p), near_tie_rows=n_rule, trained_table=trained,
                table_max_abs_diff=table_diff, cpu_r5=cpu_run["printed"]["r5"],
                launches=card_run["launches"], topk_routes=card_run["topk_routes"],
                topk_calls=[c["shape"] for c in card_run["rec"]["topk"]],
                prefill_ms=card_run["prefill_ms"],
                prefill_ms_p50=float(np.percentile(card_run["prefill_ms"], 50)),
                decode_ms_p50=float(np.percentile(card_run["decode_ms"], 50)),
                decode_ms_p99=float(np.percentile(card_run["decode_ms"], 99)),
                decode_steps=len(card_run["decode_ms"]))
            out["runs"][name] = summary
            log(f"launch ({name}) on the card: {card_run['seconds']:.1f} s in process "
                f"({cpu_run['seconds']:.1f} s on the CPU at --smoke); {n_req} requests, router R@5 {p['r5']:.3f}, selection "
                f"p50/p99 {p['selection_ms']} ms a query (a batch's time over its size; "
                f"{len(card_run['rec']['batches'])} batches); prefill ms p50 {summary['prefill_ms_p50']:.2f} "
                f"(each: {[round(x, 2) for x in card_run['prefill_ms']]}), decode ms a token p50 "
                f"{summary['decode_ms_p50']:.2f} p99 {summary['decode_ms_p99']:.2f} over "
                f"{summary['decode_steps']} steps; launches " + json.dumps(card_run["launches"])
                + ", topk_sim by route " + json.dumps(card_run["topk_routes"])
                + f"; results, plan, decisions, traces ({p.get('traces')}) and dumps "
                f"({p['dumps']}) equal to the CPU run's (rows reordered inside near-ties: "
                f"{n_rule}; the CPU run's latency SLO burns "
                f"{cpu_run['printed']['latency_burns']}, health {cpu_run['printed']['health']}"
                + (f"; S3's adapter trained from one seed on each device, tables "
                   f"{table_diff:.3g} apart (atol {TRAINED_TABLE_ATOL}), R@5 on the CPU run "
                   f"{cpu_run['printed']['r5']:.3f}" if trained else "")
                + f"); health {p['health']} on {card}")
        out["fresh"] = launch_fresh(dev, card, tmp)
    if sum(lib.builds for lib in LIBRARIES.values()) != builds:
        raise AssertionError("nvcc ran inside the launch phase")
    out["library_load_s"] = {n: lib.info.get("seconds") for n, lib in LIBRARIES.items()}
    out["first_launch_ms"] = dict(first_launch_ms)
    log("launch: kernel libraries loaded (build included) in s "
        + json.dumps(out["library_load_s"])
        + "; topk_sim routes' first launch ms (phase 2, between syncs, the lazy load of "
        "their kernels in it) "
        + json.dumps({r: round(v, 3) for r, v in out["first_launch_ms"].items()})
        + f"; no nvcc run in this phase on {card}")
    return out


def launch_fresh(dev, card, tmp):
    """Run (c): the launcher with LAUNCH_FRESH in a process of its own on the
    card and one on the CPU, started together. On the card the first
    launch of each route comes in the launcher's warm-up, before its
    profiler's baseline: health ok and no dump, over a serving pass long
    enough for the ring to judge the probe after the first batch. The two
    print the same R@5, outcome count, index stats, route cache line, plan
    and trace count, and write the same dumps; the re-ranker trains on both
    from the same draws (a CPU generator), so each stage's decision is the
    same and its held-out NDCG@5 within DECISION_ATOL."""
    import os

    from repro_torch.launch import serve
    from repro_torch.obs import list_dumps

    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    procs, runs = {}, {}
    t0 = time.perf_counter()
    try:
        for where in ("card", "cpu"):
            argv = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_FRESH,
                    "--device", str(dev) if where == "card" else "cpu",
                    "--trace-export", f"{tmp}/c-{where}.jsonl",
                    "--dump-dir", f"{tmp}/c-{where}-dumps"]
            procs[where] = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True, env=env)
        for where, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=LAUNCH_FRESH_TIMEOUT_S)
            for line in stdout.splitlines():
                log(f"launch (c, {where}) | {line}")
            if proc.returncode != 0:
                raise AssertionError(f"launch (c, {where}) exited {proc.returncode}: "
                                     f"{stderr[-3000:]}")
            got = serve.printed_results(stdout)
            got["dumps"] = sorted(d.manifest["reason"]
                                  for d in list_dumps(f"{tmp}/c-{where}-dumps"))
            runs[where] = dict(printed=got, seconds=time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    a, b = runs["card"]["printed"], runs["cpu"]["printed"]
    if a["health"] != "ok" or a["dumps"]:
        raise AssertionError(f"launch (c): in a fresh process the card run reads health "
                             f"{a['health']} with dumps {a['dumps']}")
    if a["serve_s"] < LAUNCH_FRESH_MIN_SERVE_S:
        raise AssertionError(f"launch (c): served in {a['serve_s']} s, too short for the ring "
                             f"to judge the probe after the first batch")
    for key in ("r5", "outcomes", "index", "cache", "plan", "traces", "dumps"):
        if a.get(key) != b.get(key):
            raise AssertionError(f"launch (c): {key} {a.get(key)!r} on the card, "
                                 f"{b.get(key)!r} on the CPU")
    trained = {w: [d for d in r["printed"]["decisions"] if d.split()[0] == "rerank"]
               for w, r in runs.items()}
    if any(len(d) != 1 or "suppressed" in d[0] for d in trained.values()):
        raise AssertionError(f"launch (c): the re-ranker did not train: {trained}")
    # one seed draws the same re-ranker on both devices: the same decisions,
    # held-out NDCG@5 equal but for float32 sums (the lines print 3 places)
    if not same_decisions(a["decisions"], b["decisions"], DECISION_ATOL):
        raise AssertionError(f"launch (c): decisions {a['decisions']} on the card, "
                             f"{b['decisions']} on the CPU")
    log(f"launch (c) in fresh processes: {runs['card']['seconds']:.1f} s; card serving "
        f"{a['serve_s']} s, health {a['health']}, no dump; router R@5 {a['r5']:.3f}, "
        f"selection p50/p99 {a['selection_ms']} ms a query over 30 batches; "
        + a["cache"] + f"; {a['plan']}; decisions card {a['decisions']} CPU {b['decisions']} "
        f"(equal, NDCG@5 within {DECISION_ATOL}); results, cache, plan, traces "
        f"({a.get('traces')}) and dumps equal to the CPU run's on {card}")
    return dict(argv=list(LAUNCH_FRESH), seconds=runs["card"]["seconds"], printed=a,
                cpu_decisions=b["decisions"])


def launch_probe_checks(dev, run, ever_launched):
    """After run (a): the topk_sim probe counts the library plus every route
    launched in this process, and a JitProfiler baselined now counts no
    load and no first launch over a second identical serving pass."""
    import torch

    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs import JitProfiler, MetricsRegistry
    from repro_torch.router.gateway import SemanticRouter

    launched = set(ever_launched) | {r for r, n in run["topk_routes"].items() if n}
    size = topk_kernel.PROBE._cache_size()
    if topk_kernel.LIBRARY.loads != 1 or size != 1 + len(launched):
        raise AssertionError(f"launch: the topk_sim probe counts {size}, not 1 + the routes "
                             f"launched {sorted(launched)}")
    prof = JitProfiler(registry=MetricsRegistry())
    prof.collect()
    router_a = run["rec"]["batches"][0][0]
    again = SemanticRouter(router_a.db, embed_fn=router_a.embed_fn,
                           embed_batch_fn=router_a.embed_batch_fn, k=router_a.k,
                           backend="fused", metrics=False, device=dev)
    before = topk_kernel.launches
    for _, queries, _ in run["rec"]["batches"]:
        again.route_batch(queries)
    torch.cuda.synchronize()
    again.close()
    prof.collect()
    snap = prof.snapshot()["jits"]["topk_sim"]
    if snap["compiles_total"] != 0 or topk_kernel.launches == before:
        raise AssertionError(f"launch: a second serving pass counted {snap} "
                             f"({topk_kernel.launches - before} launches)")
    log(f"launch: topk_sim probe _cache_size() {size} = the library + routes "
        f"{sorted(launched)}; a JitProfiler baselined after run (a) counts "
        f"{snap['compiles_total']} loads or first launches over a second identical serving "
        f"pass ({topk_kernel.launches - before} launches)")
    return dict(cache_size=size, routes=sorted(launched), second_pass_compiles=0,
                second_pass_launches=topk_kernel.launches - before)


def launch_obs_cost(dev, card, run):
    """route_batch at batch 16 over run (a)'s 100,000-tool table: a router
    with the full obs plane (registry, tracer, bus, quality monitor
    watching the table, a ring ticking every second with profiler.collect
    and slo_engine.evaluate, as the launcher wires them) against a bare one
    (metrics off) and against routers with one part of the plane each (the
    registry; the registry and the tracer; the registry, the bus and the
    quality monitor), LAUNCH_OBS_ROUNDS rounds in turns of
    LAUNCH_OBS_BATCHES batches, the order rotated a round; host clock a
    batch (results on the host)."""
    import numpy as np

    from repro_torch.data.benchmarks import make_metatool_like
    from repro_torch.obs import (EventBus, JitProfiler, MetricsRegistry, QualityConfig,
                                 QualityMonitor, RouteTracer, SLOEngine, TimeSeriesRing)
    from repro_torch.router.gateway import SemanticRouter

    router_a = run["rec"]["batches"][0][0]
    db = router_a.db
    bench = make_metatool_like(seed=0, n_tools=199, n_queries=800)  # the launcher's
    bs = 16
    n_q = bench.n_queries
    blocks = [[bench.query_tokens[(s + j) % n_q] for j in range(bs)]
              for s in range(0, bs * LAUNCH_OBS_BATCHES, bs)]
    reg, bus = MetricsRegistry(), EventBus()
    quality = QualityMonitor(QualityConfig(drift_every=4), registry=reg, bus=bus)
    detach = [bus.watch_db(db), quality.watch_db(db)]
    kw = dict(embed_fn=router_a.embed_fn, embed_batch_fn=router_a.embed_batch_fn, k=5,
              backend="fused", device=dev)
    # the whole plane, bare, and the plane's parts one at a time (each with
    # a registry of its own), to tell which instrument costs
    part_reg = {name: MetricsRegistry() for name in ("quality", "metrics", "tracer")}
    part_bus = EventBus()
    part_quality = QualityMonitor(QualityConfig(drift_every=4), registry=part_reg["quality"],
                                  bus=part_bus)
    detach += [part_bus.watch_db(db), part_quality.watch_db(db)]
    routers = {
        "obs": SemanticRouter(db, metrics=reg, tracer=RouteTracer(sample_every=8, seed=0),
                              bus=bus, quality=quality, **kw),
        "bare": SemanticRouter(db, metrics=False, **kw),
        "metrics": SemanticRouter(db, metrics=part_reg["metrics"], **kw),
        "metrics+tracer": SemanticRouter(db, metrics=part_reg["tracer"],
                                         tracer=RouteTracer(sample_every=8, seed=0), **kw),
        "metrics+bus+quality": SemanticRouter(db, metrics=part_reg["quality"], bus=part_bus,
                                              quality=part_quality, **kw)}
    ring = TimeSeriesRing(reg, bus=bus)
    slo = SLOEngine(ring, bus=bus, registry=reg)
    prof = JitProfiler(registry=reg)
    prof.collect()
    ring.start(interval_s=1.0, on_tick=lambda r: (prof.collect(), slo.evaluate()))
    ms = {name: [] for name in routers}
    try:
        with no_gc():
            for r in range(LAUNCH_OBS_ROUNDS):
                order = list(routers)[r % len(routers):] + list(routers)[:r % len(routers)]
                for name in (order if r % 2 == 0 else order[::-1]):
                    routers[name].route_batch(blocks[0])  # warm-up, not timed
                    for b in blocks:
                        t = time.perf_counter()
                        routers[name].route_batch(b)
                        ms[name].append((time.perf_counter() - t) * 1e3)
    finally:
        ring.stop()
    if ring.last_loop_error is not None:
        raise AssertionError(f"launch obs cost: the ring failed: {ring.last_loop_error}")
    # one tick's own cost, on this thread: the snapshot, the profiler's
    # poll and the SLO evaluation the ring daemon runs every second
    tick_ms = []
    for _ in range(20):
        t = time.perf_counter()
        ring.tick()
        prof.collect()
        slo.evaluate()
        tick_ms.append((time.perf_counter() - t) * 1e3)
    for fn in detach:
        fn()
    for router in routers.values():
        router.close()
    per_round = {name: [dict(p50=float(np.percentile(v[i:i + LAUNCH_OBS_BATCHES], 50)),
                             p99=float(np.percentile(v[i:i + LAUNCH_OBS_BATCHES], 99)))
                        for i in range(0, len(v), LAUNCH_OBS_BATCHES)] for name, v in ms.items()}
    res = {name: dict(p50_ms=float(np.percentile(v, 50)), p99_ms=float(np.percentile(v, 99)),
                      rounds=per_round[name]) for name, v in ms.items()}
    res.update(ring_ticks=len(ring) - len(tick_ms), tick_ms_p50=float(np.percentile(tick_ms, 50)),
               overhead_pct=100 * (res["obs"]["p50_ms"] / res["bare"]["p50_ms"] - 1))
    log(f"launch obs cost: route_batch at batch {bs} over {db.embeddings.shape[0]} tools, "
        f"{LAUNCH_OBS_ROUNDS} rounds in turns of {LAUNCH_OBS_BATCHES}: full obs plane p50 "
        f"{res['obs']['p50_ms']:.4f} p99 {res['obs']['p99_ms']:.4f} ms, bare p50 "
        f"{res['bare']['p50_ms']:.4f} p99 {res['bare']['p99_ms']:.4f} ms (p50 "
        f"{res['overhead_pct']:+.1f} %; limit +10 %, not gated); by round (p50) obs "
        f"{[round(x['p50'], 4) for x in per_round['obs']]} bare "
        f"{[round(x['p50'], 4) for x in per_round['bare']]}; the parts alone p50 / p99 "
        + json.dumps({name: [round(res[name]["p50_ms"], 4), round(res[name]["p99_ms"], 4)]
                      for name in routers if name not in ("obs", "bare")})
        + f"; {res['ring_ticks']} ring ticks "
        f"during the turns, one tick (snapshot, profiler.collect, slo_engine.evaluate) "
        f"{res['tick_ms_p50']:.4f} ms p50 on {card}")
    return res


def bf16_logits_close(got, ref):
    """(max |d|, within tolerance): tests/test_torch_bf16.py's bf16 logit
    tolerance, BF16_LOGIT_ATOL plus two bf16 ulps of the row's largest |logit|
    (a rounding upstream of the head moves every logit of a row)."""
    import torch

    a, b = ref.float(), got.float()
    row_ulp = torch.exp2(torch.floor(torch.log2(a.abs().amax(-1, keepdim=True))) - 7)
    d = (a - b).abs()
    return float(d.max()), bool((d <= BF16_LOGIT_ATOL + 2 * row_ulp).all())


@contextlib.contextmanager
def recorded_model_calls(flash_calls, moe_inputs):
    """Inside the block every flash_attention call of the model's layers
    appends ((q, k, v), kwargs) to `flash_calls` and every moe_block call
    (p, x) to `moe_inputs` (references, no copies: neither is written
    after the call)."""
    from repro_torch.models import layers

    flash, moe = layers.flash_attention, layers.moe_block

    def flash_wrapper(q, k, v, **kw):
        # the kernel's arguments: the op's use_kernel is not one
        flash_calls.append(((q, k, v), {n: x for n, x in kw.items() if n != "use_kernel"}))
        return flash(q, k, v, **kw)

    def moe_wrapper(p, x, cfg):
        moe_inputs.append((p, x, cfg))
        return moe(p, x, cfg)

    layers.flash_attention, layers.moe_block = flash_wrapper, moe_wrapper
    try:
        yield
    finally:
        layers.flash_attention, layers.moe_block = flash, moe


def moe_drop_share(moe_inputs):
    """(assignments dropped for capacity, assignments) over the recorded
    moe_block calls, recomputed with the block's own router."""
    from repro_torch.models import layers

    kept = total = 0
    for p, x, cfg in moe_inputs:
        keep = layers.moe_route(p, x.reshape(-1, x.shape[-1]), cfg)[4]
        kept += int(keep.sum())
        total += keep.numel()
    moe_inputs.clear()
    return total - kept, total


def families_phase(dev, card, gen, check_flash, make_router, db_native, bench, agree):
    """Phase 12: musicgen-medium, dbrx-132b, llama-3.2-vision-90b and
    arctic-480b at full width in bf16 (depth cut as FAMILIES says): the
    batcher leg (routed admission), a 2,048-token prompt through
    `M.prefill` and greedy `decode_step`s held against a teacher-forced
    `forward`, the flash kernel at captured inputs against its plain
    version, the launcher in process on the card and the CPU, and the
    cross-attention's causal=False kernel timed. Returns the summary;
    raises on any failed check."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.launch import serve
    from repro_torch.models import layers, model as M
    from repro_torch.router.scheduler import ContinuousBatcher, Request

    def reset_counts():
        for mod in (flash_kernel, ssd_kernel, topk_kernel):
            mod.launches = 0
        flash_kernel.launches_by_route = dict.fromkeys(flash_kernel.ROUTES, 0)
        topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)

    def counts():
        return dict(flash=flash_kernel.launches, ssd=ssd_kernel.launches,
                    topk=topk_kernel.launches,
                    flash_routes=dict(flash_kernel.launches_by_route),
                    topk_routes=dict(topk_kernel.launches_by_route))

    # launches of the full-width legs (batcher, direct) and, apart, of the
    # launcher's card runs (two of them at --smoke: float32, the fma route)
    out = dict(families={}, cross_shapes=[], **{path: dict(
        launches=dict(flash=0, topk=0), flash_routes=dict.fromkeys(flash_kernel.ROUTES, 0),
        topk_routes=dict.fromkeys(topk_kernel.ROUTES, 0)) for path in ("pool", "launch")})

    def add(path, c):
        for key in ("flash", "topk"):
            out[path]["launches"][key] += c[key]
        for key in ("flash_routes", "topk_routes"):
            for r, n in c[key].items():
                out[path][key][r] += n

    for arch, (n_layers, batcher_leg, n_decode) in FAMILIES.items():
        t_family = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
        n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0
        n_self = cfg.n_layers - n_cross
        rec = dict(arch=arch, layers=cfg.n_layers, of_layers=full.n_layers, n_self=n_self,
                   n_cross=n_cross, params=cfg.param_count(), dtype=cfg.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init(cfg, gen, device=dev)
        # unit-scale attention logits (as the hymba pool), the VLM's gates open
        params = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(cfg, params), seed=1)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        log(f"families: {arch} {cfg.n_layers} of {full.n_layers} layers"
            + (f" ({n_self} self, {n_cross} cross, {cfg.n_image_tokens} image tokens)"
               if n_cross else "") + f", d_model {cfg.d_model}, {cfg.dtype}, "
            f"{cfg.param_count() / 1e9:.3f} B params (the cut: "
            + ("none" if not n_layers else f"depth {n_layers} of {full.n_layers}, one card's "
               f"80 GB; full {full.param_count() / 1e9:.1f} B") + f"), initialised from a "
            f"seeded generator on the card in {rec['init_s']:.1f} s; wq, wk, wv at a d_model "
            f"fan-in" + ("; gates opened to seeded values" if n_cross else ""))
        img_gen = torch.Generator(device=dev).manual_seed(7)

        def image(b):
            return torch.randn((b, cfg.n_image_tokens, cfg.d_model), generator=img_gen,
                               device=dev).to(getattr(torch, cfg.dtype))

        # ---- (a) the batcher: routed admission, 4 slots, 16 requests
        if batcher_leg:
            pool_router = make_router(db_native, "fused", None)
            dense = make_router(db_native, "dense", None)
            routed = []
            route_batch = pool_router.route_batch

            def counted_route(queries, *args, **kwargs):
                routed.append(len(queries))
                return route_batch(queries, *args, **kwargs)

            pool_router.route_batch = counted_route
            max_len = POOL_PROMPT_LENS[1] + 2 * POOL_NEW_TOKENS
            batcher = ContinuousBatcher(cfg, params, n_slots=POOL_SLOTS, max_len=max_len,
                                        router=pool_router, device=dev)
            flash_calls, moe_inputs = [], []
            prefill_ms, decode_ms, drops = [], [], {"prefill": [], "tick": []}
            tick_flash = []

            def timed(fn, into, kind):
                def wrapper(*args):
                    before = len(flash_calls)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    logits, cache = fn(*args)
                    torch.cuda.synchronize()
                    into.append((time.perf_counter() - t) * 1e3)
                    if kind == "tick":
                        tick_flash.append([kw["causal"] for _, kw in flash_calls[before:]])
                    flash_calls[before:] = []  # nothing kept past the call
                    if not bool(torch.isfinite(logits).all()):
                        raise AssertionError(f"families {arch}: non-finite {kind} logits")
                    if cfg.arch_type == "moe":
                        drops[kind].append(moe_drop_share(moe_inputs))
                    return logits, cache
                return wrapper

            batcher._prefill = timed(batcher._prefill, prefill_ms, "prefill")
            batcher._decode = timed(batcher._decode, decode_ms, "tick")
            rng = np.random.default_rng(0)
            lens = rng.integers(POOL_PROMPT_LENS[0], POOL_PROMPT_LENS[1] + 1, FAMILY_REQUESTS)
            extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
            requests = [Request(request_id=i,
                                prompt=rng.integers(0, cfg.vocab_size, (int(n),) + extra),
                                max_new_tokens=POOL_NEW_TOKENS,
                                query_tokens=bench.query_tokens[i % bench.n_queries])
                        for i, n in enumerate(lens)]
            for req in requests:
                batcher.submit(req)
            torch.cuda.synchronize()
            reset_counts()  # the batcher leg starts: count only its launches
            t_pool = time.perf_counter()
            with recorded_model_calls(flash_calls, moe_inputs):
                batcher.run_until_drained()
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t_pool
            c = counts()
            done = sorted(batcher.completed, key=lambda r: r.request_id)
            if [r.request_id for r in done] != list(range(FAMILY_REQUESTS)):
                raise AssertionError(f"families {arch}: {len(done)} requests completed")
            for r in done:
                ok = len(r.generated) == POOL_NEW_TOKENS and all(
                    (len(t) == cfg.n_codebooks and all(0 <= x < cfg.vocab_size for x in t))
                    if cfg.n_codebooks else 0 <= t < cfg.vocab_size for t in r.generated)
                if not ok:
                    raise AssertionError(f"families {arch}: request {r.request_id} "
                                         f"generated {r.generated}")
            ticks = len(decode_ms)
            want = dict(flash=FAMILY_REQUESTS * (n_self + n_cross) + ticks * n_cross,
                        ssd=0, topk=len(routed))
            want_flash = {"wgmma": want["flash"], "fma": 0}
            want_topk = dict.fromkeys(topk_kernel.ROUTES, 0) | {"cluster": len(routed)}
            if ({k: c[k] for k in want} != want or c["flash_routes"] != want_flash
                    or c["topk_routes"] != want_topk or len(prefill_ms) != FAMILY_REQUESTS
                    or any(t != [False] * n_cross for t in tick_flash)):
                raise AssertionError(f"families {arch}: batcher launches {c}, expected {want}, "
                                     f"{want_flash}, {want_topk} ({len(prefill_ms)} prefills, "
                                     f"{ticks} ticks, {len(routed)} routed batches)")
            add("pool", c)
            n_rule = agree([r.route_result for r in done],
                           dense.route_batch([r.query_tokens for r in done]),
                           f"families {arch} routing")
            pool_router.close()
            dense.close()
            generated = sum(len(r.generated) for r in done)
            share = {k: (sum(d for d, _ in v) / max(sum(n for _, n in v), 1), v)
                     for k, v in drops.items()}
            rec["batcher"] = dict(
                requests=FAMILY_REQUESTS, slots=POOL_SLOTS, new_tokens=POOL_NEW_TOKENS,
                prompt_lens=[int(n) for n in lens], ticks=ticks, seconds=pool_s,
                generated_tokens_per_s=generated / pool_s, prefill_ms=prefill_ms,
                prefill_ms_p50=float(np.percentile(prefill_ms, 50)),
                decode_ms_p50=float(np.percentile(decode_ms, 50)),
                decode_ms_p99=float(np.percentile(decode_ms, 99)),
                prefill_tokens_per_s=float(lens.sum() / (sum(prefill_ms) / 1e3)),
                routed_batches=routed, launches={k: c[k] for k in want},
                flash_routes=c["flash_routes"], topk_routes=c["topk_routes"],
                routing_near_tie_rows=n_rule,
                moe_dropped=({k: dict(share=v[0], per_call=[d / n for d, n in v[1]])
                              for k, v in share.items()} if cfg.arch_type == "moe" else None))
            b = rec["batcher"]
            log(f"families {arch} batcher: {FAMILY_REQUESTS} requests in {ticks} ticks, "
                f"{pool_s:.2f} s, {b['generated_tokens_per_s']:.1f} generated tokens/s; prefill "
                f"ms p50 {b['prefill_ms_p50']:.1f} ({b['prefill_tokens_per_s']:.0f} prompt "
                f"tokens/s), decode ms a tick p50 {b['decode_ms_p50']:.1f} p99 "
                f"{b['decode_ms_p99']:.1f}; launches " + json.dumps(b["launches"])
                + " (flash by route " + json.dumps(c["flash_routes"]) + ", topk_sim by route "
                + json.dumps(c["topk_routes"]) + f"); tools equal to the dense backend's "
                f"(near-tie rows {n_rule})"
                + (f"; MoE assignments dropped for capacity: prefill "
                   f"{share['prefill'][0]:.4f}, decode tick {share['tick'][0]:.4f} (T = "
                   f"{POOL_SLOTS} slots a tick, empty ones too)" if cfg.arch_type == "moe" else "")
                + f" on {card}")
            del batcher, requests, done

        # ---- (b) one 2,048-token prompt: prefill + greedy decode steps,
        # timed, against a teacher-forced forward; the kernel at its inputs
        gen_tok = torch.Generator(device=dev).manual_seed(11)
        shape = (1, CAPTURE_LEN) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
        prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen_tok, device=dev)
        img = image(1) if n_cross else None

        def run_direct(run_cfg, record):
            """prefill + n_decode greedy steps: (logits a step, the tokens
            fed, prefill ms, decode ms, flash calls of prefill and of each
            step, MoE (dropped, assigned) of each, and each step's MoE
            inputs at its last position, a (p, row) a layer)."""
            batch = {"tokens": prompt}
            if n_cross:
                batch["image_embeds"] = img
            flash_calls, moe_inputs = [], []
            steps, fed, ms, calls, drops, moe_rows = [], [], [], [], [], []

            def close_step(record_calls):
                calls.append(list(flash_calls) if record_calls else
                             [kw["causal"] for _, kw in flash_calls])
                flash_calls.clear()
                moe_rows.append([(p_, x_[:, -1].clone()) for p_, x_, _ in moe_inputs])
                drops.append(moe_drop_share(moe_inputs))

            with recorded_model_calls(flash_calls, moe_inputs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = M.prefill(run_cfg, params, batch,
                                          max_cache_len=CAPTURE_LEN + n_decode + 1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                steps.append(logits[:, -1])
                close_step(record)
                for step in range(n_decode):
                    tok = torch.argmax(steps[-1], dim=-1)[:, None]  # [1, 1(, K)]
                    fed.append(tok)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    logits, cache = M.decode_step(run_cfg, params, cache,
                                                  {"token": tok, "pos": CAPTURE_LEN + step})
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                    steps.append(logits[:, -1])
                    close_step(record and step == 0)
            del cache
            for s_ in steps:
                if not bool(torch.isfinite(s_).all()):
                    raise AssertionError(f"families {arch}: non-finite logits")
            return steps, fed, ms, calls, drops, moe_rows

        def experts(p_, rows, run_cfg):
            """The experts each row's router picks, as sorted lists."""
            top_e = layers.moe_route(p_, rows, run_cfg)[3]
            return [sorted(r) for r in top_e.tolist()]

        def teacher_forced(run_cfg, steps, fed, moe_rows):
            """Each step's logits against a forward over the prompt and the
            fed tokens: (max |d| a step, steps within tolerance, steps whose
            position some MoE layer routes to other experts in the forward
            than in the step: a bf16 near-tie of the router, counted and
            not held)."""
            batch = {"tokens": torch.cat([prompt] + fed, dim=1)}
            if n_cross:
                batch["image_embeds"] = img
            moe_inputs = []
            with recorded_model_calls([], moe_inputs):
                logits, _ = M.forward(run_cfg, params, batch)
            errs, flips, bad = [], [], []
            for j, s_ in enumerate(steps):
                pos = CAPTURE_LEN - 1 + j
                err, ok = bf16_logits_close(s_, logits[:, pos])
                errs.append(err)
                flip = any(experts(p_, row, run_cfg) != experts(p_, x_[:, pos], run_cfg)
                           for (p_, row), (_, x_, _) in zip(moe_rows[j], moe_inputs))
                if flip:
                    flips.append(j)
                elif not ok:
                    bad.append(j)
            del logits, moe_inputs
            return errs, bad, flips

        reset_counts()  # the direct leg: count its launches
        steps, fed, ms, calls, drops, moe_rows = run_direct(cfg, record=True)
        c = counts()
        want_calls = [[True] * (cfg.cross_attn_every - 1) + [False]] * n_cross if n_cross else [
            [True] * n_self]
        prefill_flags = [kw["causal"] for _, kw in calls[0]]
        if (prefill_flags != [f for g in want_calls for f in g]
                or [[kw["causal"] for _, kw in calls[1]]] + calls[2:] != [[False] * n_cross] * n_decode
                or c["flash"] != n_self + n_cross * (1 + n_decode) or c["ssd"] or c["topk"]
                or c["flash_routes"] != {"wgmma": c["flash"], "fma": 0}):
            raise AssertionError(f"families {arch}: direct leg launches {c}, prefill flags "
                                 f"{prefill_flags}")
        add("pool", c)
        errs, bad, flips = teacher_forced(cfg, steps, fed, moe_rows)
        rec["direct"] = dict(prompt=CAPTURE_LEN, decode_steps=n_decode, prefill_ms=ms[0],
                             decode_ms=ms[1:], decode_ms_p50=float(np.median(ms[1:])),
                             tokens_per_s=1e3 / float(np.median(ms[1:])),
                             launches=c["flash"], teacher_forced_max_abs=errs)
        if cfg.arch_type == "moe":
            # capacity depends on T, so a forward over 2,048 + n tokens drops
            # other assignments than the prefill over 2,048 and the decode
            # steps over 1: printed here (with the steps outside tolerance),
            # held below with the capacity at T, where nothing drops
            rec["direct"].update(moe_dropped=[d / n for d, n in drops],
                                 outside_tolerance_at_config_capacity=bad + flips)
            nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                         / cfg.experts_per_token)
            nd_steps, nd_fed, _, _, nd_drops, nd_rows = run_direct(nodrop, record=False)
            if any(d for d, _ in nd_drops):
                raise AssertionError(f"families {arch}: drops at capacity T")
            nd_errs, bad, flips = teacher_forced(nodrop, nd_steps, nd_fed, nd_rows)
            rec["direct"].update(teacher_forced_no_drop_max_abs=nd_errs,
                                 router_near_tie_steps=flips)
            del nd_steps, nd_fed, nd_rows
        if bad or len(flips) > len(steps) // 2:
            raise AssertionError(
                f"families {arch}: prefill + decode against the teacher-forced forward "
                f"max|d| a step {rec['direct'].get('teacher_forced_no_drop_max_abs', errs)}, "
                f"outside tolerance at steps {bad}, router near-ties at {flips}")
        d = rec["direct"]
        log(f"families {arch} direct: {CAPTURE_LEN}-token prefill {d['prefill_ms']:.1f} ms, "
            f"{n_decode} decode steps p50 {d['decode_ms_p50']:.1f} ms "
            f"({d['tokens_per_s']:.1f} tokens/s at batch 1); flash launches "
            f"{c['flash']} ({n_self} causal + {n_cross} causal=False in the prefill, "
            f"{n_cross} causal=False a step; all wgmma); logits within 3e-2 + 2 bf16 ulps of "
            f"the row max of a teacher-forced forward, max|d| a step "
            + json.dumps([round(e, 4) for e in d.get("teacher_forced_no_drop_max_abs", errs)])
            + (f" with nothing dropped (capacity T; steps whose router picks other experts "
               f"in the forward, counted, not held: {flips}); at the config's capacity max|d| "
               + json.dumps([round(e, 4) for e in errs]) + ", assignments dropped "
               + json.dumps([round(x, 4) for x in d["moe_dropped"]])
               + " (prefill, then each step; printed, not held)" if cfg.arch_type == "moe"
               else "") + f" on {card}")

        # the kernel against its plain version at the captured inputs
        self_call = next(call for call in calls[0] if call[1]["causal"])
        check_flash(f"{arch} self-attention layer 0 prefill", *self_call[0], **self_call[1])
        if n_cross:
            cross_prefill = next(call for call in calls[0] if not call[1]["causal"])
            cross_decode = calls[1][0]
            for what, ((q, k, v), kw) in (("prefill", cross_prefill), ("decode", cross_decode)):
                check_flash(f"{arch} cross-attention {what}", q, k, v, **kw)
                # the check has teeth here: the kernel over the whole tiles
                # alone (the 64-key tail tile dropped) must fail it against
                # the plain version over all the keys
                whole = k.shape[1] // 128 * 128
                e = flash_error(flash_kernel.flash_attention_cuda(
                    q, k[:, :whole].contiguous(), v[:, :whole].contiguous(), **kw),
                    attention_ref(q, k, v, **kw))
                if flash_within(e, "bfloat16"):
                    raise AssertionError(f"families {arch}: the cross-attention {what} check "
                                         f"passes a kernel over {whole} of {k.shape[1]} keys: {e}")
                log(f"families {arch} cross-attention {what}: the kernel over the first {whole} "
                    f"of {k.shape[1]} keys fails the check, as it must: max|d| "
                    f"{e['max_abs_err']:.3g} (limit {e['atol']:.3g}), ||d||/||plain|| "
                    f"{e['rel_norm']:.3g} (limit {FLASH_BF16_RTOL})")
                g = q.shape[0] // k.shape[0]
                q4 = q.view(1, *q.shape)
                k4, v4 = (t.repeat_interleave(g, dim=0).view(1, q.shape[0], *t.shape[1:])
                          for t in (k, v))
                b_ms, b_by = flash_bound(q, k, v, False, 0, 0)
                row = dict(what=what, q=list(q.shape), kv=list(k.shape), dtype=str(q.dtype),
                           route=flash_kernel.flash_route(q.dtype, q.shape[2], q, k, v),
                           ms=cuda_ms(lambda: flash_kernel.flash_attention_cuda(q, k, v, **kw),
                                      iters=50),
                           plain_ms=cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=10),
                           library_ms=cuda_ms(
                               lambda: torch.nn.functional.scaled_dot_product_attention(
                                   q4, k4, v4), iters=50),
                           bound_ms=b_ms, bound_by=b_by)
                out["cross_shapes"].append(row)
                log(f"time flash_attention cross-attention {what} q{row['q']} kv{row['kv']} "
                    f"causal=False ({row['route']}): kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f}, SDPA (kv repeated, no mask) "
                    f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}) on {card}")
        del steps, fed, calls, moe_rows, prompt, img

        # ---- (c) the launcher in process, on the card and on the CPU
        if batcher_leg:
            runs = {}
            for where in ("card", "cpu"):
                argv = ["--arch", arch] + FAMILY_LAUNCH + (
                    ["--device", str(dev), *FAMILY_LAUNCH_CARD[arch]] if where == "card"
                    else ["--smoke", "--device", "cpu"])
                reset_counts()
                run = run_launcher(argv, where == "card")
                run["printed"].update(dumps=[], latency_burns=0)
                run["counts"] = counts()  # the card run's are this path's launches
                runs[where] = run
                for line in run["text"].splitlines():
                    log(f"launch ({arch}, {where}) | {line}")
            card_run = runs["card"]
            c = card_run["counts"]
            lcfg = serve.pool_config(arch, "--smoke" in FAMILY_LAUNCH_CARD[arch])
            l_cross = lcfg.n_layers // lcfg.cross_attn_every if lcfg.cross_attn_every else 0
            n_req = sum(len(b_[2]) for b_ in card_run["rec"]["batches"])
            n_new = int(FAMILY_LAUNCH[FAMILY_LAUNCH.index("--max-new-tokens") + 1])
            want = n_req * lcfg.n_layers + n_req * (n_new - 1) * l_cross
            for call in card_run["rec"]["flash"]:
                if call["launched"] != {call["want"]: 1}:
                    raise AssertionError(f"launch ({arch}): flash call {call['shape']} "
                                         f"launched {call['launched']} (want {call['want']})")
            if (c["flash"] != want or c["ssd"] or not c["topk"]
                    or c["topk"] != sum(sum(x["launched"].values())
                                        for x in card_run["rec"]["topk"])
                    or len(card_run["prefill_ms"]) != n_req):
                raise AssertionError(f"launch ({arch}): launches {c}, expected {want} flash")
            add("launch", c)
            n_rule, _ = launch_parity(arch, card_run, runs["cpu"], n_req)
            p = card_run["printed"]
            rec["launch"] = dict(argv=card_run["argv"], seconds=card_run["seconds"],
                                 cpu_seconds=runs["cpu"]["seconds"], r5=p["r5"],
                                 near_tie_rows=n_rule, launches=c["flash"],
                                 flash_routes=c["flash_routes"], topk_routes=c["topk_routes"],
                                 prefill_ms_p50=float(np.median(card_run["prefill_ms"])),
                                 decode_ms_p50=float(np.median(card_run["decode_ms"])))
            log(f"launch ({arch}) on the card ({lcfg.name}): {card_run['seconds']:.1f} s in "
                f"process ({runs['cpu']['seconds']:.1f} s on the CPU at --smoke); {n_req} "
                f"requests, R@5 {p['r5']:.3f}, prefill ms p50 {rec['launch']['prefill_ms_p50']:.2f}, "
                f"decode ms a token p50 {rec['launch']['decode_ms_p50']:.2f}; flash launches "
                f"{c['flash']} by route " + json.dumps(c["flash_routes"]) + ", topk_sim by route "
                + json.dumps(c["topk_routes"]) + f"; printed results equal to the CPU run's "
                f"(near-tie rows {n_rule}) on {card}")
            del runs, card_run
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_family
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        out["families"][arch] = rec
        log(f"families {arch}: {rec['seconds']:.1f} s, peak device memory "
            f"{rec['peak_memory_gb']:.1f} GB; params and caches freed")
    return out


def train_resume_config():
    """The save / restore leg's model: reduced hymba-1.5b (2 layers, d_model
    256) in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    return reduced(get_config("hymba-1.5b"), dtype="bfloat16")


def train_phase(dev, card):
    """Phase 13: the training path on the card. The kernel ops' repair (a
    reduced model's forward with grad-requiring params raises), the reduced
    models' `loss_fn` gradients against the CPU's (`scenarios.GRAD_CASES`),
    `launch.train.main` at full width: TRAIN_REFERENCE_STEPS from the
    reference's init (recorded, not held), then each TRAIN_OPTIMIZERS entry
    from the init at a d_model fan-in (step ms between card syncs, tokens/s,
    peak memory, model-FLOPs share, the idle share of TRAIN_PROFILE_STEPS
    profiled steps; the loss must fall), and a save and a restore into a
    fresh Trainer whose next steps follow the uninterrupted run. No kernel may launch: training takes the
    plain attention and scan. Returns the summary; raises on any failed
    check."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import scenarios
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, synthetic_lm_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.optim.base import tree_map
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.train_step import TrainConfig

    out = {"card": card, "leg_seconds": {}}
    t_leg = time.perf_counter()

    def leg_done(name):
        nonlocal t_leg
        out["leg_seconds"][name] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

    # ---- (a) the repair: the kernels have no backward, and on the card
    # forward picks them; a grad-requiring param must raise, not lose its grad
    small = reduced(get_config("hymba-1.5b"), sliding_window=16)
    params = tree_map(lambda t: t.to(dev).requires_grad_(),
                      M.init(small, torch.Generator().manual_seed(0), "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, small.vocab_size, (2, 40))).to(dev)
    try:
        M.forward(small, params, {"tokens": tokens})
    except ValueError as err:
        if "no backward" not in str(err):
            raise
        out["repair_error"] = str(err)
    else:
        raise AssertionError("train: forward with grad-requiring params did not raise")
    del params
    log(f"train: forward on {dev} with grad-requiring params raises: {out['repair_error']}")
    leg_done("repair")

    # ---- (b) the reduced models' gradients, card against CPU, leaf by leaf
    out["grad_gaps"] = {}
    for arch, (overrides, tol) in scenarios.GRAD_CASES.items():
        gaps = scenarios.grad_gaps(arch, dev, overrides)
        worst = max(gaps, key=gaps.get)
        out["grad_gaps"][arch] = dict(max=gaps[worst], leaf=worst, tol=tol, leaves=len(gaps))
        if not gaps[worst] <= tol:
            raise AssertionError(f"train: {arch} grad {worst} is {gaps[worst]:.3g} of the "
                                 f"CPU's norm away (tolerance {tol})")
    log("train: loss_fn grads of the reduced models on the card against the CPU, max "
        "||g_card - g_cpu|| / ||g_cpu|| over leaves " + json.dumps(
            {a: f"{g['max']:.3g} ({g['leaf']}, tol {g['tol']})"
             for a, g in out["grad_gaps"].items()}))
    leg_done("grads")

    # ---- (c) the launcher at full width, each optimizer
    class TimedTrainer(trainer_mod.Trainer):
        """The launcher's Trainer, its step timed between card syncs; from
        the init at a d_model fan-in unless `rescale` is False."""
        last, rescale = None, True

        def __init__(self, cfg, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(cfg, *args, **kwargs)
            if TimedTrainer.rescale:
                with torch.no_grad():
                    params = M.attention_at_d_model_fan_in(cfg, self.params)
                self.params = tree_map(lambda p: p.detach().requires_grad_(), params)
            self.init_s = time.perf_counter() - t0
            step_fn, self.step_ms = self.step_fn, []

            def timed(*step_args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = step_fn(*step_args)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t) * 1e3)
                return res

            self.step_fn = timed
            TimedTrainer.last = self

    # every run draws one init (one seed, one config): drawn once on the host
    # (~15 s for 1.59 B params) and copied to the card by each Trainer
    drawn, draw = {}, M.init

    def draw_once(cfg, generator, device):
        key = (cfg, generator.initial_seed(), str(device))
        if key not in drawn:
            drawn[key] = draw(cfg, generator, device)
        return drawn[key]

    def run_launcher(args):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_train.Trainer, M.init = TimedTrainer, draw_once
        try:
            t0 = time.perf_counter()
            history = launch_train.main(args)
            wall_s = time.perf_counter() - t0
        finally:
            launch_train.Trainer, M.init = trainer_mod.Trainer, draw
        tr, TimedTrainer.last = TimedTrainer.last, None
        return history, wall_s, tr, torch.cuda.max_memory_allocated() / 1e9

    argv = list(TRAIN_ARGS) + list(TRAIN_CARD_ARGS) + ["--device", str(dev)]
    batch_size = int(argv[argv.index("--batch-size") + 1])
    seq_len = int(argv[argv.index("--seq-len") + 1])
    # the launcher as it is, from the reference's init: recorded, not held
    TimedTrainer.rescale = False
    steps_at = argv.index("--steps") + 1
    ref_args = argv[:steps_at] + [str(TRAIN_REFERENCE_STEPS)] + argv[steps_at + 1:]
    history, wall_s, tr, peak_gb = run_launcher(ref_args + ["--optimizer", "auto"])
    TimedTrainer.rescale = True
    out["reference_init"] = dict(
        argv=ref_args, history=[{k: m[k] for k in ("step", "loss", "ce", "grad_norm")}
                                for m in history], wall_s=wall_s, peak_memory_gb=peak_gb)
    if not all(np.isfinite(m["loss"]) for m in history):
        raise AssertionError(f"train: non-finite loss from the reference's init: {history}")
    log(f"train (the reference's init, as the launcher draws it; AdamW, "
        f"{TRAIN_REFERENCE_STEPS} step(s)): grad norm " + ", ".join(
            f"{m['grad_norm']:.4g}" for m in history) + ", loss " + " -> ".join(
            f"{m['loss']:.4f}" for m in history) + " (the attention fan-in fault, ROADMAP.md "
        f"queue 3: not held); {wall_s:.1f} s, the init's draws {tr.init_s:.1f} s")
    del tr
    leg_done("reference_init")
    out["runs"] = {}
    for opt in TRAIN_OPTIMIZERS:
        history, wall_s, tr, peak_gb = run_launcher(argv + ["--optimizer", opt])
        cfg = tr.cfg
        first, last = history[0]["loss"], history[-1]["loss"]
        if not (np.isfinite(last) and last < first):
            raise AssertionError(f"train ({opt}): the loss did not fall: {first} -> {last}")
        step_ms = list(tr.step_ms)  # the run's steps; the profiled ones come after
        steady = step_ms[1:]  # the first step loads cuBLAS and fills the allocator
        tokens_per_step = batch_size * seq_len
        p50 = float(np.percentile(steady, 50))
        flops = 6 * cfg.param_count() * tokens_per_step
        # a few more steps under the profiler: device busy against the host
        # clock of the same steps (the profiler adds host overhead)
        data = synthetic_lm_batches(cfg, LMDataConfig(batch_size=batch_size, seq_len=seq_len,
                                                      seed=1))
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
                   for _ in range(TRAIN_PROFILE_STEPS)]
        torch.cuda.synchronize()
        wall = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for batch in batches:
                t = time.perf_counter()
                tr.params, tr.opt_state, _ = tr.step_fn(tr.params, tr.opt_state, batch)
                wall.append((time.perf_counter() - t) * 1e3)
        per_kernel = sorted(
            ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in per_kernel)
        rec = dict(
            optimizer=type(tr.opt_state).__name__, model=cfg.name, dtype=cfg.dtype,
            layers=cfg.n_layers, params=cfg.param_count(), batch=batch_size, seq_len=seq_len,
            steps=len(step_ms), argv=argv + ["--optimizer", opt],
            history=[{k: m[k] for k in ("step", "loss", "ce", "grad_norm")} for m in history],
            loss_first=first, loss_last=last, init_s=tr.init_s, wall_s=wall_s,
            step_ms=step_ms, step_ms_p50=p50, step_ms_p99=float(np.percentile(steady, 99)),
            tokens_per_s=tokens_per_step / (p50 / 1e3),
            tokens_per_s_wall=tokens_per_step * len(step_ms) / wall_s,
            flops_share=flops / (p50 / 1e3) / PEAK_BF16_FLOP_PER_S, peak_memory_gb=peak_gb,
            profiled=dict(steps=len(wall), wall_ms=float(sum(wall)), busy_ms=busy,
                          idle_share=1 - busy / float(sum(wall)),
                          top_kernels_ms={k[:80]: v for k, v in per_kernel[:8]}))
        out["runs"][opt] = rec
        log(f"train ({opt} -> {rec['optimizer']}): {cfg.name} {cfg.n_layers} layers "
            f"{cfg.dtype}, {rec['params']:,} params, batch {batch_size} x {seq_len} tokens, "
            f"wq, wk, wv at a d_model fan-in, argv {' '.join(rec['argv'])}: loss "
            + " -> ".join(f"{m['loss']:.4f}" for m in history) + f"; step ms p50 "
            f"{p50:.1f} p99 {rec['step_ms_p99']:.1f} (first {step_ms[0]:.1f}), "
            f"{rec['tokens_per_s']:.0f} tokens/s ({rec['tokens_per_s_wall']:.0f} with the "
            f"host's data and init, {wall_s:.1f} s; init {tr.init_s:.1f} s), model-FLOPs "
            f"share {rec['flops_share']:.4f} of 989 TFLOP/s, peak device memory "
            f"{peak_gb:.1f} GB; profiled {len(wall)} steps: host clock {sum(wall):.1f} ms, "
            f"device busy {busy:.1f} ms, idle share {rec['profiled']['idle_share']:.4f}; top "
            "kernels ms " + json.dumps({k[:50]: round(v, 1) for k, v in per_kernel[:6]})
            + f"; on {card}")
        del tr, batches
        leg_done(f"run_{opt}")
    drawn.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) save mid-run, restore into a fresh Trainer, continue
    cfg = train_resume_config()
    lr = float(argv[argv.index("--lr") + 1])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = trainer_mod.TrainerConfig(
            steps=2, log_every=1, ckpt_dir=ckpt_dir,
            train=TrainConfig(learning_rate=lr, optimizer=TRAIN_RESUME_OPT, total_steps=4))

        def data(skip=0):
            it = synthetic_lm_batches(cfg, LMDataConfig(batch_size=batch_size,
                                                        seq_len=seq_len // 4))
            for _ in range(skip):
                next(it)
            return it

        quiet = lambda _line: None  # noqa: E731
        a = trainer_mod.Trainer(cfg, tcfg, device=dev)
        stream = data()
        a.fit(stream, log=quiet)
        t0 = time.perf_counter()
        a.save()
        save_s = time.perf_counter() - t0
        ckpt_mb = sum(f.stat().st_size for f in Path(ckpt_dir).glob("*.ckpt")) / 1e6
        a.fit(stream, log=quiet)
        uninterrupted = a.history[2:]
        del a
        b = trainer_mod.Trainer(cfg, dataclasses.replace(tcfg, seed=1), device=dev)
        t0 = time.perf_counter()
        b.restore()
        restore_s = time.perf_counter() - t0
        b.fit(data(skip=2), log=quiet)
        gaps = [abs(x["loss"] - y["loss"]) for x, y in zip(b.history, uninterrupted)]
        if [m["step"] for m in b.history] != [3, 4] or not max(gaps) <= TRAIN_RESUME_ATOL:
            raise AssertionError(f"train: the restored trainer's steps {b.history} against "
                                 f"{uninterrupted}")
        del b
    out["resume"] = dict(layers=cfg.n_layers, d_model=cfg.d_model, optimizer=TRAIN_RESUME_OPT,
                         save_s=save_s, restore_s=restore_s, checkpoint_mb=ckpt_mb,
                         loss_gaps=gaps, losses=[m["loss"] for m in uninterrupted])
    log(f"train: saved after step 2 ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {TRAIN_RESUME_OPT}; {ckpt_mb:.1f} MB in {save_s:.1f} s), restored into "
        f"a fresh Trainer in {restore_s:.1f} s: steps 3-4 losses "
        + ", ".join(f"{m['loss']:.5f}" for m in uninterrupted) + " uninterrupted, |d| "
        + ", ".join(f"{g:.2e}" for g in gaps) + f" (tolerance {TRAIN_RESUME_ATOL})")
    leg_done("resume")
    log("train: seconds by leg " + json.dumps({k: round(v, 1)
                                               for k, v in out["leg_seconds"].items()}))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------- 14. runtime, 15. mesh
def runtime_phase(dev, card, big, native, tmp):
    """Phase 14: the port's runtime checks on the card. The retrace leg
    (`python -m repro_torch.analysis.retrace --smoke` over the 100,000-tool
    table, fused backend) in a fresh process, whose `topk_sim` probe must
    stay within the route-derived budget and grow by 0 on the second sweep;
    the lockgraph leg in process over the native 2,413 tools (fused): 0
    cycles, 0 dispatch under a lock, 0 thread errors; and a planted upload
    under a tracked lock, which the watch must catch. Returns the summary
    (the retrace process's kernel launches in "retrace_launches"); raises
    on any failed check."""
    import re

    import numpy as np
    import torch

    from repro_torch.analysis import lockgraph

    out = {"card": card}
    table_path = Path(tmp) / "retrace_table.npy"
    np.save(table_path, np.ascontiguousarray(big, np.float32))
    code = ("import json, sys\n"
            "from repro_torch.analysis import retrace\n"
            "from repro_torch.kernels.topk_sim import kernel\n"
            "rc = retrace.main(sys.argv[1:])\n"
            "print('LAUNCHES ' + json.dumps({'launches': kernel.launches, "
            "'routes': kernel.launches_by_route}))\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    retrace_proc = subprocess.Popen(
        [sys.executable, "-c", code, "--smoke", "--table", str(table_path), "--device",
         str(dev)],
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # ---- (b) lockgraph in process, at the native table, beside the retrace
    # process (both on the card; neither is timed)
    t1 = time.perf_counter()
    report = lockgraph.run_scenario(seed=0, iters=LOCKGRAPH_ITERS, device=dev, table=native)
    out["lockgraph"] = dict(
        seconds=time.perf_counter() - t1, tools=int(native.shape[0]), locks=report["locks"],
        edges=report["edges"], cycles=report["cycles"],
        dispatch_under_lock=report["dispatch_under_lock"], errors=report["errors"])
    log(f"runtime: lockgraph at {native.shape[0]} tools (fused, {report['device']}): "
        f"{len(report['locks'])} tracked locks, edges {report['edges']}, "
        f"{len(report['cycles'])} cycles, {len(report['dispatch_under_lock'])} dispatch "
        f"under a lock, {len(report['errors'])} thread errors in "
        f"{out['lockgraph']['seconds']:.1f} s")
    if report["cycles"] or report["dispatch_under_lock"] or report["errors"]:
        raise AssertionError(f"runtime: lockgraph failed: {json.dumps(out['lockgraph'])}")

    # ---- (c) the negative control: an upload under a tracked lock is caught
    graph = lockgraph.LockGraph()
    planted = lockgraph.TrackedLock(graph, name="planted")
    with lockgraph.watch_dispatch(graph):
        with planted:
            torch.ones(8).to(dev)
    caught = [ev["fn"] for ev in graph.dispatch_events]
    out["planted_caught"] = caught
    if "Tensor.to" not in caught:
        raise AssertionError(f"runtime: the planted upload under a lock was not caught ({caught})")
    log(f"runtime: a planted upload to {dev} under a tracked lock is caught: {caught}")

    # ---- (a) the retrace process
    stdout, stderr = retrace_proc.communicate(timeout=RETRACE_TIMEOUT_S)
    out["retrace_seconds"] = time.perf_counter() - t0
    if retrace_proc.returncode != 0:
        raise AssertionError(f"runtime: retrace exited {retrace_proc.returncode}:\n"
                             f"{stdout}\n{stderr}")
    m = re.search(r"topk_sim: (\d+) load\(s\)/first launch\(es\), budget (\d+); "
                  r"second sweep (\d+)", stdout)
    launches = json.loads(stdout.split("LAUNCHES ", 1)[1].splitlines()[0])
    grew, budget, second = (int(g) for g in m.groups())
    out["retrace"] = dict(tools=int(big.shape[0]), dim=int(big.shape[1]), grew=grew,
                          budget=budget, second_sweep=second, **launches)
    log(f"runtime: retrace over {big.shape[0]} x {big.shape[1]} (fused) in a fresh process: "
        f"the topk_sim probe grew {grew} (budget {budget}: the routes "
        f"{sorted(r for r, n in launches['routes'].items() if n)} of its buckets, + 1 if the "
        f"library was not loaded when the sweep began), second "
        f"sweep {second}; {launches['launches']} launches in {out['retrace_seconds']:.1f} s")
    if not (grew <= budget and second == 0 and launches["launches"] > 0):
        raise AssertionError(f"runtime: retrace outside its budget: {out['retrace']}")
    return out


def _mesh_families():
    """(dbrx at phase 12's depth, the same at the two-rank capacity factor,
    musicgen whole), bf16 at full width."""
    import dataclasses

    from repro_torch.configs import get_config

    dbrx = dataclasses.replace(get_config("dbrx-132b"), n_layers=FAMILIES["dbrx-132b"][0])
    return dbrx, dataclasses.replace(dbrx, capacity_factor=8.0), get_config("musicgen-medium")


def _mesh_trainer_config():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training.train_step import TrainConfig
    from repro_torch.training.trainer import TrainerConfig

    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=MESH_TRAIN_LAYERS,
                              dtype="float32")
    # an lr at which two steps' updates stand well above the params' float32
    # rounding, so the updates can be compared
    train = TrainConfig(optimizer="sgd", learning_rate=0.1, warmup_steps=0, total_steps=10)
    return cfg, TrainerConfig(steps=2, log_every=1, seed=0, train=train)


def _mesh_batches(cfg):
    import numpy as np

    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (2, MESH_TRAIN_SEQ)).astype(np.int32)}
            for _ in range(2)]


def _prompt(cfg, length, dev, seed):
    import torch

    shape = (1, length, cfg.n_codebooks) if cfg.n_codebooks else (1, length)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)


def _seeded_params(cfg, dev):
    """The model every rank draws alike: seeded on its device, attention at
    a d_model fan-in (as the pool serves)."""
    import torch

    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    return M.attention_at_d_model_fan_in(cfg, M.init(cfg, gen, device=dev))


def _decode_run(cfg, params, prompt, n_steps, tokens=None, mesh=None):
    """Prefill `prompt`, then `n_steps` decode steps (greedy on the first
    codebook row unless `tokens` gives them); under `mesh` the cache is
    sharded by `decode_cache_specs`. ([logits a step], [tokens fed])."""
    from repro_torch.common import meshctx
    from repro_torch.models import model as M
    from repro_torch.models.decode_shard_map import shard_decode_cache

    s = prompt.shape[1]
    _, cache = M.prefill(cfg, params, {"tokens": prompt}, max_cache_len=s + n_steps)
    logits, fed = [], []
    ctx = meshctx.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        if mesh is not None:
            cache = shard_decode_cache(cfg, cache, mesh)
        tok = prompt[:, -1:]
        for i in range(n_steps):
            if tokens is not None:
                tok = tokens[i]
            fed.append(tok)
            out, cache = M.decode_step(cfg, params, cache, {"token": tok, "pos": s + i})
            logits.append(out)
            if tokens is None:
                tok = out.argmax(-1)
    return logits, fed


def _prefill_flash_calls(calls, cfg, prompt_len, what):
    """[(name, (q, k, v), kwargs)] of layer 0 and the last layer among the
    flash_attention calls `recorded_model_calls` recorded over a prefill
    of `prompt_len` tokens (its first n_layers calls), for the kernel check
    at the mesh path's own shapes."""
    pre = calls[:cfg.n_layers]
    if len(pre) != cfg.n_layers or any(c[0][0].shape[1] != prompt_len for c in pre):
        raise AssertionError(f"mesh: {what} recorded {len(calls)} flash calls, not "
                             f"{cfg.n_layers} over {prompt_len} tokens first")
    return [(f"mesh {what} layer {i}", *pre[i]) for i in (0, cfg.n_layers - 1)]


def _bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for _, v in _named_leaves(tree))


def _moe_block_input(cfg, params, dev):
    """(layer 0's MoE params, a seeded [1, MESH_PREFILL_LEN, d_model] input
    at the model's dtype): the shapes the block takes in the prefill."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, MESH_PREFILL_LEN, cfg.d_model), generator=g, device=dev)
    return ({k: v[0] for k, v in params["layers"]["moe"].items()},
            x.to(getattr(torch, cfg.dtype)))


def _bf16_check(got, ref, what):
    """bf16 logits against their reference at `bf16_logits_close`'s
    tolerance (a whole model's rounding, not one attention call's:
    `flash_error`'s numbers are reported beside it)."""
    e = flash_error(got, ref)
    e["max_abs_err"], ok = bf16_logits_close(got, ref)
    if not ok:
        raise AssertionError(f"mesh: {what} outside the bf16 logits tolerance: {e}")
    return e


def _leaf_gaps(got, ref, names):
    """(worst leaf, ||g - g_ref|| / ||g_ref||) over leaves, as
    `scenarios.grad_gaps` reads them (the absolute gap where g_ref is 0)."""
    gaps = {n: float((a - b).norm() / (b.norm() if b.norm() > 0 else 1.0))
            for n, a, b in zip(names, got, ref)}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def _mesh_trainer(cfg, tc, **kwargs):
    """A Trainer whose model has wq, wk, wv at a d_model fan-in (as phase
    13 trains: the reference's init makes the attention logits so large
    that float32 rounding moves its gradients by ~1e-3 between batch
    splits), and the names of its params' leaves."""
    from repro_torch.models import model as M
    from repro_torch.training.trainer import Trainer

    trainer = Trainer(cfg, tc, **kwargs)
    trainer.params = M.attention_at_d_model_fan_in(cfg, trainer.params)
    names = [path for path, _ in _named_leaves(trainer.params)]
    return trainer, names


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def mesh_phase(dev, card, bench, native, q_all, tmp, backend="nccl"):
    """Phase 15: the multi-device runtime on the card. (a) world size 1
    over `backend` (NCCL), mesh (1, 1) ("data", "model"): dbrx-132b (phase
    12's depth) through a 2,048-token prefill with moe_impl="shard_map"
    against "gspmd" at the bf16 rule; musicgen-medium's decode steps with
    decode_attn="seq_shard" against the baseline; the ToolBench-like
    table's refinement sharded against unsharded; a `Trainer(mesh=)` step
    against a single-device one; the MoE block's and its all-reduce's ms.
    Then the references of (b): two ranks sharing the card over gloo, mesh
    (1, 2), in processes of their own (`mesh_worker`): the same checks
    against (a)'s results, dbrx at capacity factor 8 with each rank
    holding its E/2 experts, and two data-parallel Trainer steps on a (2, 1)
    mesh. Returns the summary, with the world-size-1 prefills' flash inputs
    in "flash_calls" (layer 0 and the last, for the kernel check after the
    path's launches are read) and the gloo ranks' own such checks in
    "gloo_flash_checks"; raises on any failed check."""
    import torch
    import torch.distributed as dist

    from repro_torch.common import meshctx
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    out = {"card": card}
    try:
        meshctx.make_mesh((1, 1), ("data", "model"), dev)
    except RuntimeError as err:
        out["no_group_error"] = str(err)
    else:
        raise AssertionError("mesh: make_mesh without a process group did not raise")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = meshctx.make_mesh((1, 1), ("data", "model"), dev)
        out["world1"] = _mesh_world_one(dev, card, mesh, bench, native, q_all, tmp)
        out["flash_calls"] = out["world1"].pop("flash_calls")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if not flash_kernel.launches:
        raise AssertionError("mesh: the world-size-1 path launched no flash kernel")

    # ---- (b) two ranks sharing the card over gloo
    log(f"mesh: {torch.cuda.memory_allocated() / 1e9:.1f} GB held here while the two gloo "
        f"ranks run")
    t0 = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(_worker_argv(r, port, tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    results, texts = {}, {}
    try:
        for r, p in enumerate(procs):
            texts[r] = p.communicate(timeout=MESH_WORKER_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("mesh: the gloo ranks exited " + ", ".join(
            f"{r}: {p.returncode}:\n{texts[r][-4000:]}" for r, p in enumerate(procs)))
    for r, p in enumerate(procs):
        lines = [l for l in texts[r].splitlines() if l.startswith("MESH_WORKER ")]
        if not lines:
            raise AssertionError(f"mesh: gloo rank {r} printed no result:\n{texts[r][-4000:]}")
        results[r] = json.loads(lines[-1][len("MESH_WORKER "):])
        for l in texts[r].splitlines():
            if l.startswith("mesh["):
                log(f"{l} on {card}")
    out["gloo"] = results
    out["gloo_seconds"] = time.perf_counter() - t0
    out["gloo_launches"] = {"flash_attention": sum(r["launches"]["flash_attention"]
                                                   for r in results.values())}
    out["gloo_flash_checks"] = [c for r in results.values() for c in r.pop("flash_checks")]
    log(f"mesh: two gloo ranks on one card in {out['gloo_seconds']:.1f} s, flash launches "
        f"{out['gloo_launches']}; gloo took the CUDA tensors of every collective (all_reduce "
        f"SUM and MAX, all_gather): no op staged through the host, on {card}")
    return out


def _worker_argv(rank, port, tmp):
    """The command of one of phase 15's gloo ranks: this script again."""
    return [sys.executable, str(Path(__file__).resolve()), "--mesh-worker", str(rank),
            "--port", str(port), "--dir", str(tmp)]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_world_one(dev, card, mesh, bench, native, q_all, tmp):
    """Phase 15 (a) on a (1, 1) mesh; saves (b)'s references in `tmp`."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common import meshctx, sharding
    from repro_torch.core.refine import refine_embeddings
    from repro_torch.models import layers, model as M
    from repro_torch.models.moe_shard_map import moe_block_shard_map, shard_expert_params
    from repro_torch.optim.base import tree_leaves

    out = {}
    refs = {}
    flash_calls = []  # the mesh path's flash inputs, checked once its launches are read
    dbrx, dbrx_b, musicgen = _mesh_families()
    # ---- the MoE: gspmd against shard_map at phase 12's depth
    with torch.no_grad():
        params = _seeded_params(dbrx, dev)
        prompt = _prompt(dbrx, MESH_PREFILL_LEN, dev, 11)
        ref, _ = M.prefill(dbrx, params, {"tokens": prompt})
        # (b)'s reference: the same model at capacity factor 8
        refs["dbrx"] = M.prefill(dbrx_b, params, {"tokens": prompt})[0].cpu()
        sm = dataclasses.replace(dbrx, moe_impl="shard_map")
        calls = []
        with meshctx.use_mesh(mesh), recorded_model_calls(calls, []):
            got, _ = M.prefill(sm, shard_expert_params(sm, params, mesh), {"tokens": prompt})
        flash_calls += _prefill_flash_calls(calls, dbrx, MESH_PREFILL_LEN, "dbrx shard_map prefill")
        del calls
        e = _bf16_check(got, ref, "dbrx shard_map prefill")
        p, x = _moe_block_input(dbrx, params, dev)
        with meshctx.use_mesh(mesh):
            y = moe_block_shard_map(p, x, sm)[0]
            times = dict(gspmd_ms=cuda_ms(lambda: layers.moe_block(p, x, dbrx), iters=5),
                         shard_map_ms=cuda_ms(lambda: moe_block_shard_map(p, x, sm), iters=5),
                         psum_ms=cuda_ms(lambda: mesh.psum(y, "model"), iters=20))
        out["moe"] = dict(layers=dbrx.n_layers, tokens=MESH_PREFILL_LEN, err=e, **times,
                          y_shape=list(y.shape))
        log(f"mesh[world 1] dbrx-132b {dbrx.n_layers} of 40 layers, {MESH_PREFILL_LEN}-token "
            f"prefill: shard_map against gspmd max|d| {e['max_abs_err']:.3g} (rel norm "
            f"{e['rel_norm']:.3g}); MoE block {times['gspmd_ms']:.3f} "
            f"ms gspmd, {times['shard_map_ms']:.3f} ms shard_map, its all-reduce of "
            f"{list(y.shape)} bf16 {times['psum_ms']:.4f} ms on {card}")
        del params, p, x, y, got, ref
        gc.collect()
        torch.cuda.empty_cache()

        # ---- musicgen: seq-sharded decode against the baseline
        params = _seeded_params(musicgen, dev)
        prompt = _prompt(musicgen, MESH_DECODE_PROMPT, dev, 12)
        base, fed = _decode_run(musicgen, params, prompt, MESH_DECODE_STEPS)
        seq = dataclasses.replace(musicgen, decode_attn="seq_shard")
        calls = []
        with sharding.set_policy("tp_kvs"), recorded_model_calls(calls, []):
            got, _ = _decode_run(seq, params, prompt, MESH_DECODE_STEPS, tokens=fed, mesh=mesh)
        flash_calls += _prefill_flash_calls(calls, musicgen, MESH_DECODE_PROMPT,
                                            "musicgen-medium prefill")
        del calls
        errs = [_bf16_check(g, b, f"musicgen decode step {i}")
                for i, (g, b) in enumerate(zip(got, base))]
        out["decode"] = dict(steps=MESH_DECODE_STEPS, prompt=MESH_DECODE_PROMPT,
                             max_abs_err=max(x["max_abs_err"] for x in errs))
        refs["musicgen"] = dict(logits=[b.cpu() for b in base], fed=[f.cpu() for f in fed])
        log(f"mesh[world 1] musicgen-medium {MESH_DECODE_STEPS} decode steps after a "
            f"{MESH_DECODE_PROMPT}-token prompt, seq_shard / tp_kvs against the baseline: "
            f"max|d| {out['decode']['max_abs_err']:.3g}")
        del params, base, got
        gc.collect()
        torch.cuda.empty_cache()

    # ---- refinement of the ToolBench-like table, sharded over "model"
    train = bench.train_idx
    rel = torch.from_numpy(bench.relevance_matrix()[train]).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(q_all[train])).to(dev)
    t = torch.from_numpy(np.ascontiguousarray(native)).to(dev)
    ref = refine_embeddings(t, q, rel, keep_history=False)
    with meshctx.use_mesh(mesh):
        got = sharding.gather_rows(refine_embeddings(
            sharding.distribute_rows(t, mesh, ("model", None)), q,
            sharding.distribute_rows(rel, mesh, (None, "model")), keep_history=False))
    err = float((got - ref).abs().max())
    out["refine"] = dict(tools=int(t.shape[0]), queries=int(q.shape[0]), max_abs_err=err)
    refs["refine"] = dict(q=q.cpu(), t=t.cpu(), rel=rel.cpu(), out=ref.cpu())
    log(f"mesh[world 1] refinement of {t.shape[0]} tools x {q.shape[0]} train queries "
        f"sharded over model: max|d| {err:.3g}")
    if err > MESH_REFINE_ATOL:
        raise AssertionError(f"mesh: sharded refinement off by {err}")

    # ---- the Trainer: single device, and Trainer(mesh=) at world size 1
    cfg, tc = _mesh_trainer_config()
    batches = _mesh_batches(cfg)
    single, _ = _mesh_trainer(cfg, tc, device=dev)
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"]).to(dev)}
    grads = torch.autograd.grad(M.loss_fn(cfg, single.params, batch)[0],
                                tree_leaves(single.params))
    init = [p.detach().clone() for p in tree_leaves(single.params)]
    hist = single.fit(iter(batches), log=lambda *_: None)
    meshed, _ = _mesh_trainer(cfg, tc, mesh=mesh)
    hist_m = meshed.fit(iter(batches), log=lambda *_: None)
    perr = max(float((a - b).detach().abs().max()) for a, b in
               zip(tree_leaves(single.params), tree_leaves(meshed.params)))
    lerr = max(abs(x["loss"] - y["loss"]) for x, y in zip(hist, hist_m))
    out["trainer"] = dict(layers=cfg.n_layers, params=cfg.param_count(), loss_err=lerr,
                          param_err=perr, losses=[x["loss"] for x in hist])
    refs["trainer"] = dict(grads=[g.cpu() for g in grads],
                           updates=[(p.detach() - p0).cpu() for p, p0 in
                                    zip(tree_leaves(single.params), init)],
                           losses=[x["loss"] for x in hist])
    log(f"mesh[world 1] Trainer(mesh=) against one device, hymba-1.5b {cfg.n_layers} layers "
        f"float32, SGD: losses {[round(x['loss'], 5) for x in hist]}, |d loss| {lerr:.3g}, "
        f"params max|d| {perr:.3g}")
    if lerr > MESH_TRAIN_ATOL or perr > MESH_TRAIN_ATOL:
        raise AssertionError(f"mesh: Trainer(mesh=) at world size 1 off: {out['trainer']}")
    del single, meshed, grads
    torch.save(refs, Path(tmp) / "mesh_refs.pt")
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_calls"] = flash_calls
    return out


def mesh_worker(rank: int, port: int, tmp: str) -> int:
    """One of phase 15's two gloo ranks on the one card, mesh (1, 2)
    ("data", "model"): the checks of (b) against the references (a) saved
    in `tmp`. Prints `mesh[rank R] ...` lines and, last, `MESH_WORKER
    {json}`; raises on a failed check."""
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.common import meshctx, sharding
    from repro_torch.core.refine import refine_embeddings
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import model as M
    from repro_torch.models.moe_shard_map import init_expert_parallel, moe_block_shard_map
    from repro_torch.optim.base import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    refs = torch.load(Path(tmp) / "mesh_refs.pt")
    out = {"rank": rank, "launches": {}}

    def say(text):
        log(f"mesh[rank {rank} of 2, gloo] {text}")

    mesh = meshctx.make_mesh((1, 2), ("data", "model"), dev)
    _, dbrx_b, musicgen = _mesh_families()
    sm = dataclasses.replace(dbrx_b, moe_impl="shard_map")
    flash_kernel.launches = 0
    flash_calls = []
    with torch.no_grad():
        # (a)'s model, each expert weight cut to this rank's E/2 as it is
        # drawn: the rank never holds all E experts in bf16; the ranks draw
        # in turns, so one whole expert weight's float32 draw is on the card
        torch.cuda.reset_peak_memory_stats()
        for r in range(2):
            if r == rank:
                gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
                params = M.attention_at_d_model_fan_in(
                    sm, init_expert_parallel(sm, gen, mesh, dev))
                torch.cuda.empty_cache()
            dist.barrier()
        memory = dict(param_bytes=_bytes(params),
                      full_param_bytes=sm.param_count() * params["embed"].element_size(),
                      experts_here=int(params["layers"]["moe"]["w_gate"].shape[1]),
                      init_peak_bytes=torch.cuda.max_memory_allocated(),
                      allocated_bytes=torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        prompt = _prompt(sm, MESH_PREFILL_LEN, dev, 11)
        calls = []
        with meshctx.use_mesh(mesh), recorded_model_calls(calls, []):
            got, _ = M.prefill(sm, params, {"tokens": prompt})
        flash_calls += _prefill_flash_calls(calls, sm, MESH_PREFILL_LEN,
                                            f"dbrx shard_map prefill, rank {rank} of 2")
        del calls
        memory["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["memory"] = memory
        with meshctx.use_mesh(mesh):
            e = _bf16_check(got, refs["dbrx"].to(dev), "dbrx shard_map prefill on 2 ranks")
            p, x = _moe_block_input(dbrx_b, params, dev)
            y = moe_block_shard_map(p, x, sm)[0]
            times = dict(shard_map_ms=cuda_ms(lambda: moe_block_shard_map(p, x, sm), iters=5),
                         psum_ms=cuda_ms(lambda: mesh.psum(y, "model"), iters=10))
        out["moe"] = dict(layers=dbrx_b.n_layers, err=e, **times)
        say(f"dbrx-132b {dbrx_b.n_layers} of 40 layers, capacity factor 8, {MESH_PREFILL_LEN}-token "
            f"prefill with {memory['experts_here']} of {dbrx_b.n_experts} experts held here, "
            f"against world size 1's gspmd: max|d| {e['max_abs_err']:.3g} (rel norm "
            f"{e['rel_norm']:.3g}); params here {memory['param_bytes'] / 1e9:.2f} GB of the "
            f"model's {memory['full_param_bytes'] / 1e9:.2f} GB (peak {memory['init_peak_bytes'] / 1e9:.2f}"
            f" GB through the draw), {memory['allocated_bytes'] / 1e9:.2f} GB allocated before the "
            f"prefill, peak {memory['prefill_peak_bytes'] / 1e9:.2f} GB through it; MoE block {times['shard_map_ms']:.3f} ms, its gloo all-reduce of "
            f"{list(y.shape)} bf16 {times['psum_ms']:.3f} ms")
        del params, p, x, y, got
        gc.collect()
        torch.cuda.empty_cache()

        params = _seeded_params(musicgen, dev)
        prompt = _prompt(musicgen, MESH_DECODE_PROMPT, dev, 12)
        seq = dataclasses.replace(musicgen, decode_attn="seq_shard")
        fed = [f.to(dev) for f in refs["musicgen"]["fed"]]
        calls = []
        with sharding.set_policy("tp_kvs"), recorded_model_calls(calls, []):
            got, _ = _decode_run(seq, params, prompt, MESH_DECODE_STEPS, tokens=fed, mesh=mesh)
        flash_calls += _prefill_flash_calls(calls, musicgen, MESH_DECODE_PROMPT,
                                            f"musicgen-medium prefill, rank {rank} of 2")
        del calls
        errs = [_bf16_check(g, b.to(dev), f"musicgen decode step {i} on 2 ranks")
                for i, (g, b) in enumerate(zip(got, refs["musicgen"]["logits"]))]
        out["decode"] = dict(max_abs_err=max(x["max_abs_err"] for x in errs))
        say(f"musicgen-medium {MESH_DECODE_STEPS} decode steps, W/2 cache slots a rank, against "
            f"world size 1's baseline: max|d| {out['decode']['max_abs_err']:.3g}")
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"]["flash_attention"] = flash_kernel.launches
    if not flash_kernel.launches:
        raise AssertionError("mesh: a gloo rank launched no flash kernel")
    # the kernel at this rank's prefill inputs against its plain version
    # (after the count: a comparison's launches are not the path's)
    out["flash_checks"] = [check_flash_call(name, *args, **kw) for name, args, kw in flash_calls]
    del flash_calls

    r = refs["refine"]
    q, t, rel = (r[n].to(dev) for n in ("q", "t", "rel"))
    with meshctx.use_mesh(mesh):
        t_s = sharding.distribute_rows(t, mesh, ("model", None))
        got = sharding.gather_rows(refine_embeddings(
            t_s, q, sharding.distribute_rows(rel, mesh, (None, "model")), keep_history=False))
    err = float((got - r["out"].to(dev)).abs().max())
    out["refine"] = dict(rows_here=int(t_s.to_local().shape[0]), max_abs_err=err)
    say(f"refinement of {t.shape[0]} tools, {out['refine']['rows_here']} rows here: max|d| "
        f"{err:.3g} against world size 1's unsharded")
    if err > MESH_REFINE_ATOL:
        raise AssertionError(f"mesh: sharded refinement off by {err}")

    dp = meshctx.make_mesh((2, 1), ("data", "model"), dev)
    cfg, tc = _mesh_trainer_config()
    batches = _mesh_batches(cfg)
    trainer, names = _mesh_trainer(cfg, tc, mesh=dp)
    local = {"tokens": trainer._rows(batches[0]["tokens"])}
    with meshctx.use_mesh(dp):
        g_local = torch.autograd.grad(M.loss_fn(cfg, trainer.params, local)[0],
                                      tree_leaves(trainer.params))
    grads = trainer._data_mean(list(g_local))
    leaf, gap = _leaf_gaps(grads, [g.to(dev) for g in refs["trainer"]["grads"]], names)
    init = [p.detach().clone() for p in tree_leaves(trainer.params)]
    hist = trainer.fit(iter(batches), log=lambda *_: None)
    lerr = max(abs(a["loss"] - b) for a, b in zip(hist, refs["trainer"]["losses"]))
    updates = [p.detach() - p0 for p, p0 in zip(tree_leaves(trainer.params), init)]
    ref_updates = [u.to(dev) for u in refs["trainer"]["updates"]]
    # the params' gap (both ranks start from (a)'s init), and the updates'
    # relative gap, read at the params' float32 resolution (printed)
    perr = max(float((u - r).abs().max()) for u, r in zip(updates, ref_updates))
    pleaf, pgap = _leaf_gaps(updates, ref_updates, names)
    out["trainer"] = dict(grad_gap=gap, grad_leaf=leaf, loss_err=lerr, param_err=perr,
                          update_gap=pgap, update_leaf=pleaf)
    say(f"two data-parallel Trainer steps (mesh (2, 1), one of 2 rows a rank): grads "
        f"||d|| / ||g|| {gap:.3g} at worst ({leaf}), |d loss| {lerr:.3g}, params max|d| "
        f"{perr:.3g} (the two steps' updates ||d|| / ||u|| {pgap:.3g}, {pleaf}) against "
        f"world size 1's one device")
    if gap > MESH_TRAIN_ATOL or lerr > MESH_TRAIN_ATOL or perr > MESH_TRAIN_ATOL:
        raise AssertionError(f"mesh: data-parallel Trainer off: {out['trainer']}")
    dist.destroy_process_group()
    log("MESH_WORKER " + json.dumps(out))
    return 0


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


# ----------------------------------------------------------------- 16. dryrun


def _dryrun_cmd(arch, shapes, mesh, more, out_dir):
    """`python -m repro_torch.launch.dryrun` in a process of its own that
    cannot see the card (the dry-run is host-only)."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
            shapes, "--mesh", mesh, "--no-probe", "--out", str(out_dir), *more]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _dryrun_wait(proc, what):
    """The process's output; raises unless it exits 0 within the limit."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dryrun: {what} ran past {DRYRUN_TIMEOUT_S} s")
    lines = [line for line in out.splitlines() if line.startswith(("OK ", "FAIL "))]
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: {what} exited {proc.returncode}:\n{out[-4000:]}")
    return lines


def _dryrun_record(out_dir, arch, shape, mesh):
    with open(Path(out_dir) / f"{arch}__{shape}__{mesh}.json") as f:
        return json.load(f)


def _card_arguments(kind, cfg, shape, dev):
    """Seeded real arguments of phase 16's program on the card, in the
    layout of the dry-run's structs: bf16 params from the d_model fan-in
    (train: requiring grad, with AdamW's state), int32 tokens, and for the
    decode the cache of a prefill of the same model."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.optim.base import tree_map
    from repro_torch.training.train_step import TrainConfig, choose_optimizer

    gen = torch.Generator(device=dev).manual_seed(DRYRUN_SEED)
    with torch.no_grad():
        params = M.attention_at_d_model_fan_in(cfg, M.init(cfg, gen, device=dev))
    tokens = lambda s: torch.randint(0, cfg.vocab_size, (shape.global_batch, s),  # noqa: E731
                                     generator=gen, device=dev, dtype=torch.int32)
    if kind == "train":
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        opt = choose_optimizer(cfg, TrainConfig(optimizer="adamw"))
        return params, opt.init(params), {"tokens": tokens(shape.seq_len)}
    if kind == "prefill":
        return params, {"tokens": tokens(shape.seq_len)}
    with torch.no_grad():
        _, cache = M.prefill(cfg, params, {"tokens": tokens(shape.seq_len - 1)},
                             max_cache_len=shape.seq_len, use_kernel=False)
    return params, cache, {"token": tokens(1), "pos": shape.seq_len - 1}


def _as_dtensors(args, structs):
    """The real arguments `args` as DTensors in the layout of the dry-run's
    `structs` (this rank's blocks: at world size 1 the whole tensors)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map

    def wrap(t, struct):
        if not isinstance(struct, DTensor):
            return t
        if tuple(t.shape) != tuple(struct.to_local().shape):
            raise AssertionError(f"dryrun (c): an argument of shape {tuple(t.shape)} for a "
                                 f"block of {tuple(struct.to_local().shape)}")
        x = DTensor.from_local(t.detach(), struct.device_mesh, struct.placements,
                               run_check=False, shape=struct.shape, stride=struct.stride())
        return x.requires_grad_() if struct.requires_grad else x

    return tree_map(wrap, args, structs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def _dryrun_dtensor_leg(dev, card, one_dir, backend="nccl"):
    """Phase 16 (c): DRYRUN_PROGRAMS as DTensor programs on the card, over
    the (1, 1) mesh of an NCCL group of one: the dry-run's partitioner
    (`common.sharding`'s project / blockwise / token_nll, the constraint
    points, DTensor's dispatch) on real bf16 tensors, its FLOPs counted by
    the dry-run's own `CostMode` and required to equal the dry-run's
    records (`--mesh 1x1`), its peak `max_memory_allocated()` within
    DRYRUN_MEMORY_GAP of the dry-run's, no collective issued."""
    import torch
    import torch.distributed as dist

    from repro_torch.common import meshctx
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.training.train_step import TrainConfig

    out = {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = meshctx.make_mesh((1, 1), ("data", "model"), dev)
        for kind, name, b, s in DRYRUN_PROGRAMS:
            shape = D.resolve_shape(name, s, b)
            rec = _dryrun_record(one_dir, DRYRUN_ARCH, shape.name, "1x1")
            cfg = get_config(DRYRUN_ARCH)
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            fn, structs = D.build_program(cfg, shape, mesh, TrainConfig(optimizer="adamw"),
                                          remat=False)
            args = _as_dtensors(_card_arguments(kind, cfg, shape, dev), structs)
            del structs
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() - before
            cost, colls, mem, seconds = D.run_program(fn, args, mesh, fake=False)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            del args, fn
            gc.collect()
            torch.cuda.empty_cache()
            want = rec["per_device"]
            predicted = want["argument_bytes"] + want["temp_bytes"] + want["output_bytes"]
            gap = (peak - predicted) / peak
            row = dict(shape=shape.name, dryrun_flops=want["flops"], card_flops=cost.flops,
                       dryrun_peak_bytes=predicted, card_peak_bytes=peak, gap=gap,
                       card_argument_bytes=base, card_counted_peak_bytes=(
                           mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]),
                       collectives=colls.count_by_type, seconds=seconds)
            out[kind] = row
            log(f"dryrun (c) ({kind}, {DRYRUN_ARCH} {shape.name}, DTensor on a (1, 1) NCCL "
                f"mesh): FLOPs dry-run {row['dryrun_flops']:.6e} card {row['card_flops']:.6e}; "
                f"peak bytes dry-run {predicted:,} card {peak:,} (argument {base:,}; counted "
                f"on the card {row['card_counted_peak_bytes']:,}), gap {gap:+.4f} (limit "
                f"{DRYRUN_MEMORY_GAP}); collectives {json.dumps(colls.count_by_type)}; "
                f"{seconds:.1f} s; {card}")
            if row["dryrun_flops"] != row["card_flops"]:
                raise AssertionError(f"dryrun (c) ({kind}): FLOPs {row['dryrun_flops']} "
                                     f"against the card's {row['card_flops']}")
            if not abs(gap) <= DRYRUN_MEMORY_GAP:
                raise AssertionError(f"dryrun (c) ({kind}): peak {predicted} against the "
                                     f"card's {peak} (gap {gap:+.4f}, limit {DRYRUN_MEMORY_GAP})")
            if any(colls.count_by_type.values()):
                raise AssertionError(f"dryrun (c) ({kind}): collectives at world size 1: "
                                     f"{colls.count_by_type}")
    finally:
        dist.destroy_process_group()
    return out


def dryrun_phase(dev, card, tmp):
    """Phase 16: the dry-run against the card. (a) DRYRUN_PROGRAMS at world
    size 1: each dry-run in a process of its own, then the same program on
    the card (FLOPs equal, peak memory within DRYRUN_MEMORY_GAP, ms beside
    the roofline terms); (c) the same as DTensor programs on the card
    (`_dryrun_dtensor_leg`); (b) DRYRUN_PRODUCTION on the production meshes,
    host-only, each exiting 0 with its record. Returns the summary; raises
    on any failed check."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.training.train_step import TrainConfig

    out = {"card": card, "programs": {}, "production": {}}
    prod_dir, one_dir = Path(tmp) / "production", Path(tmp) / "one"
    t0 = time.perf_counter()
    # (b)'s processes first: they need no card and run beside (a)
    production = [(row, _dryrun_cmd(row[0], row[1], row[2], row[3], prod_dir))
                  for row in DRYRUN_PRODUCTION]
    ones = {kind: _dryrun_cmd(DRYRUN_ARCH, name, "1x1",
                              ("--global-batch", str(b), "--seq-len", str(s), "--no-remat",
                               "--optimizer", "adamw"), one_dir)
            for kind, name, b, s in DRYRUN_PROGRAMS}

    # ---- (a) world size 1: the prediction against the card
    for kind, name, b, s in DRYRUN_PROGRAMS:
        _dryrun_wait(ones[kind], f"{DRYRUN_ARCH} {kind} at world size 1")
        shape = D.resolve_shape(name, s, b)
        rec = _dryrun_record(one_dir, DRYRUN_ARCH, shape.name, "1x1")
        cfg = get_config(DRYRUN_ARCH)
        fn, _ = D.build_program(cfg, shape, None, TrainConfig(optimizer="adamw"), remat=False)
        del _
        gc.collect()
        torch.cuda.empty_cache()
        # what earlier phases still hold is not this program's
        before = torch.cuda.memory_allocated()
        args = _card_arguments(kind, cfg, shape, dev)
        fn(*args)  # warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() - before
        with FlopCounterMode(display=False) as counter:
            res = fn(*args)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        del res
        ms = []
        for _ in range(DRYRUN_TIME_ROUNDS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            res = fn(*args)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            del res
        del args
        gc.collect()
        torch.cuda.empty_cache()
        mem = rec["per_device"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        gap = (peak - predicted) / peak
        terms = rec["roofline"]
        card_ms = float(np.median(ms))
        row = dict(shape=shape.name, dryrun_flops=mem["flops"], card_flops=counter.get_total_flops(),
                   dryrun_peak_bytes=predicted, card_peak_bytes=peak, gap=gap,
                   dryrun_argument_bytes=mem["argument_bytes"], card_argument_bytes=base,
                   card_held_before_bytes=before,
                   temp_bytes=mem["temp_bytes"], output_bytes=mem["output_bytes"],
                   card_ms=card_ms, card_ms_rounds=ms, compute_ms=terms["compute_s"] * 1e3,
                   memory_ms=terms["memory_s"] * 1e3,
                   memory_upper_ms=terms["memory_upper_s"] * 1e3,
                   roofline_share=max(terms["compute_s"], terms["memory_s"]) * 1e3 / card_ms,
                   dominant=terms["dominant"], dryrun_seconds=rec["compile_s"])
        out["programs"][kind] = row
        log(f"dryrun ({kind}, {DRYRUN_ARCH} {shape.name}, world size 1): FLOPs dry-run "
            f"{row['dryrun_flops']:.6e} card {row['card_flops']:.6e}; peak bytes dry-run "
            f"{predicted:,} (argument {mem['argument_bytes']:,} + temp {mem['temp_bytes']:,} + "
            f"output {mem['output_bytes']:,}) card {peak:,} (argument {base:,}; earlier "
            f"phases still held {before:,} beside it, not counted), gap "
            f"{gap:+.4f} (limit {DRYRUN_MEMORY_GAP}); card {card_ms:.3f} ms (rounds "
            + ", ".join(f"{m:.3f}" for m in ms) + f") against roofline compute "
            f"{row['compute_ms']:.3f} ms, memory {row['memory_ms']:.3f} ms (op-level upper "
            f"{row['memory_upper_ms']:.3f} ms), share {row['roofline_share']:.4f}, dominant "
            f"{row['dominant']}; the dry-run ran {row['dryrun_seconds']:.1f} s on the host; {card}")
        if row["dryrun_flops"] != row["card_flops"]:
            raise AssertionError(f"dryrun ({kind}): FLOPs {row['dryrun_flops']} against the "
                                 f"card's {row['card_flops']}")
        if not abs(gap) <= DRYRUN_MEMORY_GAP:
            raise AssertionError(f"dryrun ({kind}): peak {predicted} against the card's {peak} "
                                 f"(gap {gap:+.4f}, limit {DRYRUN_MEMORY_GAP})")

    # ---- (c) the same programs as DTensors on the card, over an NCCL group of one
    out["dtensor"] = _dryrun_dtensor_leg(dev, card, one_dir)

    # ---- (b) the production meshes, host-only
    for (arch, shapes, mesh_kind, more), proc in production:
        lines = _dryrun_wait(proc, f"{arch} {shapes} {mesh_kind} {' '.join(more)}")
        for shape_name in shapes.split(","):
            rec = _dryrun_record(prod_dir, arch, shape_name, mesh_kind)
            mem, colls = rec["per_device"], rec["collectives"]
            key = f"{arch} x {shape_name} x {mesh_kind}" + (f" {' '.join(more)}" if more else "")
            out["production"][key] = dict(
                flops=mem["flops"], argument_bytes=mem["argument_bytes"],
                peak_bytes=mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"],
                collectives=colls["count_by_type"], collective_bytes=colls["bytes_by_type"],
                dominant=rec["roofline"]["dominant"], repeat_kv=rec["repeat_kv"],
                replicated_views=len(rec["replicated_views"]), seconds=rec["compile_s"])
            log(f"dryrun ({key}, {rec['chips']} ranks): flops/dev {mem['flops']:.4e}, argument "
                f"bytes/dev {mem['argument_bytes']:,}, collectives "
                + json.dumps(colls["count_by_type"]) + f", dominant "
                f"{rec['roofline']['dominant']}, repeat_kv {rec['repeat_kv']}, "
                f"{len(rec['replicated_views'])} replicated views, {rec['compile_s']:.1f} s")
        out["production_lines"] = out.get("production_lines", []) + lines
    out["seconds"] = time.perf_counter() - t0
    return out


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
    from repro_torch.configs import get_config
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
    from repro_torch.launch import serve as launch_serve
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
    # each topk_sim route's first launch in this process, between card
    # syncs: CUDA loads the route's kernels then (the launcher's warm-up
    # makes these launches before it serves)
    if topk_kernel.launched_routes:
        raise AssertionError(f"topk_sim launched before phase 2: {topk_kernel.launched_routes}")
    first_launch_ms, first_gen = {}, torch.Generator(device=dev).manual_seed(1)
    for route, (n_q, n_t, k) in (("cluster", (16, 199, 5)), ("split", (8, 100_000, 5)),
                                 ("wgmma", (16, 100_000, 5)), ("select", (8, 2413, 130))):
        q, t = unit_rows(n_q, 384, first_gen), unit_rows(n_t, 384, first_gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        topk_kernel.topk_sim_cuda(q, t, k, route=route)
        torch.cuda.synchronize()
        first_launch_ms[route] = (time.perf_counter() - t0) * 1e3
    log("build: topk_sim routes' first launch ms (between syncs, the lazy load of their "
        "kernels in it) " + json.dumps({r: round(v, 3) for r, v in first_launch_ms.items()}))

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
                           (8, 25_000, 384, 5),
                           # the learning phase's at 600 tools: one query, a serving
                           # batch, a held-out block padded to 512, the re-ranker's
                           # C = 25; the IVF phase's exact reference tail block
                           (1, 600, 384, 5), (64, 600, 384, 5), (512, 600, 384, 5),
                           (64, 600, 384, 25), (512, 600, 384, 25), (24, 100_000, 384, 5),
                           # the launcher's: a batch of 16 over 100,000 tools and over
                           # the native 199
                           (16, 100_000, 384, 5), (16, 199, 384, 5)]:
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
                           (8, 2413, 1536, 25), (33, 100_003, 384, 130),
                           (64, 100_000, 384, 130), (1, 100_003, 384, 130)]:
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
        flash_checks.append(check_flash_call(name, q, k, v, causal, window, q_offset, route))

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
    # the launcher's prefill, a 32-token prompt: a short causal block for
    # flash and one partial chunk for the scan. The values come from the
    # pool's rescaled weights: the launcher's own init puts |out| near 80
    # (the init fan-in lines above), where bf16's absolute tolerance cannot
    # hold for kernel or plain version
    launch_cap = capture_prefill(pool_cfg, pool_params,
                                 capture_tokens[:, :launch_serve.PROMPT_LEN], {0, last})
    for layer in (0, last):
        (q, k, v), kw = launch_cap["flash"][layer]
        check_flash(f"{pool_cfg.name} launcher prefill layer {layer}", q, k, v, **kw)
        args, _ = launch_cap["ssd"][layer]
        check_ssd(f"{pool_cfg.name} launcher prefill layer {layer}", *args)
    # qwen2.5-3b's, at its own heads: 16 query heads over 2 kv heads, hd 128
    qwen_cfg = get_config("qwen2.5-3b")
    qwen_qkv = (randn(qwen_cfg.n_heads, launch_serve.PROMPT_LEN, qwen_cfg.hd, dtype=torch.bfloat16),
                *(randn(qwen_cfg.n_kv_heads, launch_serve.PROMPT_LEN, qwen_cfg.hd,
                        dtype=torch.bfloat16) for _ in range(2)))
    qwen_kw = dict(causal=True, window=qwen_cfg.sliding_window, q_offset=0)
    check_flash("qwen2.5-3b launcher prefill", *qwen_qkv, **qwen_kw)

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

    # ------------------------------------------------------ 9. learn, 10. ivf
    # the learning plane through fused routers, then IVF beside the fused
    # backend at 100,000 tools; each path's launches are counted from its start
    later_paths = {}
    for path_name, run in (("learn", lambda: learn_phase(dev, card, bench, enc, native)),
                           ("ivf", lambda: ivf_phase(dev, card, bench, enc, big, q_all))):
        for mod in kernel_modules.values():
            mod.launches = 0
        topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
        t_path = time.perf_counter()
        summary_path = run()
        summary_path["seconds"] = time.perf_counter() - t_path
        later_paths[path_name] = dict(summary=summary_path, launches=topk_kernel.launches,
                                routes=dict(topk_kernel.launches_by_route))
        log(f"{path_name} path: {summary_path['seconds']:.1f} s, topk_sim launches "
            f"{topk_kernel.launches}, by route " + json.dumps(later_paths[path_name]["routes"]))
        if topk_kernel.launches == 0 or any(mod.launches for name, mod in kernel_modules.items()
                                            if name != "topk_sim"):
            raise AssertionError(f"the {path_name} path launched topk_sim "
                                 f"{later_paths[path_name]['routes']}")

    # ---------------------------------------------------------------- 11. launch
    # the serve launcher, as a user runs it; this path's launches are the
    # card runs' own (the phase counts them itself)
    ever_launched = set(first_launch_ms) | {c["route"] for c in checks} | {
        r for routes in (serve_routes, pool_topk_routes, pipe_routes, loop_routes,
                         later_paths["learn"]["routes"], later_paths["ivf"]["routes"])
        for r, n in routes.items() if n}
    t_launch = time.perf_counter()
    launch = launch_phase(dev, card, ever_launched, first_launch_ms)
    launch["seconds"] = time.perf_counter() - t_launch
    log(f"launch path: {launch['seconds']:.1f} s, launches " + json.dumps(launch["launches"])
        + ", topk_sim by route " + json.dumps(launch["topk_routes"]) + ", flash by route "
        + json.dumps(launch["flash_routes"]))

    # ------------------------------------------------------------- 12. families
    # the pool's MoE, cross-attention and codebook families at full width;
    # the phase counts its paths' launches itself (batcher, direct, launcher)
    t_families = time.perf_counter()
    families = families_phase(dev, card, gen, check_flash, router, db_native, bench, agree)
    families["seconds"] = time.perf_counter() - t_families
    log(f"families path: {families['seconds']:.1f} s; full-width legs: launches "
        + json.dumps(families["pool"]["launches"]) + ", flash by route "
        + json.dumps(families["pool"]["flash_routes"]) + ", topk_sim by route "
        + json.dumps(families["pool"]["topk_routes"]) + "; the launcher's card runs: launches "
        + json.dumps(families["launch"]["launches"]) + ", flash by route "
        + json.dumps(families["launch"]["flash_routes"]) + ", topk_sim by route "
        + json.dumps(families["launch"]["topk_routes"]))
    if families["pool"]["flash_routes"]["fma"]:
        raise AssertionError("families: a full-width bf16 leg launched the fma route")

    # ---------------------------------------------------------------- 13. train
    # the training path, as a user runs it; no kernel may launch on it
    for mod in kernel_modules.values():
        mod.launches = 0
    t_train = time.perf_counter()
    train = train_phase(dev, card)
    train["seconds"] = time.perf_counter() - t_train
    train["launches"] = {name: mod.launches for name, mod in kernel_modules.items()}
    log(f"train path: {train['seconds']:.1f} s, launches " + json.dumps(train["launches"]))
    if any(train["launches"].values()):
        raise AssertionError(f"the training path launched a kernel: {train['launches']}")

    # ------------------------------------------------- 14. runtime, 15. mesh
    # the runtime checks, then the multi-device runtime; each path's launches
    # are counted from its start (the retrace process and the gloo ranks
    # count their own and report them)
    with tempfile.TemporaryDirectory() as mesh_tmp:
        for mod in kernel_modules.values():
            mod.launches = 0
        topk_kernel.launches_by_route = dict.fromkeys(topk_kernel.ROUTES, 0)
        t_runtime = time.perf_counter()
        runtime = runtime_phase(dev, card, big, native, mesh_tmp)
        runtime["seconds"] = time.perf_counter() - t_runtime
        runtime["launches"] = {name: mod.launches for name, mod in kernel_modules.items()}
        runtime["routes"] = dict(topk_kernel.launches_by_route)
        log(f"runtime path: {runtime['seconds']:.1f} s, launches "
            + json.dumps(runtime["launches"]) + ", topk_sim by route "
            + json.dumps(runtime["routes"]) + "; the retrace process's "
            + json.dumps(runtime["retrace"]["routes"]))
        if not runtime["launches"]["topk_sim"] or any(
                n for name, n in runtime["launches"].items() if name != "topk_sim"):
            raise AssertionError(f"the runtime path launched {runtime['launches']}")
        for mod in kernel_modules.values():
            mod.launches = 0
        t_mesh = time.perf_counter()
        mesh = mesh_phase(dev, card, bench, native, q_all, mesh_tmp)
        mesh["seconds"] = time.perf_counter() - t_mesh
        mesh["launches"] = {name: mod.launches for name, mod in kernel_modules.items()}
    log(f"mesh path: {mesh['seconds']:.1f} s, launches " + json.dumps(mesh["launches"])
        + "; the gloo ranks' " + json.dumps(mesh["gloo_launches"]))
    if mesh["launches"]["topk_sim"] or mesh["launches"]["ssd_scan"]:
        raise AssertionError(f"the mesh path launched {mesh['launches']}")
    # the kernel against its plain version at the mesh path's own prefill
    # inputs (layer 0 and the last of each model), now that its launches are
    # read; the gloo ranks checked theirs the same way
    for name, args, kw in mesh.pop("flash_calls"):
        check_flash(name, *args, **kw)
    flash_checks.extend(mesh["gloo_flash_checks"])
    log("mesh: flash checks on the gloo ranks: " + json.dumps(
        [{k: c[k] for k in ("case", "max_abs_err", "atol", "rel_norm")}
         for c in mesh["gloo_flash_checks"]]))

    # -------------------------------------------------------------- 16. dryrun
    # the dry-run's predictions against the card; no kernel may launch
    for mod in kernel_modules.values():
        mod.launches = 0
    with tempfile.TemporaryDirectory() as dryrun_tmp:
        dryrun = dryrun_phase(dev, card, dryrun_tmp)
    dryrun["launches"] = {name: mod.launches for name, mod in kernel_modules.items()}
    log(f"dryrun path: {dryrun['seconds']:.1f} s, launches " + json.dumps(dryrun["launches"]))
    if any(dryrun["launches"].values()):
        raise AssertionError(f"the dry-run path launched a kernel: {dryrun['launches']}")

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

    # the select route at three shapes, each in rounds in turns with
    # torch.topk(q @ t.T, k): the re-ranker's C = 5 x 26 = 130 candidates for
    # a batch of 64 over the native 2,413 tools and over the 100,000-tool
    # table, and k = 25 over a 1,536-wide table (seeded unit rows, D > 1,024);
    # each pass alone, launched back to back through the library as
    # `select_plan` sizes it (CUDA events; this process's profiler records
    # no select kernel by now), beside its own bound: pass 1 reads q and t
    # once, writes the [Q, T] scores and does 2QTD float32 FLOPs; pass 2
    # reads the scores and writes the k pairs
    wide = torch.Generator(device=dev).manual_seed(24)
    rerank_q = torch.from_numpy(q_all[:64]).to(dev)
    sel_lib = topk_kernel.LIBRARY.load()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def select_pass_ms(q, table, k):
        """CUDA-event ms a launch of each select pass alone."""
        n_q, (n_t, d) = q.shape[0], table.shape
        plan = topk_kernel.select_plan(n_q, n_t, d, k, n_sms)
        sims = torch.empty((n_q, n_t), device=dev)
        out_s = torch.empty((n_q, k), device=dev)
        out_i = torch.empty((n_q, k), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def pass1():
            topk_kernel.LIBRARY.check(sel_lib.topk_sim_select_scores_launch(
                q.device.index, plan.bq, plan.br, plan.stages, q.data_ptr(), table.data_ptr(),
                n_q, n_t, d, sims.data_ptr(), stream), "topk_sim_select_scores")

        def pass2():
            topk_kernel.LIBRARY.check(sel_lib.topk_sim_select_topk_launch(
                q.device.index, plan.threads, plan.cs, plan.cap, sims.data_ptr(), n_q, n_t, k,
                topk_kernel.select_sort_len(k), sims.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), stream), "topk_sim_select_topk")

        if k > topk_kernel.SEL_SMEM_KEYS:
            raise AssertionError("select_pass_ms times only sorts in shared memory")
        return plan, {"topk_sim_select_scores": cuda_ms(pass1, iters=100),
                      "topk_sim_select_topk": cuda_ms(pass2, iters=100)}

    select_times = []
    for q, table, k in [(rerank_q, table_native, 5 * RERANK_K), (rerank_q, table_big, 5 * RERANK_K),
                        (unit_rows(8, 1536, wide), unit_rows(table_native.shape[0], 1536, wide), 25)]:
        n_q, (n_t, d) = q.shape[0], table.shape
        if topk_kernel.topk_route(n_q, n_t, d, k, table, q) != "select":
            raise AssertionError(f"Q={n_q} T={n_t} D={d} k={k} must take the select route")
        call = functools.partial(topk_kernel.topk_sim_cuda, q, table, k)
        rounds = alternating({"kernel": call,
                              "library": lambda q=q, table=table, k=k: torch.topk(q @ table.T, k)})
        plain = cuda_ms(functools.partial(topk_sim_ref, q, table, k))
        bound_ms, bound_by = topk_bound(n_q, n_t, d, k)["cuda_cores"]
        plan, passes = select_pass_ms(q, table, k)
        pass_bounds = {
            "topk_sim_select_scores": bound(4 * (n_q * d + n_t * d + n_q * n_t),
                                            2 * n_q * n_t * d, PEAK_F32_FLOP_PER_S),
            "topk_sim_select_topk": bound(4 * n_q * n_t + 12 * n_q * k, 0, PEAK_F32_FLOP_PER_S)}
        row = dict(shape=[n_q, n_t, d, k], ms=float(np.median(rounds["kernel"])),
                   library_ms=float(np.median(rounds["library"])), plain_ms=plain,
                   bound_ms=bound_ms, bound_by=bound_by, rounds_ms=rounds, pass_ms=passes,
                   pass_bounds=pass_bounds, plan=plan._asdict())
        select_times.append(row)
        log(f"time topk_sim Q={n_q} T={n_t} D={d} k={k} (select): kernel median "
            f"{row['ms']:.4f} ms (rounds " + ", ".join(f"{t:.4f}" for t in rounds["kernel"])
            + f"), torch.topk(q@t.T) median {row['library_ms']:.4f} ms (rounds "
            + ", ".join(f"{t:.4f}" for t in rounds["library"]) + f"); plain {plain:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}); CUDA-event ms a launch of each pass alone "
            + json.dumps({name: round(v, 4) for name, v in passes.items()}) + "; pass bounds "
            + json.dumps({name: [round(b[0], 4), b[1]] for name, b in pass_bounds.items()})
            + f"; plan {json.dumps(plan._asdict())} on {card}")
    sel = select_times[0]

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

    # the launcher's shapes: topk_sim at batch 16 over 100,000 and 199 tools
    # (medians of rounds in turns with the library call), flash at hymba's
    # and qwen2.5-3b's 32-token prefill, the scan at hymba's
    launch_times = {"topk_sim": [], "flash_attention": [], "ssd_scan": []}
    q16 = torch.from_numpy(q_all[:16]).to(dev)
    for table in (table_big, table_big[:199]):
        n_t, d = table.shape
        route = topk_kernel.topk_route(16, n_t, d, 5, table, q16)
        rounds = alternating({"kernel": lambda t=table: topk_kernel.topk_sim_cuda(q16, t, 5),
                              "library": lambda t=table: torch.topk(q16 @ t.T, 5)})
        topk_kernel.reset_rescored()
        topk_kernel.topk_sim_cuda(q16, table, 5)
        resc = topk_kernel.rescored() if route == "wgmma" else 0
        bound_ms, bound_by = topk_bound(16, n_t, d, 5, rescored=resc)[
            "tensor_cores" if route == "wgmma" else "cuda_cores"]
        row = dict(shape=[16, n_t, d, 5], route=route, ms=float(np.median(rounds["kernel"])),
                   plain_ms=cuda_ms(lambda t=table: topk_sim_ref(q16, t, 5)),
                   library_ms=float(np.median(rounds["library"])), bound_ms=bound_ms,
                   bound_by=bound_by, rescored_per_call=resc, rounds_ms=rounds)
        launch_times["topk_sim"].append(row)
        log(f"time topk_sim launcher Q=16 T={n_t} k=5 ({route}): kernel median {row['ms']:.4f} "
            f"ms, torch.topk(q@t.T) {row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
            f"{bound_ms:.4f} ({bound_by}) on {card}")
    for arch, (lq, lk, lv), lkw in (("hymba-1.5b", *launch_cap["flash"][0]),
                                    ("qwen2.5-3b", qwen_qkv, qwen_kw)):
        lg = lq.shape[0] // lk.shape[0]
        lq4 = lq.view(1, *lq.shape)
        lk4, lv4 = (t.repeat_interleave(lg, dim=0).view(lq4.shape) for t in (lk, lv))
        lmask = attention_mask(lq.shape[1], lk.shape[1], True, lkw["window"], 0, dev)
        b_ms, b_by = flash_bound(lq, lk, lv, True, lkw["window"], 0)
        row = dict(model=arch, shape=dict(bh=lq.shape[0], bhkv=lk.shape[0], s=lq.shape[1],
                                          hd=lq.shape[2], window=lkw["window"],
                                          dtype=str(lq.dtype)),
                   route=flash_kernel.flash_route(lq.dtype, lq.shape[2], lq, lk, lv),
                   ms=cuda_ms(lambda: flash_kernel.flash_attention_cuda(lq, lk, lv, **lkw),
                              iters=100),
                   plain_ms=cuda_ms(lambda: attention_ref(lq, lk, lv, **lkw)),
                   library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                       lq4, lk4, lv4, attn_mask=lmask), iters=100),
                   bound_ms=b_ms, bound_by=b_by)
        launch_times["flash_attention"].append(row)
        log(f"time flash_attention launcher {arch} q{list(lq.shape)} kv{list(lk.shape)} "
            f"({row['route']}): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, SDPA "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}) on {card}")
    l_args, _ = launch_cap["ssd"][0]
    l_ctx = ssd_kernel.prepare(*l_args)
    lb_ms, lb_by = ssd_bound(*l_args[:5])
    row = dict(model="hymba-1.5b", shape=dict(x=list(l_args[0].shape), n=l_args[3].shape[3],
                                              chunk=l_args[5], dtype=str(l_args[0].dtype)),
               ms=cuda_ms(lambda: [ssd_kernel.launch_phase(l_ctx, ph) for ph in ssd_kernel.PHASES],
                          iters=100),
               call_ms=cuda_ms(lambda: ssd_kernel.ssd_scan_cuda(*l_args), iters=100),
               plain_ms=cuda_ms(lambda: ssd_scan_ref(*l_args)), library_ms=None,
               bound_ms=lb_ms, bound_by=lb_by)
    launch_times["ssd_scan"].append(row)
    log(f"time ssd_scan launcher hymba-1.5b x{row['shape']['x']}: kernels {row['ms']:.4f} ms "
        f"(a whole call {row['call_ms']:.4f}), plain {row['plain_ms']:.4f}, bound {lb_ms:.4f} "
        f"({lb_by}) on {card}")

    kernels = [dict(
        name="topk_sim", route="cuda", source="src/repro_torch/kernels/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:89",
        launches=(main_launches + pool_launches["topk_sim"] + pipe_launches + loop_launches
                  + later_paths["learn"]["launches"] + later_paths["ivf"]["launches"]
                  + launch["launches"]["topk_sim"] + families["pool"]["launches"]["topk"]
                  + families["launch"]["launches"]["topk"] + train["launches"]["topk_sim"]
                  + runtime["launches"]["topk_sim"] + runtime["retrace"]["launches"]),
        max_abs_err=max_err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
        bound_cuda_cores_ms=head["bound_cuda_cores_ms"],
        bound_tensor_cores_ms=head["bound_tensor_cores_ms"],
        shape=head["shape"], route_of_shape=head["route"], shapes=shapes, checks=checks,
        index_agreement="exact except reordering inside near-ties (rows counted in checks); "
                        "the wgmma route bitwise equal to the split route",
        launches_by_path={"serve": main_launches, "pool": pool_launches["topk_sim"],
                          "pipeline": pipe_launches, "loop": loop_launches,
                          "learn": later_paths["learn"]["launches"],
                          "ivf": later_paths["ivf"]["launches"],
                          "launch": launch["launches"]["topk_sim"],
                          "families": families["pool"]["launches"]["topk"],
                          "families_launch": families["launch"]["launches"]["topk"],
                          "train": train["launches"]["topk_sim"],
                          "runtime": runtime["launches"]["topk_sim"],
                          "retrace": runtime["retrace"]["launches"],
                          "mesh": mesh["launches"]["topk_sim"],
                          "dryrun": dryrun["launches"]["topk_sim"]},
        launches_by_route={"serve": serve_routes, "pool": pool_topk_routes,
                           "pipeline": pipe_routes, "loop": loop_routes,
                           "learn": later_paths["learn"]["routes"],
                           "ivf": later_paths["ivf"]["routes"],
                           "launch": launch["topk_routes"],
                           "families": families["pool"]["topk_routes"],
                           "families_launch": families["launch"]["topk_routes"],
                           "runtime": runtime["routes"], "retrace": runtime["retrace"]["routes"]},
        rescored={"serve": serve_rescored}, launch_shapes=launch_times["topk_sim"],
        crossover=crossover, host_vs_device=host_split,
    ), dict(
        name="topk_sim (select route)", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_sim.cu",
        replaces="src/repro/kernels/topk_sim/kernel.py:89", launches=pipe_routes["select"],
        launches_by_path={"pipeline": pipe_routes["select"], "train": train["launches"]["topk_sim"],
                          "dryrun": dryrun["launches"]["topk_sim"]},
        max_abs_err=max(c["max_abs_err"] for c in checks if c["route"] == "select"),
        ms=sel["ms"], plain_ms=sel["plain_ms"], bound_ms=sel["bound_ms"],
        bound_by=sel["bound_by"], library_ms=sel["library_ms"], shape=sel["shape"],
        rounds_ms=sel["rounds_ms"], pass_ms=sel["pass_ms"],
        shapes=select_times, library="torch.topk(q @ t.T, k)",
        launches_path="pipeline: the S2 re-ranker at k = 26 over the refined table",
    ), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:112",
        launches=(pool_launches["flash_attention"] + launch["launches"]["flash_attention"]
                  + families["pool"]["launches"]["flash"]
                  + families["launch"]["launches"]["flash"]
                  + train["launches"]["flash_attention"] + mesh["launches"]["flash_attention"]
                  + mesh["gloo_launches"]["flash_attention"]),
        launches_by_path={"pool": pool_launches["flash_attention"],
                          "launch": launch["launches"]["flash_attention"],
                          "families": families["pool"]["launches"]["flash"],
                          "families_launch": families["launch"]["launches"]["flash"],
                          "train": train["launches"]["flash_attention"],
                          "runtime": runtime["launches"]["flash_attention"],
                          "mesh": mesh["launches"]["flash_attention"],
                          "mesh_gloo": mesh["gloo_launches"]["flash_attention"],
                          "dryrun": dryrun["launches"]["flash_attention"]},
        max_abs_err=max(c["max_abs_err"] for c in flash_checks), ms=f_ms, plain_ms=f_plain,
        bound_ms=f_bound, bound_by=f_by, library_ms=f_lib,
        shape=dict(bh=q.shape[0], bhkv=k.shape[0], s=q.shape[1], hd=q.shape[2],
                   window=kw["window"], dtype=str(q.dtype)),
        library="scaled_dot_product_attention with the same boolean mask, kv repeated",
        ms_by_route=f_ms_by_route,
        launches_by_route={"pool": pool_flash_routes, "launch": launch["flash_routes"],
                           "families": families["pool"]["flash_routes"],
                           "families_launch": families["launch"]["flash_routes"]},
        launch_shapes=launch_times["flash_attention"], cross_shapes=families["cross_shapes"],
        checks=flash_checks,
    ), dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:102",
        launches=(pool_launches["ssd_scan"] + launch["launches"]["ssd_scan"]
                  + train["launches"]["ssd_scan"]),
        launches_by_path={"pool": pool_launches["ssd_scan"], "launch": launch["launches"]["ssd_scan"],
                          "families": 0, "families_launch": 0,
                          "train": train["launches"]["ssd_scan"],
                          "runtime": runtime["launches"]["ssd_scan"],
                          "mesh": mesh["launches"]["ssd_scan"], "mesh_gloo": 0,
                          "dryrun": dryrun["launches"]["ssd_scan"]},
        max_abs_err=max(max(c["max_abs_err_y"], c["max_abs_err_state"]) for c in ssd_checks),
        ms=s_ms, plain_ms=s_plain, bound_ms=s_bound, bound_by=s_by, library_ms=None,
        shape=dict(x=list(x0.shape), g=ssd_args[3].shape[2], n=ssd_args[3].shape[3],
                   chunk=ssd_args[5], dtype=str(x0.dtype)),
        tile=ssd_kernel.TILE, call_ms=s_call_ms, device_ms=s_device_ms,
        device_ms_by_phase=s_phase_ms, launch_shapes=launch_times["ssd_scan"],
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
                   loop=loop, learn=later_paths["learn"]["summary"],
                   ivf=later_paths["ivf"]["summary"], launch=launch,
                   families={k: v for k, v in families.items() if k != "cross_shapes"},
                   train=train, runtime=runtime, mesh=mesh, dryrun=dryrun)
    log("summary " + json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        import argparse

        ap = argparse.ArgumentParser(description="One gloo rank of phase 15 (b).")
        ap.add_argument("--mesh-worker", type=int, required=True, dest="rank")
        ap.add_argument("--port", type=int, required=True)
        ap.add_argument("--dir", required=True)
        args = ap.parse_args()
        sys.exit(mesh_worker(args.rank, args.port, args.dir))
    sys.exit(main())
