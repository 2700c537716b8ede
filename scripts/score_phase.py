#!/usr/bin/env python3
"""Time the router's score phase over 100,000 tools on one NVIDIA card, for
the tree whose `src/` is given, so that two commits can be compared in turns.

    python3 scripts/score_phase.py [--src DIR] [--passes 10] [--against-split]

It builds the serving corpus as chip_smoke.py does (the ToolBench-like set,
`make_toolbench_like(seed=0)`, scaled to 100,000 rows by
`scale_tool_corpus`) and, for each batch size (64 and 8), a `SemanticRouter`
on the fused backend, warmed by one batch. Its `MetricsRegistry` holds
`route_phase_ms{score}` at 1,000 buckets a decade (the default's 10 are
26% wide), so a pass's p50 is read to 0.3% from the bucket counts the pass
added (the warm-up batch is not counted). Each pass routes the 600 queries
in batches. With `--against-split` (a tree whose `topk_route` has the wgmma
route) each pass runs twice, in turns, the side that goes first
alternating: on `topk_route`'s choice ("chosen") and with every wgmma-route
call sent to the split route instead ("split"), which is what a tree
without the wgmma route runs at these batch sizes. It prints one JSON line
a batch size and mode: the per-pass p50s of the score phase and of the
batch's host clock, their median, the distance between their quartiles,
and the `topk_sim` launches by route; with `--against-split` also how many
pairs "chosen" won. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BATCH_SIZES = (64, 8)
N_TOOLS = 100_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"))
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--against-split", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("score_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.data.benchmarks import make_toolbench_like, scale_tool_corpus
    from repro_torch.embedding.bag_encoder import BagEncoder
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.router.gateway import SemanticRouter
    from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    topk_kernel.LIBRARY.load()
    bench = make_toolbench_like(seed=0)
    enc = BagEncoder(bench.vocab, device=dev)
    big = scale_tool_corpus(enc.encode(bench.desc_tokens), N_TOOLS, seed=0)
    db = ToolsDatabase([ToolRecord(i, f"tool_{i}", bench.desc_tokens[i % bench.n_tools],
                                   int(bench.tool_category[i % bench.n_tools]))
                        for i in range(N_TOOLS)], big)
    chosen = topk_kernel.topk_route

    def split_only(n_q, n_t, d, k, table, queries=None):
        route = chosen(n_q, n_t, d, k, table, queries)
        return "split" if route == "wgmma" else route

    modes = ("chosen", "split") if args.against_split else ("chosen",)
    edges = np.geomspace(1e-3, 1e4, 7001)  # 1,000 buckets a decade, in ms
    cells = {}
    for mode in modes:
        for bs in BATCH_SIZES:
            topk_kernel.topk_route = chosen if mode == "chosen" else split_only
            reg = MetricsRegistry()
            hist = reg.histogram("route_phase_ms", edges=edges, phase="score")
            r = SemanticRouter(db, embed_fn=enc.encode_one, embed_batch_fn=enc.encode, k=5,
                               backend="fused", metrics=reg, device=dev)
            if not r.index.wait_ready():
                raise RuntimeError("fused index never became fresh")
            r.route_batch(bench.query_tokens[:bs])  # warm-up
            cells[mode, bs] = dict(router=r, hist=hist, score=[], batch=[],
                                   launches=dict.fromkeys(topk_kernel.ROUTES, 0))
    for p in range(args.passes):
        for mode in (modes if p % 2 == 0 else modes[::-1]):
            topk_kernel.topk_route = chosen if mode == "chosen" else split_only
            for bs in BATCH_SIZES:
                cell = cells[mode, bs]
                before = dict(topk_kernel.launches_by_route)
                counts = cell["hist"].bucket_counts()
                ms = []
                for s in range(0, bench.n_queries, bs):
                    t = time.perf_counter()
                    cell["router"].route_batch(bench.query_tokens[s:s + bs])
                    ms.append((time.perf_counter() - t) * 1e3)
                cum = np.cumsum(cell["hist"].bucket_counts() - counts)
                cell["score"].append(float(edges[np.searchsorted(cum, cum[-1] / 2)]))
                cell["batch"].append(float(np.percentile(ms, 50)))
                for k, v in topk_kernel.launches_by_route.items():
                    cell["launches"][k] += v - before[k]
    for (mode, bs), cell in cells.items():
        r = cell["router"]
        if r.index.last_path() != "index:fused":
            raise RuntimeError(f"served by {r.index.last_path()}")
        r.close()
        row = dict(src=args.src, mode=mode, batch=bs, passes=args.passes,
                   launches_by_route=cell["launches"])
        for name in ("score", "batch"):
            x = np.array(cell[name])
            q1, q2, q3 = np.percentile(x, [25, 50, 75])
            row.update({f"{name}_p50_ms": cell[name], f"{name}_median_ms": float(q2),
                        f"{name}_iqr_ms": float(q3 - q1)})
        if mode == "chosen" and args.against_split:
            row["score_pairs_won"] = int(sum(
                a < b for a, b in zip(cell["score"], cells["split", bs]["score"])))
        print(json.dumps(row), flush=True)
    topk_kernel.topk_route = chosen
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
