"""Multi-pod dry-run: run every (architecture x input shape) program on fake
tensors over the production meshes, and record memory, cost and collective
analysis per device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

Counterpart of `repro/launch/dryrun.py`. The reference forces 512 host
devices, lets GSPMD partition each program and compiles it; the port lays
the mesh over a fake process group of 256 or 512 ranks (`launch/mesh.py`),
builds params, optimizer state, inputs and caches as fake DTensors of rank
0's blocks (`launch/specs.py`, `state_specs.py`, `models/params.py`), and
runs the program eagerly on them under DTensor's partitioner: nothing is
allocated and no collective moves data. Programs run `use_kernel=False`
(fake tensors have no data for a kernel to read), as the reference lowers
the plain `gqa_attention` and `ssd_chunked`.

Each run writes experiments/dryrun_torch/<arch>__<shape>__<mesh>.json with
the reference's keys:
  * per-device memory: argument / output / temp bytes from the run's live
    storages (`common.meshctx.CostMode`): argument + temp + output is the
    peak a device holds;
  * FLOPs and bytes accessed per device (`cost_analysis_dict`'s counts;
    eager torch runs every layer, so `hlo_raw` is the direct count and
    `probe` checks that the reference's two-depth extrapolation equals it);
  * the collectives rank 0 issued (`hlo_analysis.collectives_from_trace`);
  * the three roofline terms at the card's constants (`hlo_analysis.HW`)
    and the dominant one;
  * `lower_s`: seconds to build the structs; `compile_s`: seconds of the
    fake run; `total_s`: the cell's seconds, probes included;
  * `replicated_views`: the views DTensor could not split, run replicated.

Where the heads shard more ways than the KV heads (qwen2.5-3b's 2 KV heads
over "model" = 16), a DTensor cannot view the sharded heads as [Hkv, g];
the run then takes the reference's `repeat_kv` form, which shards the
attention over the q heads as GSPMD does without a collective, and the
record's `repeat_kv` says so.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from fractions import Fraction

import torch

from repro_torch.common import meshctx
from repro_torch.common.meshctx import CostMode
from repro_torch.common.sharding import fake_mode, set_policy, spec_for
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch.hbm_model import analytic_hbm_bytes
from repro_torch.launch.hlo_analysis import HW, collectives_from_trace, roofline_terms
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.launch.specs import SHAPES, ShapeCase, cache_structs, input_specs, variant_for_shape
from repro_torch.launch.state_specs import opt_state_structs
from repro_torch.models import model as M
from repro_torch.models.params import param_structs
from repro_torch.models.quant import dequantize_tree, quantized_structs
from repro_torch.training.train_step import ADAFACTOR_THRESHOLD, TrainConfig, make_train_step

__all__ = ["build_program", "run_program", "needs_repeat_kv", "probe_corrected_costs",
           "run_one", "main"]


def _mesh(kind: str):
    """The mesh of `--mesh`: 16x16 "single", 2x16x16 "multi", or "1x1", the
    (1, 1) mesh over a fake group: the DTensor program at world size 1,
    held against one card. (`mesh=None` elsewhere in this module runs the
    unpartitioned program on plain fake tensors.)"""
    if kind == "1x1":
        return make_fake_mesh((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=kind == "multi")


def _optimizer_name(cfg, tc: TrainConfig) -> str:
    if tc.optimizer != "auto":
        return tc.optimizer
    return "adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD else "adamw"


def needs_repeat_kv(cfg, mesh) -> bool:
    """Whether the q heads shard over more ranks than the KV heads divide,
    which the grouped [Hkv, g] view cannot take on a DTensor."""
    if mesh is None or cfg.is_attention_free or cfg.q_groups == 1:
        return False
    sizes = meshctx.axis_sizes_dict(mesh)
    entry = spec_for(("heads",), mesh.axis_names, (cfg.n_heads,), sizes)[0]
    if entry is None:
        return False
    shards = mesh.axes_size((entry,) if isinstance(entry, str) else entry)
    return cfg.n_kv_heads % shards != 0


def build_program(cfg, shape: ShapeCase, mesh, tc: TrainConfig, quantize: bool = False,
                  remat: bool = True):
    """Returns (fn, arg structs tuple) for the shape's program kind.

    `quantize=True` (inference only): the program takes int8 weights and
    dequantizes them at its boundary (see models/quant.py). `remat` sets the
    train step's activation checkpointing (the reference's dry-run always
    remats; phase 13 of chip_smoke.py trains without). The decode program
    writes the token at the cache's last slot (`pos` = seq_len - 1): the
    port's decode takes `pos` as a Python int, and every slot is attended.
    """
    specs = M.make_specs(cfg)
    dtype = getattr(torch, cfg.dtype)
    if quantize and shape.kind != "train":
        pstructs = quantized_structs(specs, mesh=mesh, dtype=dtype)

        def deq(qp):
            return dequantize_tree(qp, dtype)
    else:
        pstructs = param_structs(specs, dtype=dtype, mesh=mesh,
                                 requires_grad=shape.kind == "train")

        def deq(p):
            return p
    batch = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=remat)
        step_fn, _ = make_train_step(cfg, tc)
        ostructs = opt_state_structs(_optimizer_name(cfg, tc), specs, mesh)
        return step_fn, (pstructs, ostructs, batch)
    if shape.kind == "prefill":
        def prefill(p, b):
            return M.prefill(cfg, deq(p), b, max_cache_len=shape.seq_len, use_kernel=False)
        return prefill, (pstructs, batch)
    cache = cache_structs(cfg, shape, mesh)
    pos = shape.seq_len - 1

    def decode(p, c, b):
        return M.decode_step(cfg, deq(p), c, {"token": b["token"], "pos": pos},
                             use_kernel=False)
    return decode, (pstructs, cache, batch)


@contextlib.contextmanager
def _strided_index_math_on_host(cost: CostMode):
    """DTensor computes a strided shard's rows with small index tensors;
    under the fake mode each would become a fake tensor of symbolic sizes
    (seconds per call at 32k rows). They run as plain host tensors here, and
    are not counted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    index_math = _StridedShard.local_shard_size_and_offset

    def on_host(*args, **kwargs):
        with unset_fake_temporarily(), cost.muted():
            return index_math(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = index_math


@contextlib.contextmanager
def _views_replicate_what_they_cannot_split(points: set):
    """DTensor's `view` raises where a dimension sharded m ways is split
    into sizes whose first m does not divide (qwen2.5-3b's 2 KV heads of a
    projection DTensor sharded 16 ways, or hymba-1.5b's 50 SSM heads in a
    gradient); GSPMD splits the shards over both sizes instead. For the
    run, every view takes DTensor's lenient rule, which redistributes such
    a dimension to Replicate() (an all-gather the collectives count); each
    point is added to `points` as (global shape, placements before, after)
    and goes into the record. On a mesh of one rank torch 2.11 hands some
    views a single Replicate() for all the mesh's axes, and its own check
    refuses that: such a view gets one Replicate() an axis."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._ops import _view_ops

    propagate = _view_ops.propagate_shape_and_sharding

    def lenient(src, shape, rule, mesh_sizes, strict_view=False):
        if len(src) < len(mesh_sizes) and all(n == 1 for n in mesh_sizes):
            src = (Replicate(),) * len(mesh_sizes)
        tgt, out = propagate(src, shape, rule, mesh_sizes, False)
        if tuple(tgt) != tuple(src):
            points.add((tuple(shape), tuple(map(str, src)), tuple(map(str, tgt))))
        return tgt, out

    _view_ops.propagate_shape_and_sharding = lenient
    try:
        yield
    finally:
        _view_ops.propagate_shape_and_sharding = propagate


_PLAN = {}  # the memoized redistribution planner, made once


@contextlib.contextmanager
def _redistribution_plans_memoized():
    """DTensor memoizes its redistribution plans, except while it believes
    it is being traced, which a fake mode makes it believe: then every
    candidate strategy of every op re-runs the planner's search, minutes
    per program on the 3-axis mesh. The plans depend only on the two specs
    (static shapes here), so the run memoizes them itself."""
    import functools

    from torch.distributed.tensor import _redistribute

    plan = _redistribute._gen_transform_infos_non_cached
    if "memo" not in _PLAN or _PLAN["group"] is not torch.distributed.group.WORLD:
        _PLAN.update(group=torch.distributed.group.WORLD, memo=functools.cache(plan))
    _redistribute._gen_transform_infos_non_cached = _PLAN["memo"]
    try:
        yield
    finally:
        _redistribute._gen_transform_infos_non_cached = plan


def run_program(fn, args, mesh, fake: bool = True):
    """Run `fn(*args)` on its structs under the mesh (`mesh=None`: plain
    tensors, no mesh); returns (cost mode, collective stats, memory dict,
    seconds). `fake=False` runs it on real tensors of the same layout
    instead (the tests' check that the fake run counts what a real one
    does)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cost = CostMode(track_memory=True)
    argument = cost.watch(args)
    cost.replicated_views = set()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if fake:
            stack.enter_context(fake_mode())
        if mesh is not None:  # DTensor's partitioner, as the run needs it
            stack.enter_context(meshctx.use_mesh(mesh))
            stack.enter_context(implicit_replication())
            stack.enter_context(_strided_index_math_on_host(cost))
            stack.enter_context(_redistribution_plans_memoized())
            stack.enter_context(_views_replicate_what_they_cannot_split(cost.replicated_views))
        colls = stack.enter_context(collectives_from_trace(cost))
        stack.enter_context(cost)
        out = fn(*args)
    seconds = time.time() - t0
    output = cost.new_bytes(out)
    alias = _alias_bytes(args, out)
    mem = {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": cost.peak_bytes - output,
        "alias_bytes": alias,
    }
    return cost, colls, mem, seconds


def _alias_bytes(args, out) -> int:
    """Bytes of the outputs that are arguments' storages (a decode cache
    written in place), each storage once."""
    from repro_torch.common.meshctx import _tensors

    arg_ids = {id(CostMode._storage(t)) for t in _tensors(args)}
    seen, total = set(), 0
    for t in _tensors(out):
        st = CostMode._storage(t)
        if id(st) in arg_ids and id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _measure(cfg, shape, mesh, tc, quantize=False, remat=True):
    """Run and return (flops, bytes, wire_bytes) per device for cfg."""
    fn, args = build_program(cfg, shape, mesh, tc, quantize, remat)
    cost, colls, _, _ = run_program(fn, args, mesh)
    return float(cost.flops), float(cost.bytes_accessed), float(colls.wire_bytes)


def _probe_depths(cfg) -> tuple:
    """Two shallow depths for the cost probes (VLM keeps its 4+1 groups)."""
    if cfg.cross_attn_every:
        return cfg.cross_attn_every, 2 * cfg.cross_attn_every
    return 2, 4


def probe_corrected_costs(cfg, shape, mesh, tc, quantize=False, remat=True):
    """The reference's two-depth extrapolation, metric(L) = intercept +
    slope * L, from runs at two shallow depths. The reference needs it
    because XLA counts a scanned body once; eager torch counts every layer,
    so here it is a check: for a model linear in depth it equals the
    direct count."""
    l1, l2 = _probe_depths(cfg)
    m1 = _measure(dataclasses.replace(cfg, n_layers=l1), shape, mesh, tc, quantize, remat)
    m2 = _measure(dataclasses.replace(cfg, n_layers=l2), shape, mesh, tc, quantize, remat)
    out = []
    for a, b in zip(m1, m2):  # in exact fractions: a count linear in depth comes out whole
        a, b = Fraction(a), Fraction(b)
        out.append(max(float(a + (b - a) / (l2 - l1) * (cfg.n_layers - l1)), 0.0))
    return {"flops": out[0], "bytes_accessed": out[1], "wire_bytes": out[2],
            "probe_depths": [l1, l2]}


def resolve_shape(name: str, seq_len: int = 0, global_batch: int = 0) -> ShapeCase:
    """SHAPES[name], with its sequence length and batch replaced where given
    (the name then records them: prefill_32k@1x2048)."""
    shape = SHAPES[name]
    if seq_len or global_batch:
        b, s = global_batch or shape.global_batch, seq_len or shape.seq_len
        shape = ShapeCase(f"{name}@{b}x{s}", s, b, shape.kind)
    return shape


def run_one(
    arch: str, shape_name: str, mesh_kind: str, tc: TrainConfig, out_dir: str,
    probe: bool = True, policy: str = "tp", moe_impl: str = "gspmd",
    repeat_kv: bool = False, decode_attn: str = "gspmd", quantize: bool = False,
    tag: str = "", seq_len: int = 0, global_batch: int = 0, remat: bool = True,
):
    shape = resolve_shape(shape_name, seq_len, global_batch)
    cfg = variant_for_shape(get_config(arch), SHAPES[shape_name])
    if moe_impl != "gspmd":
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if decode_attn != "gspmd":
        cfg = dataclasses.replace(cfg, decode_attn=decode_attn)
    set_policy(policy)
    mesh = _mesh(mesh_kind)
    if repeat_kv or needs_repeat_kv(cfg, mesh):
        cfg = dataclasses.replace(cfg, repeat_kv=True)
    t0 = time.time()
    t_start = t0
    fn, args = build_program(cfg, shape, mesh, tc, quantize, remat)
    t_lower = time.time() - t0
    cost, colls, mem, t_run = run_program(fn, args, mesh)
    del fn, args
    flops, bytes_acc, wire = float(cost.flops), float(cost.bytes_accessed), colls.wire_bytes
    corrected = None
    if probe:
        corrected = probe_corrected_costs(cfg, shape, mesh, tc, quantize, remat)
        corrected["flops_matches_direct"] = corrected["flops"] == flops

    # memory term: analytic HBM floor (the op-level "bytes accessed" is
    # fusion-naive and recorded separately as the upper bound)
    model_shards = mesh.shape.get("model", 1) if mesh is not None else 1
    chips = mesh.device_mesh.size() if mesh is not None else 1
    traffic = analytic_hbm_bytes(
        cfg, shape.kind, shape.global_batch, shape.seq_len, chips, model_shards,
        _optimizer_name(cfg, tc),
        weight_bytes=(1.07 if quantize and shape.kind != "train" else 2.0),
    )
    terms = roofline_terms(flops, traffic["total"], wire)
    terms["memory_upper_s"] = bytes_acc / HW["hbm_bw"]

    n = cfg.param_count()
    # MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for inference tokens
    factor = 6 if shape.kind == "train" else 2
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = factor * cfg.active_param_count() * d_tokens
    record = {
        "arch": arch,
        "variant": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_kind,
        "policy": policy,
        "moe_impl": moe_impl,
        "repeat_kv": cfg.repeat_kv,
        "decode_attn": decode_attn,
        "quantize": quantize,
        "remat": remat if shape.kind == "train" else None,
        "chips": chips,
        "params": n,
        "active_params": cfg.active_param_count(),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "total_s": round(time.time() - t_start, 2),  # with the probes
        "per_device": {"flops": flops, "bytes_accessed": bytes_acc,
                       "hbm_bytes_analytic": traffic, **mem},
        "hlo_raw": {"flops": flops, "bytes_accessed": bytes_acc},  # the direct count
        "probe": corrected,
        "collectives": {
            "bytes_by_type": colls.bytes_by_type,
            "count_by_type": colls.count_by_type,
            "wire_bytes": wire,
        },
        "roofline": terms,
        # the views DTensor could not split, run replicated instead
        "replicated_views": sorted([list(shape), list(src), list(dst)]
                                   for shape, src, dst in cost.replicated_views),
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / max(flops * chips, 1.0)),
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape.name}__{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "1x1"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--optimizer", default="auto")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the two-depth cost probes")
    ap.add_argument("--policy", default="tp",
                    help="sharding policy: tp | tp_sp | tp_kvs | fsdp")
    ap.add_argument("--moe-impl", default="gspmd", choices=["gspmd", "shard_map"])
    ap.add_argument("--repeat-kv", action="store_true")
    ap.add_argument("--decode-attn", default="gspmd", choices=["gspmd", "seq_shard"])
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weights for inference programs")
    ap.add_argument("--tag", default="", help="suffix for output json files")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="replace the shape's sequence length (0: keep it)")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="replace the shape's global batch (0: keep it)")
    ap.add_argument("--no-remat", action="store_true",
                    help="train steps without activation checkpointing")
    args = ap.parse_args(argv)

    archs = sorted(ARCHITECTURES) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    tc = TrainConfig(optimizer=args.optimizer)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                t0 = time.time()
                try:
                    r = run_one(arch, shape, mesh_kind, tc, args.out,
                                probe=not args.no_probe, policy=args.policy,
                                moe_impl=args.moe_impl, repeat_kv=args.repeat_kv,
                                decode_attn=args.decode_attn,
                                quantize=args.quantize, tag=args.tag,
                                seq_len=args.seq_len, global_batch=args.global_batch,
                                remat=not args.no_remat)
                    rt, mem = r["roofline"], r["per_device"]
                    peak = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                    print(
                        f"OK   {tag:60s} run={r['compile_s']:6.1f}s "
                        f"total={time.time() - t0:6.1f}s "
                        f"flops/dev={mem['flops']:.3e} peak/dev={peak / 1e9:.2f}GB "
                        f"dominant={rt['dominant']:10s} "
                        f"(c={rt['compute_s']*1e3:.2f}ms m={rt['memory_s']*1e3:.2f}ms "
                        f"coll={rt['collective_s']*1e3:.2f}ms) repeat_kv={r['repeat_kv']}",
                        flush=True,
                    )
                except Exception as e:  # a failure here is a sharding bug
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nAll dry-runs passed.")


if __name__ == "__main__":
    main()
