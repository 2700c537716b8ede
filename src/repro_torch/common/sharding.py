"""Logical-axis sharding rules (MaxText-style) for the backend pools.

Counterpart of `repro/common/sharding.py`. Params and activations are named
by *logical* axes; `spec_for` resolves them against a mesh's axis names
(single-pod ("data", "model") or multi-pod ("pod", "data", "model")), with
the reference's policies, divisibility drop and `_relax_uneven`, and
returns a tuple in `PartitionSpec`'s layout: one entry a tensor dimension,
None (replicated), a mesh axis name, or a tuple of names.

Rules:
  batch    -> ("pod", "data")   data parallel
  embed    -> ("data",)         FSDP: shard the d_model dim of weights
  heads    -> ("model",)        tensor parallel attention
  kv_heads -> ("model",)
  ff       -> ("model",)        tensor parallel MLP
  experts  -> ("model",)        expert parallel MoE
  vocab    -> ("model",)        sharded logits/embedding table
  ssm_heads-> ("model",)        sharded SSD heads

The port runs SPMD (one process a rank), so a sharded tensor is what each
rank holds of it: `local_shard` cuts this rank's block out of a full
tensor by a spec, and `gather_shards` puts the blocks together again.
`named_sharding` gives the spec as DTensor placements, and
`distribute_rows` / `gather_rows` carry a tool table over a mesh axis as a
DTensor, which `core.refine` refines a slice a rank.

The models call `logical_constraint` at the reference's points: a no-op on
the plain tensors they run on, a redistribution of the DTensors the
dry-run (`launch/dryrun.py`) hands them. `struct` is the counterpart of
`jax.ShapeDtypeStruct(shape, dtype, sharding)`: a fake tensor of
`fake_mode()` (nothing allocated), as a DTensor of this rank's block under
a mesh. `to_local_block` / `from_local_block` are the edges of a
`shard_map` body for DTensor inputs: in to this rank's block under the
body's in-spec, out from its block under the out-spec.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.common import meshctx

__all__ = [
    "RULES",
    "POLICIES",
    "set_policy",
    "get_policy",
    "spec_for",
    "named_sharding",
    "logical_constraint",
    "block_range",
    "block_bounds",
    "local_shard",
    "gather_shards",
    "distribute_rows",
    "from_local",
    "dtensor_spec",
    "gather_rows",
    "fake_mode",
    "struct",
    "to_local_block",
    "from_local_block",
    "unflatten",
    "wrap_local",
    "project",
    "settled",
    "project_groups",
    "blockwise",
    "scatter_rows",
    "take_rows",
    "lookup_rows",
    "token_nll",
]

_COMMON: dict = {
    "seq": (),
    "layers": (),
    "stack": (),
    "capacity": (),
    "state": (),
    "conv": (),
    "image": (),
    "codebooks": (),
    "act_seq": (),  # sequence dim of the residual stream (SP shards it)
    "kv_seq": (),  # sequence dim of the decode KV cache
    None: (),
}

# Sharding policies:
#   tp      baseline: Megatron TP on heads/ff/experts + FSDP on d_model
#   tp_sp   + sequence-parallel residual stream (all-reduce -> RS+AG)
#   tp_kvs  + decode KV cache sharded over "model" on the SEQ dim (for archs
#           whose kv_heads don't divide the model axis and would replicate)
#   fsdp    ZeRO-3 only: batch over every axis, weights sharded on d_model,
#           no tensor parallelism
#   tp_serve[_kvs]  decode/serving: weights resident (no FSDP gathers/token)
POLICIES: dict = {
    "tp": {
        **_COMMON,
        "batch": ("pod", "data"),
        "embed": ("data",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "ssm_heads": ("model",),
        # uneven activation sharding is an opt-in
        "_relax_uneven": False,
    },
}
POLICIES["tp_relaxed"] = {**POLICIES["tp"], "_relax_uneven": True}
POLICIES["tp_sp"] = {**POLICIES["tp"], "act_seq": ("model",)}
POLICIES["tp_serve"] = {**POLICIES["tp"], "embed": ()}
POLICIES["tp_serve_kvs"] = {**POLICIES["tp_serve"], "kv_seq": ("model",)}
POLICIES["tp_kvs"] = {**POLICIES["tp"], "kv_seq": ("model",)}
POLICIES["fsdp"] = {
    **_COMMON,
    "batch": ("pod", "data", "model"),
    "embed": ("data", "model"),
    "heads": (),
    "kv_heads": (),
    "ff": (),
    "experts": (),
    "vocab": (),
    "ssm_heads": (),
}

RULES: dict = POLICIES["tp"]  # active policy (mutable)
_ACTIVE = "tp"

Spec = Tuple[Optional[object], ...]  # PartitionSpec's layout


class set_policy:
    """Context manager / setter switching the active sharding policy."""

    def __init__(self, name: str):
        global RULES, _ACTIVE
        if name not in POLICIES:
            raise KeyError(f"unknown sharding policy {name!r}; have {sorted(POLICIES)}")
        self._prev = _ACTIVE
        RULES = POLICIES[name]
        _ACTIVE = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global RULES, _ACTIVE
        RULES = POLICIES[self._prev]
        _ACTIVE = self._prev
        return False


def get_policy() -> str:
    return _ACTIVE


def spec_for(
    axes: Sequence[Optional[str]],
    mesh_axis_names: Sequence[str],
    shape: Optional[Sequence[int]] = None,
    mesh_axis_sizes: Optional[dict] = None,
    relax_uneven: bool = False,
) -> Spec:
    """Resolve logical axes -> a spec (PartitionSpec's layout) for the mesh.

    When `shape` and `mesh_axis_sizes` are given, a mesh axis is dropped
    (dimension replicated) if the dimension is not divisible by it — e.g.
    kv_heads=8 cannot shard 16-way, so the KV projection replicates over
    "model" while the q projection still shards.
    """
    parts = []
    used: set = set()
    for i, ax in enumerate(axes):
        mesh_axes = []
        dim = shape[i] if shape is not None else None
        for a in RULES.get(ax, ()):
            if a not in mesh_axis_names or a in used:
                continue
            if dim is not None and mesh_axis_sizes is not None:
                size = mesh_axis_sizes[a]
                divisor = size * int(np.prod([mesh_axis_sizes[m] for m in mesh_axes]) if mesh_axes else 1)
                if dim % divisor != 0:
                    # activations may shard unevenly as long as every shard
                    # gets at least one row; params and inputs stay strictly
                    # divisible
                    if not (relax_uneven and dim >= divisor):
                        continue
            mesh_axes.append(a)
        used.update(mesh_axes)
        if not mesh_axes:
            parts.append(None)
        elif len(mesh_axes) == 1:
            parts.append(mesh_axes[0])
        else:
            parts.append(tuple(mesh_axes))
    return tuple(parts)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _placements(mesh: meshctx.Mesh, spec: Spec, one_rank_replicates: bool = False) -> tuple:
    """DTensor placements of `spec`, one a mesh dimension. With
    `one_rank_replicates`, a mesh axis of one rank takes `Replicate()`
    (the same layout): DTensor refuses views that merge or drop a
    dimension sharded even one way, which the dry-run's single-rank mesh
    would otherwise hit."""
    placements = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if not (one_rank_replicates and mesh.shape[a] == 1):
                placements[mesh.axis_names.index(a)] = Shard(dim)
    return tuple(placements)


def named_sharding(mesh: meshctx.Mesh, axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None):
    """(mesh, placements): the logical axes' spec as DTensor placements, one
    a mesh dimension — `Shard(dim)` on each mesh axis that shards tensor
    dimension `dim` (a dimension over two mesh axes takes `Shard(dim)` on
    both), `Replicate()` on the rest."""
    return mesh, _placements(mesh, spec_for(axes, mesh.axis_names, shape,
                                            meshctx.axis_sizes_dict(mesh)))


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """A plain tensor unchanged; a DTensor redistributed to the logical
    axes' placements on the active mesh. No-op outside a mesh."""
    mesh = meshctx.current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(axes, mesh.axis_names, x.shape, meshctx.axis_sizes_dict(mesh),
                    relax_uneven=bool(RULES.get("_relax_uneven", False)))
    return x.redistribute(mesh.device_mesh, _placements(mesh, spec, one_rank_replicates=True))


# ----------------------------------------------------------- rank-local blocks


def block_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block `index` of `n` rows cut into `parts` as
    `torch.chunk` cuts them (ceil(n / parts) a block, the last ones shorter
    or empty), the layout DTensor's `Shard` uses."""
    step = -(-n // parts)
    start = min(index * step, n)
    return start, min(start + step, n)


def _coordinate(mesh: meshctx.Mesh, entry) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dimension sharded over `entry`'s
    mesh axes, the first axis major."""
    index, blocks = 0, 1
    for a in _entry_axes(entry):
        index = index * mesh.shape[a] + mesh.axis_index(a)
        blocks *= mesh.shape[a]
    return blocks, index


def block_bounds(mesh: meshctx.Mesh, entry, n: int) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a dimension of `n` sharded over
    spec entry `entry` (None, an axis name or a tuple of them)."""
    blocks, index = _coordinate(mesh, entry)
    return block_range(n, blocks, index)


def local_shard(x: torch.Tensor, spec: Spec, mesh: meshctx.Mesh) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `spec` (a view)."""
    for dim, entry in enumerate(spec):
        start, stop = block_bounds(mesh, entry, x.shape[dim])
        if stop - start != x.shape[dim]:
            x = x.narrow(dim, start, stop - start)
    return x


def gather_shards(x: torch.Tensor, spec: Spec, mesh: meshctx.Mesh) -> torch.Tensor:
    """The full tensor from every rank's block under `spec` (the inverse of
    `local_shard`; each rank gets it)."""
    for dim, entry in enumerate(spec):
        # the minor axis first, so the major axis concatenates whole runs
        for a in reversed(_entry_axes(entry)):
            x = mesh.all_gather(x, a, dim)
    return x


def distribute_rows(x: torch.Tensor, mesh: meshctx.Mesh, spec: Spec):
    """`x` (the same full tensor on every rank) placed by `spec` as a
    DTensor: this rank keeps its block and nothing moves (every rank cuts
    its own). Dimensions need not divide: blocks follow `block_range`."""
    return from_local(local_shard(x, spec, mesh).contiguous(), mesh, spec, x.shape)


def from_local(local: torch.Tensor, mesh: meshctx.Mesh, spec: Spec, shape):
    """The DTensor of global `shape` whose block on this rank under `spec`
    is `local` (no communication)."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh.device_mesh, _placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def dtensor_spec(x, mesh: meshctx.Mesh) -> Spec:
    """The spec (PartitionSpec's layout) of DTensor `x` on `mesh`."""
    by_dim: dict = {}
    for name, p in zip(mesh.axis_names, x.placements):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(name)
    return tuple(None if d not in by_dim else
                 (by_dim[d][0] if len(by_dim[d]) == 1 else tuple(by_dim[d]))
                 for d in range(x.dim()))


def gather_rows(x) -> torch.Tensor:
    """The full plain tensor of a DTensor made by `distribute_rows` (or
    by `core.refine` from one), gathered through the active mesh's
    collectives; a plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = meshctx.current_mesh()
    if mesh is None or mesh.device_mesh is not x.device_mesh:
        raise RuntimeError("gather_rows needs the DTensor's mesh active (use_mesh)")
    return gather_shards(x.to_local(), dtensor_spec(x, mesh), mesh)


# ------------------------------------------------------------------ structs

_FAKE_MODE = None


def fake_mode():
    """The one `FakeTensorMode` every struct is made in (fake tensors of two
    modes do not mix). Its shape environment lets DTensor's strided-shard
    rules run on fake shards; plain tensors a program makes (positions,
    masks) may enter it."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.symbolic_shapes import ShapeEnv

        _FAKE_MODE = FakeTensorMode(shape_env=ShapeEnv(), allow_non_fake_inputs=True)
    return _FAKE_MODE


def struct(mesh: Optional[meshctx.Mesh], axes: Optional[Sequence[Optional[str]]],
           shape: Sequence[int], dtype: torch.dtype, requires_grad: bool = False):
    """A fake tensor of `shape` and `dtype`: with `mesh`, the DTensor whose
    block on this rank is a fake shard under the logical `axes`' spec (made
    with `from_local`, never cut out of a full fake tensor); without, a
    plain fake tensor. `requires_grad` makes it a leaf that does."""
    shape = tuple(int(n) for n in shape)
    if mesh is None:
        with fake_mode():
            x = torch.empty(shape, dtype=dtype, device="cpu")
        return x.requires_grad_() if requires_grad else x
    spec = spec_for(axes, mesh.axis_names, shape, meshctx.axis_sizes_dict(mesh))
    local = []
    for dim, entry in enumerate(spec):
        start, stop = block_bounds(mesh, entry, shape[dim])
        local.append(stop - start)
    with fake_mode():
        block = torch.empty(tuple(local), dtype=dtype, device=mesh.device)
    x = wrap_local(block, mesh.device_mesh, _placements(mesh, spec, one_rank_replicates=True),
                   shape)
    return x.detach().requires_grad_() if requires_grad else x


def to_local_block(x, spec: Spec, mesh: meshctx.Mesh, split_axes=()) -> torch.Tensor:
    """This rank's block of DTensor `x` redistributed to `spec` (a shard_map
    in-spec: the collectives are DTensor's); a plain tensor as it is.
    `split_axes`: the mesh axes (indices) that the body's other operands
    split; a block whole along one of them gets a partial gradient there
    (each rank's share), which the backward sums over that axis."""
    if not isinstance(x, DTensor):
        return x
    placements = _placements(mesh, spec, one_rank_replicates=True)
    grads = [Partial() if i in split_axes and p.is_replicate() else p
             for i, p in enumerate(placements)]
    return x.redistribute(mesh.device_mesh, placements).to_local(grad_placements=grads)


def from_local_block(local: torch.Tensor, spec: Spec, mesh: meshctx.Mesh, like):
    """`local` as the DTensor of global shape `like`'s, placed by `spec` (a
    shard_map out-spec), when `like` is a DTensor; else `local`."""
    if not isinstance(like, DTensor):
        return local
    shape = list(local.shape)
    for dim, entry in enumerate(spec):
        shape[dim] *= mesh.axes_size(_entry_axes(entry))
    return wrap_local(local, mesh.device_mesh, _placements(mesh, spec, one_rank_replicates=True),
                      shape)


def unflatten(x, dim: int, sizes: Sequence[int]):
    """`x.unflatten(dim, sizes)`. A DTensor sharded on `dim` over more ranks
    than `sizes[0]` divides cannot be viewed so (DTensor shards the first of
    the split dimensions only; GSPMD would split the shards over both): its
    mesh axes on `dim` are first redistributed to `Replicate()`, an
    all-gather the dry-run's collectives show."""
    if isinstance(x, DTensor):
        dim = dim % x.dim()
        on_dim = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        shards = int(np.prod([x.device_mesh.size(i) for i in on_dim])) if on_dim else 1
        if sizes[0] % shards:
            placements = [Replicate() if i in on_dim else p for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, placements)
    return x.unflatten(dim, tuple(sizes))


def wrap_local(local: torch.Tensor, device_mesh, placements, shape):
    """The DTensor of global `shape` over `device_mesh` whose block on this
    rank is `local`, placed by `placements` (no communication). Its global
    strides keep `local`'s dimension order (an einsum's output is a
    permuted view), which DTensor needs to derive the blocks' strides; a
    block that is not dense is made contiguous first."""
    def dense_strides(sizes, order):
        out, step = [0] * len(sizes), 1
        for d in reversed(order):
            out[d] = step
            step *= sizes[d]
        return out

    order = sorted(range(local.dim()), key=lambda d: local.stride(d), reverse=True)
    if any(n > 1 and st != want for n, st, want in
           zip(local.shape, local.stride(), dense_strides(local.shape, order))):
        local = local.contiguous()
        order = list(range(local.dim()))
    return DTensor.from_local(local, device_mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(dense_strides(shape, order)))


def project(eq: str, x, w):
    """`torch.einsum(eq, x, w)` of activations `x` and a weight `w`.

    On DTensors each rank multiplies its own blocks, as GSPMD's FSDP +
    tensor-parallel product does, so that no two ranks compute the same
    block (DTensor's own strategy for the product, and more often for its
    backward, may keep both operands whole on an axis). On each mesh axis:
    where `w` shards a dimension it does not contract (heads, ff, vocab)
    and `x` one it keeps (its rows), the larger operand keeps its sharding
    and the smaller is gathered (activations rows-sharded with the weight
    gathered is FSDP; a decode token's row gathered is tensor parallelism);
    where only one of them does, it keeps it; else a contracted dimension
    sharded on `x` stays so, `w` is split alike, and the block is a partial
    sum; else, where `w` shards a dimension it contracts (FSDP's "embed")
    and `x` is whole on the axis (a one-token decode's row, which "data"
    cannot split), `x` is cut to the weight's block (a local slice), `w`
    stays where it lies and the block is a partial sum, reduced at the next
    constraint point, if that reduction (an all-reduce, twice the bytes of
    this rank's output block) moves fewer bytes than re-laying this rank's
    weight block would: a decode step's few rows take it, a batch-1
    prefill's long rows do not; else an output dimension of `w`, then of
    `x`, whose size the axis divides and that no later mesh axis splits is
    split over it. Autograd runs through the same blocks, so the backward
    keeps the layout."""
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    size = {**dict(zip(xs, x.shape)), **dict(zip(ws, w.shape))}
    mesh = x.device_mesh
    # this rank's output block as the operands lie, and its weight block
    out_shards = w_shards = 1
    for axis, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if (px.is_shard() and xs[px.dim] in out) or (pw.is_shard() and ws[pw.dim] in out):
            out_shards *= mesh.size(axis)
        if pw.is_shard():
            w_shards *= mesh.size(axis)
    partial_cheaper = 2 * math.prod(size[c] for c in out) // out_shards < w.numel() // w_shards
    x_pl, w_pl, out_pl, x_grad, w_grad = [], [], [], [], []
    # the axes last to first: a dimension that a later mesh axis shards, as
    # the operands lie or as this product splits it, cannot take an earlier
    # axis's split (DTensor orders a dimension's splits by mesh axis, the
    # earlier outside): the later axis's blocks would be re-laid
    taken: set = set()
    for axis in reversed(range(mesh.ndim)):
        px, pw = x.placements[axis], w.placements[axis]
        m = mesh.size(axis)
        on_x = xs[px.dim] if px.is_shard() else "_"
        on_w = ws[pw.dim] if pw.is_shard() else "_"
        later = taken | {xs[p.dim] for p in x.placements[axis + 1:] if p.is_shard()} | {
            ws[p.dim] for p in w.placements[axis + 1:] if p.is_shard()}
        free = [c for c in ws if c in out and c not in xs] + [c for c in xs if c in out]
        split = next((c for c in free if size[c] % m == 0 and c not in later),
                     None) if m > 1 else None
        w_out, x_row = on_w in out and on_w not in xs, on_x in out
        if w_out and (not x_row or x.numel() < w.numel()):  # w's heads / ff / vocab
            cx, cw, keep = None, on_w, on_w
        elif x_row:  # x's rows (w gathered: FSDP), or a dimension both carry
            cx, cw, keep = on_x, (on_x if on_x in ws else None), on_x
        elif on_x in ws:  # contracted, sharded alike
            cx, cw, keep = on_x, on_x, None
        elif on_w in xs and on_w not in out and px.is_replicate() and partial_cheaper:
            cx, cw, keep = on_w, on_w, None  # w contracted in place, x cut to its block
        elif split is not None:
            cx = split if split in xs else None
            cw, keep = (split if split in ws else None), split
        else:  # nothing to split: this axis computes the whole block
            cx = cw = keep = None
        taken |= {c for c in (cx, cw, keep) if c}
        x_pl.insert(0, Shard(xs.index(cx)) if cx else Replicate())
        w_pl.insert(0, Shard(ws.index(cw)) if cw else Replicate())
        # an operand whole along an axis that splits the output gets this
        # rank's share of its gradient there: a partial sum
        x_grad.insert(0, Partial() if keep and not cx else x_pl[0])
        w_grad.insert(0, Partial() if keep and not cw else w_pl[0])
        if keep:
            out_pl.insert(0, Shard(out.index(keep)))
        else:
            out_pl.insert(0, Partial() if cx and cx not in out else Replicate())
    local = torch.einsum(eq, x.redistribute(mesh, x_pl).to_local(grad_placements=x_grad),
                         w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad))
    return wrap_local(local, mesh, out_pl, tuple(size[c] for c in out))


def settled(x):
    """A DTensor with its partial sums reduced (each `Partial` placement
    made `Replicate`, an all-reduce) and the rest of its layout kept; a
    plain tensor as it is. For an output that no constraint point follows:
    a partial sum is no value its caller can read."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def blockwise(fn, args: Sequence, in_axes: Sequence, out_axes: Sequence):
    """`fn(*args)` computed block by block: the counterpart of the
    reference's `shard_map`, for a function whose ops never mix blocks of
    the dimensions the logical axes shard (attention over rows and heads,
    the SSD scan over rows and SSM heads). On plain tensors `fn(*args)`.
    On DTensors each argument is redistributed to its logical axes (`None`:
    passed as it is), `fn` runs on this rank's blocks, and each output in
    `out_axes` (one tuple of axes an output) comes back as a DTensor, each
    logical axis sharded over the mesh axes it took in the arguments."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = meshctx.current_mesh()
    sizes = meshctx.axis_sizes_dict(mesh)
    taken: dict = {}
    specs = []
    for a, axes in zip(args, in_axes):
        if axes is None or not isinstance(a, DTensor):
            specs.append(None)
            continue
        spec = spec_for(axes, mesh.axis_names, a.shape, sizes,
                        relax_uneven=bool(RULES.get("_relax_uneven", False)))
        for ax, entry in zip(axes, spec):
            if ax is not None and taken.setdefault(ax, entry) != entry:
                raise ValueError(f"logical axis {ax!r} resolves to {taken[ax]} and {entry}: "
                                 "the blocks would not line up")
        specs.append(spec)
    split = {mesh.axis_names.index(a) for e in taken.values() for a in _entry_axes(e)
             if e is not None and mesh.shape[a] > 1}
    local = [a if spec is None else to_local_block(a, spec, mesh, split)
             for a, spec in zip(args, specs)]
    outs = fn(*local)
    like = next(a for a in args if isinstance(a, DTensor))
    wrapped = tuple(
        from_local_block(o, tuple(taken.get(ax) if ax else None for ax in axes), mesh, like)
        for o, axes in zip(outs if len(out_axes) > 1 else (outs,), out_axes))
    return wrapped if len(out_axes) > 1 else wrapped[0]


def scatter_rows(shape: Sequence[int], target: torch.Tensor, data: torch.Tensor,
                 axes: Sequence[Optional[str]] = ()) -> torch.Tensor:
    """zeros(`shape`) with each row of `data` [R, D] added at its `target`
    row of the zeros viewed as [N, D]; a target of N adds its row to a spare
    row that is cut off (the MoE dispatch's dropped assignments). On plain
    tensors the plain `index_add_` into N + 1 rows.

    On DTensors the scatter is partitioned, as GSPMD partitions the
    reference's: the output is placed by the logical `axes` (its first
    dimension alone may shard: the experts), the rows of `data` and
    `target` are split over the "batch" axes and whole over the output's.
    Each rank adds only its rows whose target lies in its block of the
    output, into that block alone; the block is a partial sum over the
    rows' axes, reduced over them. No rank holds every row or the whole
    output. The backward keeps the layout: a rank's rows take the gradient
    of its block (zero where their target is elsewhere), summed over the
    output's axes."""
    shape = tuple(int(n) for n in shape)
    width = shape[-1]
    if not isinstance(data, DTensor):
        rows = int(np.prod(shape[:-1]))
        out = torch.zeros((rows + 1, width), dtype=data.dtype, device=data.device)
        return out.index_add_(0, target, data)[:rows].reshape(shape)
    mesh = meshctx.current_mesh()
    sizes = meshctx.axis_sizes_dict(mesh)
    out_spec = spec_for(tuple(axes) + (None,) * (len(shape) - len(axes)), mesh.axis_names,
                        shape, sizes)
    if any(out_spec[1:]):
        raise ValueError(f"scatter_rows shards the output's first dimension only: {out_spec}")
    out_axes = _entry_axes(out_spec[0])
    rows_axes = tuple(a for a in _entry_axes(spec_for(("batch",), mesh.axis_names,
                                                      data.shape[:1], sizes)[0])
                      if a not in out_axes)
    rows_spec = (rows_axes[0] if len(rows_axes) == 1 else (rows_axes or None), None)
    split = {mesh.axis_names.index(a) for a in out_axes}
    local = to_local_block(data, rows_spec, mesh, split)
    if isinstance(target, DTensor):
        target = to_local_block(target, rows_spec[:1], mesh)
    else:
        target = local_shard(target, rows_spec[:1], mesh)
    lo, hi = block_bounds(mesh, out_spec[0], shape[0])
    unit = int(np.prod(shape[1:-1]))
    n = (hi - lo) * unit
    at = target - lo * unit
    at = torch.where((at >= 0) & (at < n), at, n)  # elsewhere: the spare row
    block = local.new_zeros((n + 1, width)).index_add_(0, at, local)[:n]
    placements = [Shard(0) if a in out_axes else Partial() if a in rows_axes else Replicate()
                  for a in mesh.axis_names]
    out = wrap_local(block.reshape((hi - lo,) + shape[1:]), mesh.device_mesh, placements, shape)
    return out.redistribute(mesh.device_mesh, _placements(mesh, out_spec,
                                                          one_rank_replicates=True))


def take_rows(buf: torch.Tensor, target: torch.Tensor,
              axes: Sequence[Optional[str]] = ()) -> torch.Tensor:
    """The rows of `buf` viewed as [N, D] at `target` [R], a target of N
    reading a zero row (the MoE gather-back's dropped assignments): the
    counterpart of `scatter_rows`. On plain tensors the plain index of
    `buf`'s rows with one zero row appended.

    On DTensors the gather is partitioned, the dispatch's map read the
    other way: `buf` is placed by the logical `axes` (its first dimension
    alone may shard: the experts), the rows of `target` are split over the
    "batch" axes and whole over `buf`'s. Each rank reads only its rows
    whose target lies in its block of `buf` and writes zeros for the rest;
    the [R, D] block is a partial sum over `buf`'s axes, reduced to the
    rows' layout. A row has one rank that reads it and the others add
    zeros, so the result is the plain gather's exactly. No rank holds the
    whole buffer. The backward is each rank's scatter of its rows'
    gradients into its block of `buf`, summed over the rows' axes."""
    width = buf.shape[-1]
    if not isinstance(buf, DTensor):
        flat = buf.reshape(-1, width)
        return torch.cat([flat, flat.new_zeros((1, width))], dim=0)[target]
    shape = tuple(int(n) for n in buf.shape)
    mesh = meshctx.current_mesh()
    sizes = meshctx.axis_sizes_dict(mesh)
    buf_spec = spec_for(tuple(axes) + (None,) * (len(shape) - len(axes)), mesh.axis_names,
                        shape, sizes)
    if any(buf_spec[1:]):
        raise ValueError(f"take_rows reads a buffer sharded on its first dimension only: "
                         f"{buf_spec}")
    buf_axes = _entry_axes(buf_spec[0])
    rows_axes = tuple(a for a in _entry_axes(spec_for(("batch",), mesh.axis_names,
                                                      target.shape[:1], sizes)[0])
                      if a not in buf_axes)
    rows_spec = (rows_axes[0] if len(rows_axes) == 1 else (rows_axes or None),)
    split = {mesh.axis_names.index(a) for a in rows_axes}
    block = to_local_block(buf, buf_spec, mesh, split).reshape(-1, width)
    rows = target.shape[0]
    if isinstance(target, DTensor):
        target = to_local_block(target, rows_spec, mesh)
    else:
        target = local_shard(target, rows_spec, mesh)
    lo, _ = block_bounds(mesh, buf_spec[0], shape[0])
    at = target - lo * int(np.prod(shape[1:-1]))
    hit = (at >= 0) & (at < block.shape[0])  # elsewhere (or dropped): a zero row
    found = block.index_select(0, torch.where(hit, at, 0))
    found = torch.where(hit[:, None], found, torch.zeros((), dtype=found.dtype))
    placements = [Shard(0) if a in rows_axes else Partial() if a in buf_axes else Replicate()
                  for a in mesh.axis_names]
    out = wrap_local(found, mesh.device_mesh, placements, (rows, width))
    return out.redistribute(mesh.device_mesh, _placements(mesh, rows_spec + (None,),
                                                          one_rank_replicates=True))


def project_groups(eq: str, x, w, groups: Sequence) -> list:
    """`torch.einsum(eq, x, w)` cut along its last dimension (a column of
    `w` each) into `groups` of consecutive columns, one part a group. A
    group is (width, unit, axes).

    On plain tensors: the one product, and a view of each group's columns.
    So too on DTensors when no group's last axis resolves to a mesh axis:
    nothing would stay split.

    Otherwise one `project` a group, of its columns of `w` alone, placed by
    the group's logical `axes`; the last of them places the group's columns
    in blocks of `unit` (an SSM head's), resolved as `spec_for` resolves
    the count of units, so a rank's block is whole units. Adjacent groups
    placed alike with their columns whole are one product, and a view each.
    A cut of the one product at columns that are not its shards' edges
    would gather the whole product onto every rank; here each group comes
    out in the layout its consumer needs, and only the groups whole over an
    axis are gathered."""
    specs = None
    if isinstance(x, DTensor):
        mesh = meshctx.current_mesh()
        ins, out = eq.replace(" ", "").split("->")
        xs, ws = ins.split(",")
        size = {**dict(zip(xs, x.shape)), **dict(zip(ws, w.shape))}
        lead = tuple(size[c] for c in out[:-1])
        specs = [spec_for(axes, mesh.axis_names, lead + (width // unit,),
                          meshctx.axis_sizes_dict(mesh)) for width, unit, axes in groups]
        if not any(spec[-1] for spec in specs):
            specs = None
    if specs is None:
        runs = [(0, len(groups), project(eq, x, w))]
    else:
        runs, at, i = [], 0, 0
        while i < len(groups):
            j = i + 1
            while j < len(groups) and specs[i][-1] is None and specs[j] == specs[i]:
                j += 1
            width = sum(g[0] for g in groups[i:j])
            runs.append((i, j, project(eq, x, w[..., at:at + width]).redistribute(
                mesh.device_mesh, _placements(mesh, specs[i], one_rank_replicates=True))))
            i, at = j, at + width
    parts = []
    for i, j, y in runs:
        if j - i == 1:
            parts.append(y)
            continue
        offsets = np.cumsum([0] + [g[0] for g in groups[i:j]])
        parts += [y[..., a:b] for a, b in zip(offsets[:-1], offsets[1:])]
    return parts


def lookup_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]`.

    On a DTensor table the lookup is vocab-parallel, as GSPMD partitions the
    reference's `jnp.take`: each rank reads its own block of the table (its
    rows of the vocabulary, its columns of the embedding), looks up only the
    tokens whose row lies in its block and writes zeros for the rest, and
    the partial rows are summed over the vocabulary's mesh axes. A row has
    one rank that adds it and the others add zeros, so the sum is
    `table[tokens]` exactly. The tokens (small) are gathered over the mesh
    axes that split the table; the rows come back in the tokens' layout
    with the embedding whole, the layout `_embed_tokens` constrains them
    to. No rank holds more of the table than its block. The backward is
    each rank's `index_add_` into its own block (`index_select`'s), brought
    to the table's own placements (a share of the gradient is summed over
    the axes the table is whole on and the tokens split), so a tied table's
    lookup and head gradients sum in one layout.

    The partial rows a rank builds are its share of the tokens by its block
    of the columns. Where they would move more bytes than the whole table
    (summed over the vocabulary's axes, an all-reduce, twice their bytes;
    brought back to the tokens' layout where the table splits its columns
    over an axis the tokens split, an all-to-all), as a prefill's or a
    training batch's tokens may against a small table, the table is
    gathered whole instead and each rank looks up its own tokens in it,
    its gradient a share summed back onto the table's blocks. Either
    path's buffers (the partial rows, or the gathered table) live only
    through the lookup. A decode step's few tokens never gather it."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    placed = tokens.placements
    # the tokens whole over the axes that split the table
    whole = [Replicate() if p.is_shard() else t for p, t in zip(table.placements, placed)]
    rows = tokens.numel() // int(np.prod([mesh.size(i) for i, p in enumerate(whole)
                                          if p.is_shard()]))
    moved = rows * table.to_local().shape[1] * (
        2 * any(p.is_shard(0) for p in table.placements)
        + any(p.is_shard(1) and t.is_shard() for p, t in zip(table.placements, placed)))
    if moved > table.numel():
        full = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if t.is_shard() else Replicate() for t in placed])
        return wrap_local(full[tokens.to_local()], mesh, placed, (*tokens.shape, table.shape[1]))
    ids = tokens.redistribute(mesh, whole).to_local()
    grads = [Partial() if t.is_shard() else p for p, t in zip(table.placements, whole)]
    local = table.redistribute(mesh, table.placements).to_local(grad_placements=grads)
    ctx = meshctx.current_mesh()
    lo, hi = block_bounds(ctx, dtensor_spec(table, ctx)[0], table.shape[0])
    at = ids - lo
    hit = (at >= 0) & (at < hi - lo)
    found = local.index_select(0, torch.where(hit, at, 0).reshape(-1)).reshape(*ids.shape, -1)
    found = torch.where(hit[..., None], found, torch.zeros((), dtype=found.dtype))
    out = [Partial() if p.is_shard(0) else Shard(ids.dim()) if p.is_shard(1) else t
           for p, t in zip(table.placements, whole)]
    found = wrap_local(found, mesh, out, (*tokens.shape, table.shape[1]))
    return found.redistribute(mesh, placed)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[..., target] in float32, a token each.

    On DTensors each rank works on its rows and its block of the
    vocabulary (the vocab-parallel cross-entropy): the max, the sum of
    exponentials and the target's logit (zero off this rank's block) are
    all-reduced over the vocabulary's mesh axes as partial results, whose
    gradients pass back unchanged. DTensor's own log_softmax gathers the
    vocabulary, and its rule for the gather's backward scatters into the
    whole global batch on every rank."""
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    mesh, vdim = logits.device_mesh, logits.dim() - 1
    placements = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, placements)
    rows = [Replicate() if p.is_shard(vdim) else p for p in placements]
    split = [i for i, p in enumerate(placements) if p.is_shard(vdim)]
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t = targets.redistribute(mesh, rows).to_local()
    local = logits.to_local().float()
    lo, size = 0, logits.shape[-1]
    for i in split:  # this rank's block of the vocabulary, as Shard(vdim) chunks it
        size = -(-size // mesh.size(i))
        lo += mesh.get_local_rank(i) * size
    n = local.shape[-1]

    def reduce(x, partial):
        partials = [partial if i in split else p for i, p in enumerate(rows)]
        x = DTensor.from_local(x, mesh, partials, run_check=False)
        return x.redistribute(mesh, rows).to_local()

    top = reduce(local.amax(dim=-1).detach(), Partial("max"))
    lse = reduce(torch.exp(local - top[..., None]).sum(dim=-1), Partial()).log() + top
    hit = (t >= lo) & (t < lo + n)
    at = local.gather(-1, (t - lo).clamp(0, n - 1)[..., None])[..., 0]
    picked = reduce(torch.where(hit, at, torch.zeros_like(at)), Partial())
    return wrap_local(lse - picked, mesh, rows, targets.shape)
