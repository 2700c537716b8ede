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
DTensor, which `core.refine` refines a slice a rank. The port's models
take plain tensors, so no constraint call is threaded through them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def _placements(mesh: meshctx.Mesh, spec: Spec) -> tuple:
    """DTensor placements of `spec`, one a mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
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
    from torch.distributed.tensor import DTensor

    mesh = meshctx.current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(axes, mesh.axis_names, x.shape, meshctx.axis_sizes_dict(mesh),
                    relax_uneven=bool(RULES.get("_relax_uneven", False)))
    return x.redistribute(mesh.device_mesh, _placements(mesh, spec))


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
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh.device_mesh, _placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def dtensor_spec(x, mesh: meshctx.Mesh) -> Spec:
    """The spec (PartitionSpec's layout) of DTensor `x` on `mesh`."""
    from torch.distributed.tensor import Shard

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
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = meshctx.current_mesh()
    if mesh is None or mesh.device_mesh is not x.device_mesh:
        raise RuntimeError("gather_rows needs the DTensor's mesh active (use_mesh)")
    return gather_shards(x.to_local(), dtensor_spec(x, mesh), mesh)
