"""The mesh context: which mesh is active, and how to make one active.

Counterpart of `repro/common/meshctx.py`. The reference's mesh is a grid of
the devices one JAX process drives; the port's is a grid of the ranks of an
initialised `torch.distributed` process group, one process a rank, built on
`torch.distributed.device_mesh.DeviceMesh`. The contract is the
reference's:

  * `make_mesh(shape, names, device=None)` builds a `Mesh` over the
    process group (`None` means the CUDA card, which raises without one;
    the tests pass "cpu"). It raises when no process group is initialised
    or the shape does not cover the world, instead of running on one rank.
  * `use_mesh(mesh)` is a context manager making `mesh` active for the
    calling thread (a thread-local stack, so nested code and other threads
    see what they activated).
  * `current_mesh()` returns the active mesh or None; never raises, never
    returns an empty mesh.
  * `axis_sizes_dict(mesh)` maps axis name -> size.

Code under an active mesh runs SPMD, as the reference's `shard_map` bodies
do: every rank runs the same program on its own shard. The collectives the
port's sharded modules need are `Mesh` methods named as JAX's (`psum`,
`pmax`, `all_gather`, `axis_index`). Each takes mesh axis names and runs
over the ranks that differ only along them, on the tensors' own device (a
gloo group takes CUDA tensors for every op here), and a collective that
fails raises.

`cost_analysis_dict(fn, *args)` is the counterpart of the reference's
`cost_analysis_dict(compiled)`, with the same keys ("flops", "bytes
accessed"). The reference reads them off an XLA executable without
running it; the port has no executable, so it runs `fn(*args)` under a
counting dispatch mode (`CostMode`): on fake tensors (the dry-run) nothing
is computed or allocated. Under DTensors it counts the ops each rank runs
on its local blocks, per device as the reference's numbers are.

The DTensor internals the port touches (the dry-run's patches for its fake
runs, `dtensor_run_patches`, and the caches a new process group must
clear, `clear_dtensor_caches`) are private to torch and move between its
releases. They are reached here and nowhere else, which the `mesh-api`
rule of `python -m repro_torch.analysis` checks, as the reference pins its
JAX mesh APIs to its own meshctx.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device

__all__ = [
    "CostMode",
    "cost_analysis_dict",
    "Mesh",
    "current_mesh",
    "use_mesh",
    "make_mesh",
    "axis_sizes_dict",
    "dtensor_run_patches",
    "clear_dtensor_caches",
]

_LOCAL = threading.local()  # .stack: the meshes activated by use_mesh


def _registry_stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Mesh:
    """A named grid of the process group's ranks, and the collectives
    along its axes.

    `device_mesh` is the `DeviceMesh` (one sub-group an axis); `shape` maps
    axis name -> size as JAX's `Mesh.shape` does; `device` is where this
    rank's tensors live.
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    # ------------------------------------------------------------- queries
    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis `name` (`lax.axis_index`)."""
        return self.device_mesh.get_local_rank(name)

    def axes_size(self, names: Sequence[str]) -> int:
        return int(np.prod([self.shape[n] for n in names])) if names else 1

    def _groups(self, axes: Union[str, Sequence[str]]) -> list:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for n in names:
            if n not in self.shape:
                raise KeyError(f"mesh has no axis {n!r}; axes {self.axis_names}")
        # an axis of one rank still runs its collective: the same program
        # on every mesh shape, and the group's backend is exercised
        return [self.device_mesh.get_group(n) for n in names]

    # ---------------------------------------------------------- collectives
    def _all_reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        for group in self._groups(axes):  # SUM and MAX compose axis by axis
            dist.all_reduce(buf, op=op, group=group)
        return buf

    def psum(self, x: torch.Tensor, axes: Union[str, Sequence[str]]) -> torch.Tensor:
        """The sum of `x` over the ranks along `axes` (`lax.psum`); a new
        tensor, equal on those ranks."""
        return self._all_reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes: Union[str, Sequence[str]]) -> torch.Tensor:
        """The elementwise max of `x` over the ranks along `axes`."""
        return self._all_reduce(x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' `x` along mesh axis `axis`, concatenated on `dim` in
        the order of their coordinates. Shapes may differ along `dim`
        (uneven shards): each is padded to the largest and trimmed."""
        group, = self._groups(axis)
        src = x.detach().movedim(dim, 0).contiguous()
        n = self.shape[axis]
        sizes = torch.tensor([src.shape[0]], dtype=torch.int64, device=src.device)
        all_sizes = [torch.zeros_like(sizes) for _ in range(n)]
        dist.all_gather(all_sizes, sizes, group=group)
        lens = [int(s.item()) for s in all_sizes]
        width = max(lens)
        if src.shape[0] < width:
            pad = src.new_zeros((width - src.shape[0], *src.shape[1:]))
            src = torch.cat([src, pad])
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat([p[:l] for p, l in zip(parts, lens)]).movedim(0, dim)


# ---------------------------------------------------------------- resolution


def _nonempty(mesh) -> Optional[Mesh]:
    """An axis-less mesh counts as 'no mesh'."""
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return None
    return mesh


def current_mesh() -> Optional[Mesh]:
    """The mesh the calling thread activated last, or None outside any."""
    stack = _registry_stack()
    return _nonempty(stack[-1]) if stack else None


# ---------------------------------------------------------------- activation


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make `mesh` active for the calling thread inside the block."""
    stack = _registry_stack()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


# -------------------------------------------------------------- construction


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    device: Union[str, torch.device, None] = None,
) -> Mesh:
    """A mesh of `axis_shapes` named `axis_names` over every rank of the
    initialised process group, rank r at row-major coordinate r.

    Raises RuntimeError without a process group or when the shape does not
    cover the world, and for `device=None` or "cuda" without a card.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(init_process_group with its address, world size and rank)"
        )
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} axis sizes for {len(names)} names")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise RuntimeError(f"mesh {dict(zip(names, shape))} has {int(np.prod(shape))} "
                           f"ranks; the process group has {world}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=names)
    return Mesh(dm, dev)


# ------------------------------------------------------------------- queries


def axis_sizes_dict(mesh: Mesh) -> dict:
    """{axis name: size}."""
    return dict(mesh.shape)


# ------------------------------------------------------------------- costs

_SHAPE_QUERIES = None


def _shape_queries() -> frozenset:
    aten = torch.ops.aten
    return frozenset({
        aten.sym_is_contiguous.default, aten.is_contiguous.default,
        aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
        aten.is_non_overlapping_and_dense.default, aten.size.default,
        aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
        aten.storage_offset.default, aten.sym_storage_offset.default,
        aten.numel.default, aten.sym_numel.default, aten.dim.default,
        torch.ops.prim.layout.default})


def _same_storage_ops() -> tuple:
    """The functional collectives' ops whose output is their input on a
    device (registered once a collective module is imported):
    `wait_tensor`, and where this torch has it `_wrap_tensor_autograd`, the
    wrapper an eager collective's output takes outside a trace (a fake run
    waits instead)."""
    import torch.distributed._functional_collectives  # noqa: F401

    ops = torch.ops._c10d_functional
    return tuple(getattr(ops, name) for name in ("wait_tensor", "_wrap_tensor_autograd")
                 if hasattr(ops, name))


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostMode:
    """Per-device costs of the ops run inside `with CostMode() as c:`.

    `flops` counts as `torch.utils.flop_counter.FlopCounterMode` does (its
    formula registry, composite ops decomposed first), but only the ops on
    plain tensors: under DTensors those are each rank's ops on its local
    blocks, while FlopCounterMode would count the global DTensor op as well.
    `bytes_accessed` sums the input and output bytes of every such aten op
    that is not a view (collectives and metadata queries are not counted):
    the fusion-naive upper bound the reference reads off XLA's CPU backend.
    DTensor's sharding propagation runs each new op once on fake tensors of
    the global shapes to learn its output's metadata; those runs are no
    device's work and are not counted. With `track_memory`, `peak_bytes` is
    the largest total of live storages the block allocated (each storage
    counted once, freed when its last tensor dies): `watch(tree)` first
    marks the arguments' storages, which are then never counted;
    `peak_buffers()` lists the largest of those live at that peak, with the
    op that made each.
    """

    def __init__(self, track_memory: bool = False):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        global _SHAPE_QUERIES
        if _SHAPE_QUERIES is None:
            _SHAPE_QUERIES = _shape_queries()
        self.flops = 0
        self.bytes_accessed = 0
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        # each allocation: [bytes, op, shape, dtype, allocated at, freed at]
        # on a clock of allocations, and the clock's reading at the peak
        self._blocks: list = []
        self._peak_at = 0
        self._seen = WeakIdKeyDictionary()  # storage -> bytes (0 for arguments)
        self._muted = 0  # inside DTensor's metadata propagation
        same_storage = _same_storage_ops()
        self._unpatch = None
        owner = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func in _SHAPE_QUERIES:
                    return NotImplemented
                if owner._muted:
                    return func(*args, **kwargs)
                if owner._is_dtensor_call(types):
                    # let DTensor run first: its local ops come back here
                    return NotImplemented
                if func not in flop_registry and func is not torch.ops.prim.device.default:
                    with self:
                        r = func.decompose(*args, **kwargs)
                        if r is not NotImplemented:
                            return r
                out = func(*args, **kwargs)
                packet = func._overloadpacket
                if packet in flop_registry:
                    owner.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
                if func.namespace == "aten" and not func.is_view:
                    owner.bytes_accessed += sum(
                        t.numel() * t.element_size() for t in _tensors((args, kwargs, out)))
                if owner.track_memory:
                    if packet in same_storage:
                        owner._same_storage(out, args[0])
                        return out
                    for t in _tensors(out):
                        owner._allocated(t, str(packet))
                return out

        self._mode = _Mode()

    @staticmethod
    def _is_dtensor_call(types) -> bool:
        from torch.distributed.tensor import DTensor

        return any(issubclass(t, DTensor) for t in types)

    @staticmethod
    def _storage(t: torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        return t.untyped_storage()

    def watch(self, tree) -> int:
        """Mark the storages of `tree`'s tensors (local blocks of DTensors)
        as arguments; returns their bytes, each storage once."""
        total = 0
        for t in _tensors(tree):
            st = self._storage(t)
            if st not in self._seen:
                self._seen[st] = 0
                total += st.nbytes()
        return total

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of `tree`'s tensors that the block
        allocated (not arguments), each storage once."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = self._storage(t)
            if self._seen.get(st, 0) and id(st) not in seen:
                seen.add(id(st))
                total += self._seen[st]
        return total

    def allocated(self, tree) -> None:
        """Count the storages of `tree`'s tensors as allocated here (made
        while muted, as a collective's output is)."""
        if self.track_memory:
            for t in _tensors(tree):
                self._allocated(t, "collective")

    def _allocated(self, t: torch.Tensor, op: str) -> None:
        import weakref

        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live_bytes += n
        block = [n, op, list(t.shape), str(t.dtype).replace("torch.", ""), len(self._blocks), None]
        self._blocks.append(block)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self._peak_at = len(self._blocks)
        weakref.finalize(st, self._freed, block)

    def _same_storage(self, out: torch.Tensor, source: torch.Tensor) -> None:
        """`out` is `source` (a collective's `wait_tensor` returns its
        input on a device; its fake kernel returns a new tensor): `out`'s
        storage is not counted, and `source`'s stays live while it is."""
        import weakref

        st, src = out.untyped_storage(), source.untyped_storage()
        if st is src or st in self._seen:
            return
        self._seen[st] = self._seen.get(src, 0)
        weakref.finalize(st, lambda _: None, src)

    def _freed(self, block: list) -> None:
        self.live_bytes -= block[0]
        block[5] = len(self._blocks)

    def peak_buffers(self, count: int = 8) -> list:
        """The `count` largest storages live at `peak_bytes`, largest
        first: [bytes, op that made it, shape, dtype] each (a collective's
        output reads "collective")."""
        live = [b for b in self._blocks[: self._peak_at] if b[5] is None or b[5] >= self._peak_at]
        return [b[:4] for b in sorted(live, key=lambda b: -b[0])[:count]]

    @contextlib.contextmanager
    def muted(self):
        """Nothing run inside the block is counted (DTensor's bookkeeping)."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    def __enter__(self) -> "CostMode":
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        meta = ShardingPropagator._propagate_tensor_meta_non_cached

        def muted(prop, *args, **kwargs):
            with self.muted():
                return meta(prop, *args, **kwargs)

        ShardingPropagator._propagate_tensor_meta_non_cached = muted

        def unpatch():
            ShardingPropagator._propagate_tensor_meta_non_cached = meta
        self._unpatch = unpatch
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._mode.__exit__(*exc)
        finally:
            self._unpatch()


def cost_analysis_dict(fn, *args) -> dict:
    """{"flops", "bytes accessed"} of `fn(*args)` per device, counted by
    running it under `CostMode` (the reference reads them off its compiled
    program instead; see the module docstring)."""
    with CostMode() as cost:
        fn(*args)
    return {"flops": float(cost.flops), "bytes accessed": float(cost.bytes_accessed)}


# ------------------------------------------------------------ DTensor internals
# The dry-run's fake runs patch DTensor internals, and a new fake group
# clears DTensor's caches. Both reach names private to torch, which moved
# between torch 2.11 and 2.13: this module is the one place that does.


@contextlib.contextmanager
def dtensor_run_patches(cost: CostMode, views: set) -> Iterator[None]:
    """For a fake run under a mesh: DTensor's strided-shard index math on
    the host, uncounted by `cost`; its redistribution plans memoized; and
    its views lenient, each view it could not split added to `views`."""
    with (_strided_index_math_on_host(cost), _redistribution_plans_memoized(),
          _views_replicate_what_they_cannot_split(views)):
        yield


def clear_dtensor_caches() -> None:
    """Clear DTensor's sharding and redistribution caches, which key on
    meshes that compare equal by shape and names (a mesh over a new group
    would otherwise find the sub-groups of the one before)."""
    from torch.distributed.tensor import DTensor, _collective_utils, _redistribute

    torch._C._clear_DTensor_sharding_propagator_cache()
    propagator = DTensor._op_dispatcher.sharding_propagator
    propagator.propagate_op_sharding.cache_clear()
    type(propagator)._propagate_tensor_meta_cached.cache_clear()
    _redistribute._gen_transform_infos.cache_clear()
    _redistribute.clear_redistribute_planner_cache()
    _collective_utils.MeshTopoInfo.build_from_mesh.cache_clear()


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
    if "memo" not in _PLAN or _PLAN["group"] is not dist.group.WORLD:
        _PLAN.update(group=dist.group.WORLD, memo=functools.cache(plan))
    _redistribute._gen_transform_infos_non_cached = _PLAN["memo"]
    try:
        yield
    finally:
        _redistribute._gen_transform_infos_non_cached = plan
