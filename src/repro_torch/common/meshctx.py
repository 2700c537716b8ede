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
    marks the arguments' storages, which are then never counted.
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
        self._seen = WeakIdKeyDictionary()  # storage -> bytes (0 for arguments)
        self._muted = 0  # inside DTensor's metadata propagation
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
                    for t in _tensors(out):
                        owner._allocated(t)
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
                self._allocated(t)

    def _allocated(self, t: torch.Tensor) -> None:
        import weakref

        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, n)

    def _freed(self, n: int) -> None:
        self.live_bytes -= n

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
