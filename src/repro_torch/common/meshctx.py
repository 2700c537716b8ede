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

`cost_analysis_dict` reads an XLA executable and has no counterpart yet.
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
