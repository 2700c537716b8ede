"""Production mesh construction over a fake process group.

Counterpart of `repro/launch/mesh.py`. The reference forces 512 placeholder
host devices (`XLA_FLAGS=--xla_force_host_platform_device_count=512`) and
lays its meshes over them; the port lays them over the ranks of a *fake*
process group of 512 ranks in this one process: collectives return
at once and move no data, so a DTensor program partitions and runs on fake
tensors as rank 0 of the production mesh would, without the cards.

The fake group comes from `torch.testing._internal.distributed.fake_pg`,
which is private to torch: this module is the one place that imports it.

Defined as functions (never module-level constants), so importing this
module touches no process group.

The mesh shapes are the reference's: 16x16 ("data", "model") for one pod
and 2x16x16 ("pod", "data", "model") for two, so every spec resolves as
JAX's does. On H100 nodes of 8 cards, a 16-wide axis spans two nodes.
"""
from __future__ import annotations

from typing import Sequence

import torch.distributed as dist

from repro_torch.common import meshctx

__all__ = ["make_production_mesh", "make_local_mesh", "make_fake_mesh", "fake_world",
           "CHIPS_PER_POD", "FAKE_WORLD"]

CHIPS_PER_POD = 256  # the reference's 16 x 16 pod
FAKE_WORLD = 512  # the largest mesh's ranks; every fake mesh lies over the first ones

_MESHES: dict = {}  # (shape, names) -> Mesh, for the fake group in _MESHES["group"]


def fake_world() -> None:
    """Make the default process group a fake one of FAKE_WORLD ranks, this
    process rank 0, unless it is one already (one group serves every mesh:
    re-initialising would strand the groups DTensor's caches hold). Raises
    if a real group is initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the dry-run needs a "
                               "fake one (run it in a process of its own)")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)
    _forget_earlier_groups()


def _forget_earlier_groups() -> None:
    """DTensor caches shardings and redistribution plans by meshes, which
    compare equal by shape and names: after a group was destroyed and a new
    one made (a test module's teardown, then the next module), the cached
    entries would point at the old group's sub-groups."""
    meshctx.clear_dtensor_caches()
    _MESHES.clear()


def make_fake_mesh(shape: Sequence[int], names: Sequence[str]) -> meshctx.Mesh:
    """A mesh of `shape` over the first ranks of the fake group, this
    process rank 0 (one Mesh for each shape and names)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    fake_world()
    if _MESHES.get("group") is not dist.group.WORLD:  # a new group: new meshes
        _MESHES.clear()
        _MESHES["group"] = dist.group.WORLD
    key = (tuple(int(n) for n in shape), tuple(names))
    if key not in _MESHES:
        n = 1
        for size in key[0]:
            n *= size
        if n > FAKE_WORLD:
            raise ValueError(f"mesh {dict(zip(key[1], key[0]))} has more than {FAKE_WORLD} ranks")
        dm = DeviceMesh("cpu", torch.arange(n).reshape(key[0]), mesh_dim_names=key[1])
        _MESHES[key] = meshctx.Mesh(dm, torch.device("cpu"))
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> meshctx.Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_local_mesh() -> meshctx.Mesh:
    """Every rank of the initialised process group (the fake one if none
    is), as a 1D ("data",) mesh."""
    if not dist.is_initialized():
        fake_world()
    return meshctx.make_mesh((dist.get_world_size(),), ("data",), device="cpu")
