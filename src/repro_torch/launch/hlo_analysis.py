"""Collective accounting and roofline terms for the dry-run.

Counterpart of `repro/launch/hlo_analysis.py`. The reference parses the
partitioned HLO for its collectives; the port has no HLO, so
`collectives_from_trace` records them as the program runs: a dispatch
mode that sees every `_c10d_functional` / `c10d` collective rank 0 issues
(DTensor's redistributions and the shard_map modules' `dist` calls alike)
and sums the bytes of its buffer under the reference's five kinds.

Conventions (the reference's):
  * every number is per device (rank 0) per step;
  * a collective's bytes are those of its result buffer, as the HLO shape
    of the reference's op is: the gathered tensor of an all-gather, the
    reduced one of an all-reduce, the shard of a reduce-scatter;
  * wire-cost weights approximate ring algorithms: all-reduce 2x its
    buffer, gather/scatter/permute/all-to-all 1x;
  * `all_to_all_single` and DTensor's shard-to-shard redistribution count
    as all-to-all, also where the CPU group runs them as an all-gather
    and a chunk; a point-to-point send, and a broadcast, count as
    collective-permute (one buffer from one rank to others).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveStats", "collectives_from_trace", "roofline_terms", "HW",
           "COLLECTIVES"]

# The card's constants, per GPU:
#   H100 SXM5 80GB HBM3 at 700 W: dense bf16 tensor-core peak 989e12 FLOP/s
#   and HBM3 3.35e12 B/s (NVIDIA H100 Tensor Core GPU datasheet, SXM5
#   column; the dense figure is half the with-sparsity one);
#   DGX H100 node: 8 GPUs on NVLink 4 / NVSwitch at 450e9 B/s a direction
#   a GPU, and one 400 Gb/s ConnectX-7 NIC (50e9 B/s) a GPU between nodes
#   (NVIDIA DGX H100 user guide). A 16-wide mesh axis spans two nodes, so
#   every axis of the production meshes crosses the NIC.
HW = {
    "peak_flops": 989e12,  # bf16 dense FLOP/s
    "hbm_bw": 3.35e12,  # B/s
    "nvlink_bw": 450e9,  # B/s a direction, within a node of 8
    "nic_bw": 50e9,  # B/s, between nodes
}

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# wire multiplier (ring algorithm approximation)
_WIRE_WEIGHT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# op name (without namespace and overload) -> kind; c10d's in-place ops
# hold their result buffers in their first argument, the functional ops
# return them
_KIND = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "c10d")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_type: Dict[str, int]
    count_by_type: Dict[str, int]

    @classmethod
    def empty(cls) -> "CollectiveStats":
        return cls({k: 0 for k in COLLECTIVES}, {k: 0 for k in COLLECTIVES})

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_type[kind] += int(nbytes)
        self.count_by_type[kind] += 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_type.values())

    @property
    def wire_bytes(self) -> float:
        return sum(_WIRE_WEIGHT[k] * v for k, v in self.bytes_by_type.items())


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class _CollectiveMode(TorchDispatchMode):
    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats
        self.muted = 0  # inside a collective counted at a higher level

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first; its collectives come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted and func.namespace in _NAMESPACES:
            kind = _KIND.get(func._opname)
            if kind is not None:
                buf = args[0] if func.namespace == "c10d" else out
                self.stats.add(kind, _nbytes(buf))
        return out


@contextlib.contextmanager
def collectives_from_trace(cost=None) -> Iterator[CollectiveStats]:
    """Record the collectives of the code run inside the block (this rank's)
    into the `CollectiveStats` it yields. A CPU group runs an all-to-all as
    an all-gather and a chunk; with `cost` (a `common.meshctx.CostMode`)
    that stand-in is not counted, and only the all-to-all's output is, as
    a device's all-to-all allocates it."""
    from torch.distributed.tensor import placement_types

    stats = CollectiveStats.empty()
    mode = _CollectiveMode(stats)
    alltoall = placement_types.shard_dim_alltoall

    def counted_alltoall(*args, **kwargs):
        mode.muted += 1
        try:
            with cost.muted() if cost is not None else contextlib.nullcontext():
                out = alltoall(*args, **kwargs)
                if cost is not None and out.untyped_storage().nbytes() > _nbytes(out):
                    out = out.clone()  # a chunk of the stand-in's gathered buffer
        finally:
            mode.muted -= 1
        if cost is not None:
            cost.allocated(out)
        stats.add("all-to-all", _nbytes(out))
        return out

    placement_types.shard_dim_alltoall = counted_alltoall
    try:
        with mode:
            yield stats
    finally:
        placement_types.shard_dim_alltoall = alltoall


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_wire_bytes: float,
    link_bw: float = HW["nic_bw"],
) -> Dict[str, float]:
    """Three roofline terms in seconds (per device, per step), at the card's
    peak and HBM rate; collectives at `link_bw` (the NIC by default, which
    every production mesh axis crosses)."""
    compute_s = flops_per_device / HW["peak_flops"]
    memory_s = hbm_bytes_per_device / HW["hbm_bw"]
    collective_s = collective_wire_bytes / link_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }
