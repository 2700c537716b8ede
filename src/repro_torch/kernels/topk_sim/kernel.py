"""Hopper CUDA kernel for fused similarity + top-K: build, binding, launch.

Replaces the Pallas TPU kernel `repro/kernels/topk_sim/kernel.py::
topk_sim_pallas`. The source is `repro_torch/kernels/csrc/topk_sim.cu`
(its header says what bounds the kernel and how the two passes are cut).
`build()` compiles it with nvcc for `sm_90a` into a shared library with a
plain C interface (`kernels/nvcc.py`), cached under `kernels/build/` by a
hash of the source, and loads it with ctypes. Nothing here runs at
import: the CPU tests import this module on machines with no nvcc and no
card.

`topk_sim_cuda` checks its inputs, allocates the outputs and the scratch
with `torch.empty`, and launches both passes on the current stream. Each
launch adds one to `launches` (two per call), so a run can show that its
main path went through the kernel. A launch the runtime refuses raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.core.retrieval import NEG_INF
from repro_torch.kernels.nvcc import CudaLibrary, sm_count

__all__ = [
    "LIBRARY",
    "build",
    "build_info",
    "launches",
    "split_plan",
    "topk_sim_cuda",
]

# the kernel's own limits and tile sizes; they must match topk_sim.cu
TB = 128  # table rows per tile of pass 1
MAX_K = 128
MAX_D = 1024
MAX_CAND = 4096  # n_split * k, merged in shared memory by pass 2
BLOCKS_PER_SM = 4  # pass 1's grid target

launches = 0  # kernel launches since the last reset (two per topk_sim_cuda)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.topk_sim_partial_launch.argtypes = [
        ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp, vp,
    ]
    lib.topk_sim_partial_launch.restype = ci
    lib.topk_sim_merge_launch.argtypes = [
        ci, vp, ci, ci, ci, ctypes.c_float, vp, vp, vp,
    ]
    lib.topk_sim_merge_launch.restype = ci


LIBRARY = CudaLibrary("topk_sim", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def build() -> Path:
    """Compile (once per source hash) and load the kernel library."""
    LIBRARY.load()
    return Path(build_info["path"])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(n_q: int, n_t: int, k: int, n_sms: int) -> Tuple[int, int, int]:
    """(queries per block, n_split, rows_per_split) for pass 1.

    A batch of up to 8 queries takes the 8-query block, so it does not pay
    for 32 query slots. Enough table slices that the grid holds about
    BLOCKS_PER_SM blocks per SM, each slice a whole number of tiles, and
    n_split * k candidates per query within what pass 2 merges in shared
    memory.
    """
    qb = 8 if n_q <= 8 else 32
    n_split = _cdiv(BLOCKS_PER_SM * n_sms, _cdiv(n_q, qb))
    n_split = max(1, min(n_split, MAX_CAND // k, _cdiv(n_t, TB)))
    rows = _cdiv(_cdiv(n_t, n_split), TB) * TB
    return qb, _cdiv(n_t, rows), rows


def topk_sim_cuda(
    queries: torch.Tensor,  # [Q, D] float32, contiguous, on a CUDA device
    table: torch.Tensor,  # [T, D] float32, contiguous, same device
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32 descending, indices [Q, k] int64) by the kernel."""
    global launches
    for name, x in (("queries", queries), ("table", table)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if queries.device != table.device:
        raise ValueError(f"queries on {queries.device} but table on {table.device}")
    n_q, d = queries.shape
    n_t = table.shape[0]
    if table.shape[1] != d:
        raise ValueError(f"queries have D={d} but table rows D={table.shape[1]}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"D={d} outside the kernel's [1, {MAX_D}]")
    if not 1 <= k <= min(n_t, MAX_K):
        raise ValueError(f"k={k} outside [1, min(T={n_t}, {MAX_K})]")
    if n_t >= 2**31 - 1:
        raise ValueError(f"T={n_t} does not fit the kernel's 32-bit row ids")
    dev = queries.device
    n_sms = sm_count(dev, "topk_sim")
    scores = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    if n_q == 0:
        return scores, idx
    lib = LIBRARY.load()
    qb, n_split, rows = split_plan(n_q, n_t, k, n_sms)
    partial = torch.empty((n_q, n_split, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.topk_sim_partial_launch(
        dev.index, qb, queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k,
        n_split, rows, NEG_INF, partial.data_ptr(), stream,
    )
    LIBRARY.check(rc, "topk_sim_partial")
    launches += 1
    rc = lib.topk_sim_merge_launch(
        dev.index, partial.data_ptr(), n_q, n_split, k, NEG_INF,
        scores.data_ptr(), idx.data_ptr(), stream,
    )
    LIBRARY.check(rc, "topk_sim_merge")
    launches += 1
    return scores, idx
