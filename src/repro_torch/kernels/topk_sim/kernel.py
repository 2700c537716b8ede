"""Hopper CUDA kernel for fused similarity + top-K: build, binding, launch.

Replaces the Pallas TPU kernel `repro/kernels/topk_sim/kernel.py::
topk_sim_pallas`. The source is `repro_torch/kernels/csrc/topk_sim.cu`
(its header says what bounds the kernel and how the two passes are cut).
`build()` compiles it with nvcc for `sm_90a` into a shared library with a
plain C interface, cached under `kernels/build/` by a hash of the source,
and loads it with ctypes. Nothing here runs at import: the CPU tests import
this module on machines with no nvcc and no card.

`topk_sim_cuda` checks its inputs, allocates the outputs and the scratch
with `torch.empty`, and launches both passes on the current stream. Each
launch adds one to `launches` (two per call), so a run can show that its
main path went through the kernel. A launch the runtime refuses raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.retrieval import NEG_INF

__all__ = [
    "SOURCE",
    "build",
    "build_info",
    "launches",
    "split_plan",
    "topk_sim_cuda",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "topk_sim.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernel's own limits and tile sizes; they must match topk_sim.cu
TB = 128  # table rows per tile of pass 1
MAX_K = 128
MAX_D = 1024
MAX_CAND = 4096  # n_split * k, merged in shared memory by pass 2
BLOCKS_PER_SM = 4  # pass 1's grid target

launches = 0  # kernel launches since the last reset (two per topk_sim_cuda)

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()
build_info: dict = {}  # path, seconds, cached, ptxas log of the last build()
_sm_count: Dict[int, int] = {}  # device index -> SMs, for Hopper devices only


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the topk_sim CUDA kernel cannot be built"
    )


def build() -> Path:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return Path(build_info["path"])
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"topk_sim_{digest}.so"
        t0 = time.perf_counter()
        log = ""
        cached = out.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        lib = ctypes.CDLL(str(out))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.topk_sim_partial_launch.argtypes = [
            ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp, vp,
        ]
        lib.topk_sim_partial_launch.restype = ci
        lib.topk_sim_merge_launch.argtypes = [
            ci, vp, ci, ci, ci, ctypes.c_float, vp, vp, vp,
        ]
        lib.topk_sim_merge_launch.restype = ci
        lib.topk_sim_error_string.argtypes = [ci]
        lib.topk_sim_error_string.restype = ctypes.c_char_p
        build_info.update(
            path=str(out), seconds=time.perf_counter() - t0, cached=cached, log=log
        )
        _lib = lib
        return out


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


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib.topk_sim_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


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
    n_sms = _sm_count.get(dev.index)
    if n_sms is None:
        if torch.cuda.get_device_capability(dev) != (9, 0):
            raise RuntimeError(
                f"the topk_sim kernel is built for sm_90a (Hopper); "
                f"{torch.cuda.get_device_name(dev)} is not one"
            )
        n_sms = _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    scores = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    if n_q == 0:
        return scores, idx
    if _lib is None:
        build()
    qb, n_split, rows = split_plan(n_q, n_t, k, n_sms)
    partial = torch.empty((n_q, n_split, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.topk_sim_partial_launch(
        dev.index, qb, queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k,
        n_split, rows, NEG_INF, partial.data_ptr(), stream,
    )
    _check(rc, "topk_sim_partial")
    launches += 1
    rc = _lib.topk_sim_merge_launch(
        dev.index, partial.data_ptr(), n_q, n_split, k, NEG_INF,
        scores.data_ptr(), idx.data_ptr(), stream,
    )
    _check(rc, "topk_sim_merge")
    launches += 1
    return scores, idx
