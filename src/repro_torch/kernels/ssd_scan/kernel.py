"""Hopper CUDA kernel for the Mamba-2 SSD chunk scan: binding and launch.

Replaces the Pallas TPU kernel `repro/kernels/ssd_scan/kernel.py::
ssd_scan_pallas`. The source is `repro_torch/kernels/csrc/ssd_scan.cu`
(its header says what bounds the kernel and how it is cut);
`kernels/nvcc.py` builds it at first use. Nothing here runs at import: the
CPU tests import this module on machines with no nvcc and no card.

`ssd_scan_cuda` checks its inputs and lays them out as the kernel reads
them: x contiguous in its own dtype (float32 or bfloat16), and dt, a_log,
B and C contiguous float32 (an exact cast: the kernel computes in float32
as the TPU kernel does). It allocates y and the final state with
`torch.empty` and launches on the current stream. Each launch adds one to
`launches`. A launch the runtime refuses raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary, sm_count

__all__ = ["LIBRARY", "MAX_N", "MAX_P", "build_info", "launches", "ssd_scan_cuda"]

MAX_P = 128  # head dim P the kernel takes
MAX_N = 128  # state dim N the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (one per call)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [
        ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.ssd_scan_launch.restype = ci


LIBRARY = CudaLibrary("ssd_scan", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def ssd_scan_cuda(
    x: torch.Tensor,  # [B, S, H, P] float32 or bfloat16, on a CUDA device
    dt: torch.Tensor,  # [B, S, H]
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N], H % G == 0
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    global launches
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b_mat.dim() != 4 or b_mat.shape[:2] != (bsz, s) or c_mat.shape != b_mat.shape:
        raise ValueError(f"B {tuple(b_mat.shape)} and C {tuple(c_mat.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log {tuple(a_log.shape)} do not fit x")
    if g < 1 or h % g:
        raise ValueError(f"H={h} heads are not a multiple of G={g} groups")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"P={p}, N={n} outside the kernel's [1, {MAX_P}] x [1, {MAX_N}]")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    dev = x.device
    sm_count(dev, "ssd_scan")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    x = x.contiguous()
    dt, a_log, b_mat, c_mat = (
        t.to(torch.float32).contiguous() for t in (dt, a_log, b_mat, c_mat)
    )
    lib = LIBRARY.load()
    rc = lib.ssd_scan_launch(
        dev.index, _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
        b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, p,
        g, n, torch.cuda.current_stream(dev).cuda_stream,
    )
    LIBRARY.check(rc, "ssd_scan")
    launches += 1
    return y, state
