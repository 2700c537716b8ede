"""Hopper CUDA kernels for flash attention: binding, routing and launch.

Replace the Pallas TPU kernel `repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`. The source is `repro_torch/kernels/csrc/
flash_attention.cu` (its header says what bounds each kernel and how it is
cut); `kernels/nvcc.py` builds it at first use. Nothing here runs at
import: the CPU tests import this module on machines with no nvcc and no
card.

The source holds two kernels, and `flash_route` picks one by type and
shape: "wgmma" (bf16 on the tensor cores, fed by TMA) where its inputs fit,
"fma" (float32 FMAs on the CUDA cores) for float32 and for the bf16 inputs
the wgmma kernel cannot take. Neither falls back to the other.

`flash_attention_cuda` checks its inputs, allocates the output with
`torch.empty` and launches the routed kernel on the current stream. Each
launch adds one to `launches` and to `launches_by_route[route]`, so a run can
show that its main path went through the kernel, and through which. A
launch the runtime refuses raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.nvcc import CudaLibrary, sm_count

__all__ = ["LIBRARY", "MAX_HD", "ROUTES", "build_info", "flash_attention_cuda", "flash_route",
           "launches", "launches_by_route"]

MAX_HD = 128  # head dims the kernels take (they pad to 64 or 128 inside)
MAX_ROWS = 65535  # BH is the grid's second dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "fma")

launches = 0  # kernel launches since the last reset (one per call)
launches_by_route = dict.fromkeys(ROUTES, 0)  # the same launches, by kernel


def flash_route(dtype: torch.dtype, hd: int, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> str:
    """"wgmma" for bf16 with hd % 8 == 0 (a TMA row stride is a multiple of
    16 bytes), hd <= 128, at least one key and 16-byte aligned bases; else
    "fma"."""
    if (dtype == torch.bfloat16 and hd % 8 == 0 and hd <= MAX_HD and k.shape[1] > 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "fma"


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp,
    ]
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_wgmma_launch.argtypes = [
        ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp,
    ]
    lib.flash_attention_wgmma_launch.restype = ci


LIBRARY = CudaLibrary("flash_attention", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def flash_attention_cuda(
    q: torch.Tensor,  # [BH, Sq, hd] float32 or bfloat16, contiguous, on a CUDA device
    k: torch.Tensor,  # [BHkv, Skv, hd], BH % BHkv == 0: row bh reads row bh // (BH / BHkv)
    v: torch.Tensor,  # [BHkv, Skv, hd]
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    route: Optional[str] = None,  # None: flash_route's choice; "fma" on bf16 for measurement
) -> torch.Tensor:
    """Attention output [BH, Sq, hd] in q's dtype, computed by a kernel."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, hd = q.shape
    if k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    bhkv, skv = k.shape[0], k.shape[1]
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"hd={hd} outside the kernel's [1, {MAX_HD}]")
    if bhkv == 0 or bh % bhkv or bh > MAX_ROWS:
        raise ValueError(f"{bh} query rows over {bhkv} key/value rows")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    chosen = flash_route(q.dtype, hd, q, k, v)
    if route is None:
        route = chosen
    elif route not in ROUTES or (route == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"route {route!r} cannot take these inputs (flash_route: {chosen!r})")
    dev = q.device
    sm_count(dev, "flash_attention")
    out = torch.empty_like(q)
    if sq == 0 or bh == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(hd)
    if route == "wgmma":
        rc = lib.flash_attention_wgmma_launch(
            dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bh // bhkv, sq, skv, hd, int(causal), int(window), int(q_offset), scale, stream,
        )
    else:
        rc = lib.flash_attention_launch(
            dev.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bh, bh // bhkv, sq, skv, hd, int(causal), int(window),
            int(q_offset), scale, stream,
        )
    LIBRARY.check(rc, f"flash_attention ({route})")
    launches += 1
    launches_by_route[route] += 1
    return out
