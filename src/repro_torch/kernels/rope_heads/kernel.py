"""Hopper CUDA kernel for RoPE on q and k and the heads-major layout of q, k
and v: binding and launch.

Replaces no TPU kernel (the JAX package leaves this work to XLA's fusion
inside its jitted prefill). The source is `repro_torch/kernels/csrc/
rope_heads.cu` (its header says what bounds the kernel and how it is cut);
`kernels/nvcc.py` builds it at first use, a small plain-C library of its
own. Nothing here runs at import: the CPU tests import this module on
machines with no nvcc and no card.

`rope_heads_cuda` checks its inputs, allocates the three heads-major
outputs with `torch.empty` and launches once on the current stream. It
reads q, k and v where and as they lie (any batch, sequence and head
strides; the last dimension contiguous), 16 bytes at a time, and the
positions through their own strides (prefill's are an expanded `arange`,
not copied). Each row must start on a 16-byte boundary and each half of it
be whole 16-byte units, as every model's projections give (hd 64, 80, 128). The inverse frequencies are made once
for each (half, theta, device) by `ref.inv_freq`, the plain rope's own
ops, and kept. Each launch adds one to `launches`. What the kernel cannot
take raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import MAX_HD
from repro_torch.kernels.nvcc import CudaLibrary, sm_count
from repro_torch.kernels.rope_heads.ref import inv_freq

__all__ = ["LIBRARY", "build_info", "cost", "launches", "rope_heads_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # the batch is the grid's third dimension

launches = 0  # kernel launches since the last reset (one per call)
_inv_freq: Dict[tuple, torch.Tensor] = {}  # (half, theta, device) -> float32 [half]


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rope_heads_launch.argtypes = [
        ci, ci, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), vp, vp, ci, ci, ci, ci, ci,
        vp, vp, vp, vp,
    ]
    lib.rope_heads_launch.restype = ci


LIBRARY = CudaLibrary("rope_heads", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def cost(b: int, s: int, h: int, hkv: int, hd: int, itemsize: int = 2) -> Dict[str, float]:
    """The work of one call, from its shapes: {"flops": 6 a rotated element
    (four products and two sums a pair of halves); "bytes_accessed": q, k
    and v read once and written once, and the int64 positions read once}."""
    return {"flops": float(3 * b * s * (h + hkv) * hd),
            "bytes_accessed": float(2 * itemsize * b * s * (h + 2 * hkv) * hd + 8 * b * s)}


def _freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    key = (half, float(theta), device)
    f = _inv_freq.get(key)
    if f is None:
        f = _inv_freq[key] = inv_freq(half, theta, device)
    return f


def _rows_aligned(tensors, elems: int) -> bool:
    """Every row of each tensor starts on a 16-byte boundary: the base is
    aligned and each stride but the last is a whole number of 16-byte units."""
    return all(t.data_ptr() % 16 == 0 and all(st % elems == 0 for st in t.stride()[:3])
               for t in tensors)


def rope_heads_cuda(
    q: torch.Tensor,  # [B, S, H, hd] float32 or bfloat16, last dimension contiguous, on a card
    k: torch.Tensor,  # [B, S, Hkv, hd], the same dtype and device
    v: torch.Tensor,  # [B, S, Hkv, hd]
    positions: torch.Tensor,  # [B, S] int64, any strides
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qh [B*H, S, hd], kh [B*Hkv, S, hd], vh [B*Hkv, S, hd]), contiguous in
    q's dtype: `ref.rope_heads_ref` computed by one kernel launch."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.dim() != 4 or x.stride(3) != 1:
            raise ValueError(f"{name} must be [B, S, heads, hd] with its last dimension "
                             f"contiguous, got shape {tuple(x.shape)} strides {x.stride()}")
    if not (q.device == k.device == v.device == positions.device):
        raise ValueError(f"q, k, v, positions on {q.device}, {k.device}, {v.device}, "
                         f"{positions.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if positions.dtype != torch.int64 or tuple(positions.shape) != (b, s):
        raise ValueError(f"positions must be int64 [{b}, {s}], got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if hd % 2 or not 2 <= hd <= MAX_HD:
        raise ValueError(f"hd={hd} must be even and within flash's [2, {MAX_HD}]")
    if b > MAX_BATCH or h == 0 or hkv == 0:
        raise ValueError(f"batch {b} over {h} q heads and {hkv} kv heads")
    elems = 16 // q.element_size()
    if (hd // 2) % elems or not _rows_aligned((q, k, v), elems):
        raise ValueError(f"rows must start on 16-byte boundaries and hd / 2 = {hd // 2} be "
                         f"a multiple of {elems} {q.dtype} values")
    dev = q.device
    sm_count(dev, "rope_heads")
    qh = torch.empty((b * h, s, hd), dtype=q.dtype, device=dev)
    kh = torch.empty((b * hkv, s, hd), dtype=q.dtype, device=dev)
    vh = torch.empty((b * hkv, s, hd), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return qh, kh, vh
    strides = (ctypes.c_longlong * 11)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                        *positions.stride())
    lib = LIBRARY.load()
    rc = lib.rope_heads_launch(
        dev.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
        positions.data_ptr(), _freqs(hd // 2, theta, dev).data_ptr(), b, s, h, hkv, hd,
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    LIBRARY.check(rc, "rope_heads")
    launches += 1
    return qh, kh, vh
