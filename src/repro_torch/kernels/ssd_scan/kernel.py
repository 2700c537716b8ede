"""Hopper CUDA kernel for the Mamba-2 SSD chunk scan: binding and launch.

Replaces the Pallas TPU kernel `repro/kernels/ssd_scan/kernel.py::
ssd_scan_pallas`. The source is `repro_torch/kernels/csrc/ssd_scan.cu`
(its header says what bounds the kernel and how it is cut);
`kernels/nvcc.py` builds it at first use. Nothing here runs at import: the
CPU tests import this module on machines with no nvcc and no card.

`ssd_scan_cuda` checks its inputs and runs the scan in three launches on
the current stream (`prepare`, then `launch_phase` for each of `PHASES`):
tile states, the carry across tiles, the readout. It reads x, B and C where
and as they lie, with their own batch and row strides, so the column slices
of xBC that `ssm_block` passes are not copied, 16 bytes at a time where
their rows allow it; dt is float32 with its own strides (cast only if it is
not), a_log an [H] float32 cast. B and C of another dtype than x are cast,
with x, to float32 (exact), and y is rounded to x's dtype once. It
allocates y, the final state and the float32 scratch of tile states with
`torch.empty`. Each kernel launch adds one to `launches` (three a call). A
launch the runtime refuses raises.
"""
from __future__ import annotations

import ctypes
import types
from typing import Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary, sm_count

__all__ = ["LIBRARY", "MAX_N", "MAX_P", "PHASES", "TILE", "build_info", "launch_phase",
           "launches", "prepare", "ssd_scan_cuda"]

MAX_P = 128  # head dim P the kernel takes
MAX_N = 128  # state dim N the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # sequence rows per tile (ssd_scan.cu's TL)
PHASES = ("states", "carry", "output")

launches = 0  # kernel launches since the last reset (three per call)
_smem_ok: set = set()  # (P, N) whose blocks fit in shared memory


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    phase_args = [ci, ci, vp, ll, ll, vp, ll, ll, vp, vp, vp, ll, ll,
                  ci, ci, ci, ci, ci, ci, ci, ci, ci]
    lib.ssd_scan_states_launch.argtypes = phase_args + [vp, vp, vp]
    lib.ssd_scan_states_launch.restype = ci
    lib.ssd_scan_carry_launch.argtypes = [ci, vp, vp, vp, ci, ci, ci, vp]
    lib.ssd_scan_carry_launch.restype = ci
    lib.ssd_scan_output_launch.argtypes = phase_args + [vp, vp, vp]
    lib.ssd_scan_output_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci, ci, ci]
    lib.ssd_scan_smem_bytes.restype = ll


LIBRARY = CudaLibrary("ssd_scan", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def _rows_inner_contiguous(t: torch.Tensor) -> bool:
    """[B, S, a, b] whose last two dims are contiguous within a row."""
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def _rows_vectorized(*tensors: torch.Tensor) -> bool:
    """Every row of each [B, S, a, b] tensor starts on a 16-byte boundary
    and holds whole 16-byte units: the kernels read it 16 bytes at a time."""
    for t in tensors:
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per or t.shape[3] % per:
            return False
    return True


def prepare(
    x: torch.Tensor,  # [B, S, H, P] float32 or bfloat16, on a CUDA device
    dt: torch.Tensor,  # [B, S, H]
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N], H % G == 0
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
) -> types.SimpleNamespace:
    """Check the inputs and allocate y, the final state and the scratch:
    the arguments of the three phases' launches."""
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
    y_dtype = x.dtype
    if not (b_mat.dtype == c_mat.dtype == x.dtype):  # the kernels read one dtype
        x, b_mat, c_mat = x.float(), b_mat.float(), c_mat.float()
    # read in place where the layout allows; copy only what it does not
    if not _rows_inner_contiguous(x):
        x = x.contiguous()
    if not (_rows_inner_contiguous(b_mat) and b_mat.stride() == c_mat.stride()):
        b_mat, c_mat = b_mat.contiguous(), c_mat.contiguous()
    if dt.dtype != torch.float32 or dt.stride(2) != 1:
        dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    lib = LIBRARY.load()
    if (p, n) not in _smem_ok:
        for phase in (1, 3):
            smem = lib.ssd_scan_smem_bytes(phase, p, n)
            if smem > 227 * 1024:
                raise ValueError(f"P={p}, N={n} need {smem} bytes of shared memory a block")
        _smem_ok.add((p, n))
    n_tiles = -(-s // TILE)
    args = (_DTYPES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(),
            dt.stride(0), dt.stride(1), a_log.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            b_mat.stride(0), b_mat.stride(1), bsz, s, h, p, g, n, n_tiles,
            int(_rows_vectorized(x)), int(_rows_vectorized(b_mat, c_mat)))
    return types.SimpleNamespace(
        lib=lib, device=dev, stream=torch.cuda.current_stream(dev).cuda_stream, args=args, rows=bsz * h, pn=p * n, n_tiles=n_tiles,
        y_dtype=y_dtype, inputs=(x, dt, a_log, b_mat, c_mat),  # keep the pointed-at alive
        y=torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev),
        state=torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev),
        contrib=torch.empty((bsz * h, n_tiles, p, n), dtype=torch.float32, device=dev),
        totals=torch.empty((bsz * h, n_tiles), dtype=torch.float32, device=dev),
    )


def launch_phase(ctx: types.SimpleNamespace, phase: str) -> None:
    """Launch one phase ("states", "carry" or "output") of a prepared call."""
    global launches
    stream, dev = ctx.stream, ctx.device.index
    if phase == "states":
        rc = ctx.lib.ssd_scan_states_launch(dev, *ctx.args, ctx.contrib.data_ptr(),
                                            ctx.totals.data_ptr(), stream)
    elif phase == "carry":
        rc = ctx.lib.ssd_scan_carry_launch(dev, ctx.contrib.data_ptr(), ctx.totals.data_ptr(),
                                           ctx.state.data_ptr(), ctx.rows, ctx.pn,
                                           ctx.n_tiles, stream)
    elif phase == "output":
        rc = ctx.lib.ssd_scan_output_launch(dev, *ctx.args, ctx.contrib.data_ptr(),
                                            ctx.y.data_ptr(), stream)
    else:
        raise ValueError(f"no phase {phase!r}; the phases are {PHASES}")
    LIBRARY.check(rc, f"ssd_scan_{phase}")
    launches += 1


def ssd_scan_cuda(
    x: torch.Tensor,  # [B, S, H, P] float32 or bfloat16, on a CUDA device
    dt: torch.Tensor,  # [B, S, H]
    a_log: torch.Tensor,  # [H]
    b_mat: torch.Tensor,  # [B, S, G, N], H % G == 0
    c_mat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    ctx = prepare(x, dt, a_log, b_mat, c_mat, chunk)
    for phase in PHASES:
        launch_phase(ctx, phase)
    return ctx.y.to(ctx.y_dtype), ctx.state
