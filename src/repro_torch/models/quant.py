"""Int8 weight quantization: per-channel symmetric codes with bf16 scales.

Counterpart of `repro/models/quant.py`, on torch tensors, with what the IVF
index needs: `should_quantize`, `quantize_tree` and `dequantize_tree`. The
rule is the reference's, bit for bit: per output channel (over axis -2),
`scale = max(amax, 1e-8) / 127` in float32, codes
`clip(round(w / scale), -127, 127)` as int8 from that float32 scale
(`torch.round` rounds half to even, as `jnp.round` does), and the scale
then *stored* as bf16. Matrix leaves (ndim >= 2, both trailing dims >= 64)
quantize; norms, biases and small tensors pass through unchanged.

`quantized_structs` gives the dry-run's int8 param tree (codes and scales
as structs, `common.sharding.struct`), and `quantized_bytes` the analytic
resident weight bytes after quantization.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import math

import torch

from repro_torch.models.params import ParamSpec, map_specs, tree_leaves

__all__ = ["should_quantize", "quantize_tree", "dequantize_tree", "quantized_structs",
           "quantized_bytes"]


def should_quantize(shape: Tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] >= 64 and shape[-2] >= 64


def _quant_leaf(w: torch.Tensor):
    if not should_quantize(tuple(w.shape)):
        return w
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.bfloat16)}


def _dequant_leaf(leaf, dtype):
    if _is_qleaf(leaf):
        return (leaf["q"].to(torch.float32) * leaf["scale"].to(torch.float32)).to(dtype)
    return leaf


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _map(fn, tree, is_leaf=lambda x: False):
    if is_leaf(tree) or not isinstance(tree, dict):
        return fn(tree)
    return {k: _map(fn, v, is_leaf) for k, v in tree.items()}


def quantize_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    return _map(_quant_leaf, params)


def dequantize_tree(qparams: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    return _map(lambda leaf: _dequant_leaf(leaf, dtype), qparams, is_leaf=_is_qleaf)


def quantized_structs(specs, mesh=None, dtype=torch.bfloat16):
    """Structs of the quantized param tree (dry-run input): int8 codes and
    bf16 scales [..., 1, out] for the leaves that quantize, `dtype` for
    the rest; each under its leaf's logical axes."""
    from repro_torch.common.sharding import struct

    def leaf(s: ParamSpec):
        if should_quantize(s.shape):
            scale_shape = s.shape[:-2] + (1,) + s.shape[-1:]
            return {"q": struct(mesh, s.axes, s.shape, torch.int8),
                    "scale": struct(mesh, s.axes, scale_shape, torch.bfloat16)}
        return struct(mesh, s.axes, s.shape, dtype)

    return map_specs(leaf, specs)


def quantized_bytes(specs) -> int:
    """Analytic resident weight bytes after int8 quantization."""
    total = 0
    for _, s in tree_leaves(specs):
        n = math.prod(s.shape)
        if should_quantize(s.shape):
            total += n + 2 * n // s.shape[-2]  # int8 + bf16 scales
        else:
            total += 2 * n
    return total
