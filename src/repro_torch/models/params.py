"""Spec-driven parameter construction (counterpart of `repro/models/params.py`).

Every model declares its parameters as a nested dict of `ParamSpec`s
(shape + logical axes + init kind); `init_params` draws them from one
`torch.Generator`. The init kinds and scales are those of the JAX package;
the numbers differ, because the generators do (tests that compare the two
packages carry the JAX parameters across with `repro_torch.convert`). The
logical axes are kept for the multi-device slice; on one device nothing
reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.common.device import resolve_device

__all__ = ["ParamSpec", "init_params", "param_count", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (multi-device slice)
    init: str = "normal"  # normal | zeros | ones | embed | small
    fan_in_dims: Tuple[int, ...] = (-2,)  # dims whose product scales init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


SpecTree = Dict[str, Any]  # nested dicts of ParamSpec


def tree_leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a nested dict in sorted-key order, as JAX
    flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _init_leaf(spec: ParamSpec, generator: torch.Generator, dtype, device,
               cut: Optional[Callable] = None) -> torch.Tensor:
    if spec.init in ("zeros", "ones"):
        x = torch.full(spec.shape, float(spec.init == "ones"), dtype=dtype, device=device)
    else:
        if spec.init == "embed":
            scale = 0.02
        elif spec.init == "small":
            scale = 1e-4
        else:
            fan_in = float(math.prod(spec.shape[d] for d in spec.fan_in_dims)) or 1.0
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        x.mul_(scale)
    if cut is not None:  # a view: the cast below copies only what is kept
        x = cut(spec, x)
    return x.to(dtype).contiguous()


def init_params(
    specs: SpecTree,
    generator: torch.Generator,
    dtype: Union[str, torch.dtype] = torch.float32,
    device: Union[str, torch.device, None] = None,
    cut: Optional[Callable[[ParamSpec, torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Parameters for `specs`, drawn in float32 from `generator` (which must
    live on `device`) and cast to `dtype`; leaves in sorted-key order.
    `cut(spec, x)`, where given, keeps the part of each drawn leaf this
    process holds, before the cast (the draw is the same either way)."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return _init_leaf(tree, generator, dtype, device, cut)

    return build(specs)


def param_count(specs: SpecTree) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(specs)))
