"""Optimizer base types and tree helpers, over (nested) dicts of tensors.

Counterpart of `repro/optim/base.py`: a "tree" here is a tensor or a dict
whose values are trees, as the learned stages keep their params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

__all__ = [
    "Optimizer",
    "Schedule",
    "apply_updates",
    "as_schedule",
    "clip_by_global_norm",
    "global_norm",
    "tree_leaves",
    "tree_map",
]

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A gradient transformation: (grads, state, params) -> (updates, state)."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(tree scaled to a global norm of at most `max_norm`, the norm before).
    A leaf comes back in its dtype promoted with the float32 scale's, as
    JAX promotes it: a bfloat16 leaf becomes float32 (torch would keep a
    tensor times a 0-dim tensor in the tensor's dtype)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda x: x.to(torch.promote_types(x.dtype, scale.dtype)) * scale,
                    tree), norm


def as_schedule(lr) -> Schedule:
    """A constant learning rate becomes a schedule returning it as a float32
    0-dim tensor on the step's device."""
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)
