"""SGD with (Nesterov) momentum.

Counterpart of `repro/optim/sgd.py`: momentum kept in float32,
`m = momentum * m + g`, and the update `-lr * m`, or with Nesterov
`-lr * (momentum * m + g)` on the new `m`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.base import Optimizer, as_schedule, tree_leaves, tree_map

__all__ = ["SgdState", "sgd"]


class SgdState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    momentum: Any


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = as_schedule(lr)

    def init(params) -> SgdState:
        m = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return SgdState(step=torch.zeros((), dtype=torch.int32, device=device), momentum=m)

    def update(grads, state: SgdState, params):
        step = state.step + 1
        lr_t = sched(step)
        m = tree_map(lambda m_, g: momentum * m_ + g.float(), state.momentum, grads)
        if nesterov:
            upd = tree_map(lambda m_, g: -lr_t * (momentum * m_ + g.float()), m, grads)
        else:
            upd = tree_map(lambda m_: -lr_t * m_, m)
        return upd, SgdState(step=step, momentum=m)

    return Optimizer(init=init, update=update)
