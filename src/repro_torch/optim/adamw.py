"""Adam / AdamW with decoupled weight decay (Loshchilov & Hutter).

Counterpart of `repro/optim/adamw.py`, with its update exactly: bias
correction as `m / (1 - b1^t)` and `v / (1 - b2^t)` in float32, and weight
decay inside the update as `u -= lr * wd * p`, added to the Adam step
before `apply_updates`. That is not `torch.optim.AdamW`'s order (which
scales the parameter by `1 - lr * wd` first), so this is plain functions
over dicts of tensors, not a `torch.optim` optimizer.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.base import Optimizer, as_schedule, tree_leaves, tree_map

__all__ = ["AdamState", "adam", "adamw"]


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: Any
    nu: Any


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    mu_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    sched = as_schedule(lr)

    def init(params) -> AdamState:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device), mu=mu, nu=nu)

    def update(grads, state: AdamState, params):
        step = state.step + 1
        lr_t = sched(step)
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step_f)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step_f)

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(mu_dtype), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)

        def upd(m, v, p):
            mhat = m.float() / bc1
            vhat = v / bc2
            u = -lr_t * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u.float()

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)
