"""Adafactor (Shazeer & Stern, 2018) — factored second moments.

Counterpart of `repro/optim/adafactor.py`, with its update exactly. A leaf
whose last two axes are both >= 2 keeps float32 row and column statistics
`{"vr": [..., rows], "vc": [..., cols]}`; any other leaf keeps a full
`{"v"}`. The decay is `beta2 = 1 - t^-decay_rate`, `eps = 1e-30` guards
every division, and each leaf's update is clipped to an RMS of at most
`clip_threshold`. The state's `stats` tree is the params tree with each
leaf replaced by its statistics dict. Used by `training.train_step` for
the configs above 3e10 params, whose Adam state would not fit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.base import Optimizer, as_schedule, tree_leaves, tree_map

__all__ = ["AdafactorState", "adafactor"]


class AdafactorState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    # per leaf: {"vr", "vc"} (factored) or {"v"} (full), float32
    stats: Any


def _should_factor(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(
    lr,
    decay_rate: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    min_dim_size_to_factor: int = 2,
) -> Optimizer:
    sched = as_schedule(lr)

    def _init_leaf(p):
        if _should_factor(p.shape):
            return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),  # row stats
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32)}
        return {"v": p.new_zeros(p.shape, dtype=torch.float32)}

    def init(params) -> AdafactorState:
        device = tree_leaves(params)[0].device
        return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=device),
                              stats=tree_map(_init_leaf, params))

    def update(grads, state: AdafactorState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-decay_rate)
        lr_t = sched(step)

        def upd_leaf(g, s):
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                # factored preconditioner
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                precond = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                precond = g / (torch.sqrt(v) + eps)
                new_s = {"v": v}
            # update clipping (RMS of update <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(precond)) + eps)
            precond = precond / torch.clamp(rms / clip_threshold, min=1.0)
            return -lr_t * precond, new_s

        out = tree_map(upd_leaf, grads, state.stats)  # a (update, stats) pair a leaf
        updates = tree_map(lambda pair: pair[0], out)
        stats = tree_map(lambda pair: pair[1], out)
        return updates, AdafactorState(step=step, stats=stats)

    return Optimizer(init=init, update=update)
