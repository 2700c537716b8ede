"""Plain-function optimizers over dicts of tensors (no `torch.optim`).

Counterpart of `repro/optim`, with the same gradient-transformation
interface and the same update rules:

    opt = adamw(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Only what the learned stages use is ported: `adamw`/`adam` and the helpers
of `base.py`.
"""
from repro_torch.optim.adamw import AdamState, adam, adamw
from repro_torch.optim.base import (
    Optimizer,
    apply_updates,
    as_schedule,
    clip_by_global_norm,
    global_norm,
    tree_map,
)

__all__ = [
    "AdamState",
    "Optimizer",
    "adam",
    "adamw",
    "apply_updates",
    "as_schedule",
    "clip_by_global_norm",
    "global_norm",
    "tree_map",
]
