"""Plain-function optimizers over dicts of tensors (no `torch.optim`).

Counterpart of `repro/optim`, with the same gradient-transformation
interface, the same update rules and the same exports:

    opt = adamw(lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The learned stages use `adamw`; the backend trainer (`training/`) picks
`adamw`, `adafactor` or `sgd` under a `warmup_cosine` schedule.
"""
from repro_torch.optim.adafactor import AdafactorState, adafactor
from repro_torch.optim.adamw import AdamState, adam, adamw
from repro_torch.optim.base import (
    Optimizer,
    apply_updates,
    as_schedule,
    clip_by_global_norm,
    global_norm,
    tree_map,
)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup, warmup_cosine
from repro_torch.optim.sgd import SgdState, sgd

__all__ = [
    "AdafactorState",
    "AdamState",
    "Optimizer",
    "SgdState",
    "adafactor",
    "adam",
    "adamw",
    "apply_updates",
    "as_schedule",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "global_norm",
    "linear_warmup",
    "sgd",
    "tree_map",
    "warmup_cosine",
]
