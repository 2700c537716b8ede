"""Train-step factory: loss -> grads -> clip -> optimizer -> params.

Counterpart of `repro/training/train_step.py`. The optimizer is chosen per
model size: Adafactor for the very large assigned architectures (fp32
Adam state would not fit), AdamW otherwise. Params are a tree of leaf
tensors with `requires_grad`; the step takes grads with autograd through
`loss_fn` (the plain attention and scan, `use_kernel=False`) and returns
new leaves, as the reference's pure step returns new params. No
`torch.optim` is kept: the update rules are the reference's, in
`repro_torch.optim`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch import optim
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.base import tree_leaves

__all__ = ["ADAFACTOR_THRESHOLD", "TrainConfig", "choose_optimizer", "make_train_step"]

ADAFACTOR_THRESHOLD = 30_000_000_000  # params; above this, factored states


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "auto"  # auto | adamw | adafactor | sgd


def choose_optimizer(cfg: ModelConfig, tc: TrainConfig) -> optim.Optimizer:
    name = tc.optimizer
    if name == "auto":
        name = "adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD else "adamw"
    sched = optim.warmup_cosine(tc.learning_rate, tc.warmup_steps, tc.total_steps)
    if name == "adamw":
        return optim.adamw(sched, weight_decay=tc.weight_decay)
    if name == "adafactor":
        return optim.adafactor(sched)
    if name == "sgd":
        return optim.sgd(sched, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


def make_train_step(
    cfg: ModelConfig, tc: TrainConfig = TrainConfig()
) -> Tuple[Callable, optim.Optimizer]:
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), optimizer). `metrics` holds 0-dim tensors: "loss", "ce",
    "aux" and "grad_norm" (before clipping); reading one waits for the
    device, which the step itself never does."""
    optimizer = choose_optimizer(cfg, tc)

    def train_step(params, opt_state, batch):
        loss, metrics = M.loss_fn(cfg, params, batch)
        leaves = tree_leaves(params)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = optim.tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            grads, gnorm = optim.clip_by_global_norm(grads, tc.grad_clip)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optim.tree_map(lambda p: p.detach(), params)
            params = optim.apply_updates(params, updates)
        params = optim.tree_map(lambda p: p.requires_grad_(), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step, optimizer
