"""Training loop: metrics, checkpointing, determinism.

Counterpart of `repro/training/trainer.py`, on one device: `device=`
takes the place of the reference's `mesh=` (None means the CUDA card,
which raises without one; the tests pass "cpu"). The model is
`M.init(cfg, ...)` drawn from a CPU generator seeded with `tcfg.seed` and
copied to the device, so one seed names one model on the card and on the
CPU (the JAX package's `PRNGKey` draws other numbers: a test that holds
the two trainers against each other carries one init across).

`save` and `restore` go through the port's `checkpoint/msgpack_ckpt.py`,
whose files cross both ways: the optimizer state (a NamedTuple) is
written as a list in its field order, as the reference's is, and
`restore` pairs what it reads with the trainer's own state by dict key
and field, so it reads a checkpoint that the JAX `Trainer` wrote.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_ckpt import restore_checkpoint, save_checkpoint
from repro_torch.common.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.base import tree_map
from repro_torch.training.train_step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0  # 0 = no checkpoints
    ckpt_dir: str = "checkpoints"
    seed: int = 0
    train: TrainConfig = TrainConfig()


def _like(template: Any, loaded: Any, device: torch.device, path: str = "") -> Any:
    """`loaded` (what a checkpoint holds: dicts, lists, numpy arrays or
    bfloat16 tensors) in the structure of `template`, paired by dict key
    and NamedTuple field, each leaf a tensor on `device`."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"checkpoint at {path or '/'} does not match the trainer's keys "
                             f"{sorted(template)}")
        return {k: _like(v, loaded[k], device, f"{path}/{k}") for k, v in template.items()}
    if isinstance(template, tuple):
        if not isinstance(loaded, list) or len(loaded) != len(template):
            raise ValueError(f"checkpoint at {path} does not match {type(template).__name__}")
        return type(template)(*(_like(t, x, device, f"{path}/{name}") for t, x, name in
                                zip(template, loaded, template._fields)))
    leaf = torch.as_tensor(loaded).to(device)
    if leaf.shape != template.shape or leaf.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {path}: {leaf.dtype} {tuple(leaf.shape)}, the "
                         f"trainer's {template.dtype} {tuple(template.shape)}")
    return leaf


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        device: Union[str, torch.device, None] = None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.step_fn, self.optimizer = make_train_step(cfg, tcfg.train)
        params = M.init(cfg, torch.Generator().manual_seed(tcfg.seed), "cpu")
        self.params = tree_map(lambda p: p.to(self.device).requires_grad_(), params)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self.history: List[Dict[str, float]] = []

    def restore(self, directory: Optional[str] = None):
        d = directory or self.tcfg.ckpt_dir
        step, tree, _ = restore_checkpoint(d)
        params = _like(self.params, tree["params"], self.device, "params")
        self.params = tree_map(lambda p: p.requires_grad_(), params)
        self.opt_state = _like(self.opt_state, tree["opt_state"], self.device, "opt_state")
        self.step = step

    def save(self):
        save_checkpoint(
            self.tcfg.ckpt_dir,
            self.step,
            {"params": self.params, "opt_state": self.opt_state},
            meta={"arch": self.cfg.name, "step": self.step},
        )

    def fit(self, batches: Iterator[Dict[str, np.ndarray]], log: Callable = print):
        t0 = time.time()
        for _ in range(self.tcfg.steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in next(batches).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                m["wall_s"] = round(time.time() - t0, 1)
                self.history.append(m)
                log(
                    f"step {self.step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} [{m['wall_s']}s]"
                )
            if self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.history
