"""Checkpointing: msgpack + compressed pytrees (see msgpack_ckpt), in the
JAX package's file format, with no dependency beyond numpy and torch.

Re-exported at package level so stateful subsystems (the control plane's
OutcomeStore) can depend on `repro_torch.checkpoint` without naming the
backend module.
"""
from repro_torch.checkpoint.msgpack_ckpt import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
