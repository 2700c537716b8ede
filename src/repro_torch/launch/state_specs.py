"""Optimizer-state structs (with placements) for the dry-run.

Counterpart of `repro/launch/state_specs.py`. Optimizer state mirrors
parameter sharding: Adam's mu/nu inherit the param's logical axes;
Adafactor's factored vr/vc drop the reduced dimension's axis. Built straight
from the ParamSpec tree as structs (`common.sharding.struct`), so the
dry-run never allocates.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.sharding import struct
from repro_torch.models.params import ParamSpec, map_specs
from repro_torch.optim.adafactor import AdafactorState, _should_factor
from repro_torch.optim.adamw import AdamState
from repro_torch.optim.sgd import SgdState

__all__ = ["opt_state_structs"]


def _mirror(specs, mesh, dtype=torch.float32):
    return map_specs(lambda s: struct(mesh, s.axes, s.shape, dtype), specs)


def _scalar(dtype=torch.int32):
    return struct(None, (), (), dtype)


def opt_state_structs(optimizer_name: str, specs, mesh) -> Any:
    if optimizer_name == "adamw":
        return AdamState(step=_scalar(), mu=_mirror(specs, mesh), nu=_mirror(specs, mesh))
    if optimizer_name == "sgd":
        return SgdState(step=_scalar(), momentum=_mirror(specs, mesh))
    if optimizer_name == "adafactor":

        def leaf(s: ParamSpec):
            if _should_factor(s.shape):
                return {
                    "vr": struct(mesh, s.axes[:-1], s.shape[:-1], torch.float32),
                    "vc": struct(mesh, s.axes[:-2] + s.axes[-1:],
                                 s.shape[:-2] + s.shape[-1:], torch.float32),
                }
            return {"v": struct(mesh, s.axes, s.shape, torch.float32)}

        return AdafactorState(step=_scalar(), stats=map_specs(leaf, specs))
    raise ValueError(f"unknown optimizer {optimizer_name!r}")
