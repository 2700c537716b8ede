"""Carry the JAX package's arrays across to the port.

Parameters, tool tables and vocab word vectors keep their layouts in both
packages (`[din, dout]` weights, `[T, D]` tables, `[V, D]` word vectors),
so conversion is a copy onto a device and never a transpose. The caller
hands over numpy arrays (`np.asarray` of a JAX array, or a pytree of
them): the port imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.features import OutcomeFeaturizer
from repro_torch.router.stages import StageSet

__all__ = ["params_from_jax", "stages_from_jax"]

Device = Union[str, torch.device, None]


def params_from_jax(tree: Any, device: Device = None) -> Any:
    """A (nested) dict of arrays, or one array, as torch tensors on `device`.

    Values are copied with their dtype and shape unchanged. bfloat16 arrays
    (numpy's `ml_dtypes.bfloat16`, which `torch.from_numpy` does not take)
    cross as their 16-bit patterns and are viewed as `torch.bfloat16`.
    """
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def stages_from_jax(
    adapter_params: Optional[Mapping[str, Any]] = None,
    mlp_params: Optional[Mapping[str, Any]] = None,
    featurizer: Optional[OutcomeFeaturizer] = None,
    adapter_scale: float = 1.0,
    device: Device = None,
) -> StageSet:
    """A `StageSet` whose adapter and MLP params live on `device`."""
    device = resolve_device(device)
    return StageSet(
        adapter_params=None if adapter_params is None else params_from_jax(adapter_params, device),
        adapter_scale=adapter_scale,
        mlp_params=None if mlp_params is None else params_from_jax(mlp_params, device),
        featurizer=featurizer,
    )
