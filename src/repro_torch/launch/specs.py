"""Input structs for every (architecture x input shape) program.

Counterpart of `repro/launch/specs.py`. The assigned input shapes:
    train_4k      seq=4,096    global_batch=256   -> train_step
    prefill_32k   seq=32,768   global_batch=32    -> prefill
    decode_32k    seq=32,768   global_batch=128   -> decode_step
    long_500k     seq=524,288  global_batch=1     -> decode_step (sub-quadratic)

Everything here is a struct (`common.sharding.struct`): a fake tensor,
under a mesh a DTensor of this rank's fake block, with the placements of
the same logical rules as the model's. Nothing is allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common.sharding import struct
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

__all__ = ["SHAPES", "ShapeCase", "LONG_CONTEXT_WINDOW", "input_specs", "cache_structs",
           "program_for", "variant_for_shape"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}

# Full-attention architectures run long_500k as an explicit sliding-window
# variant; SSM/hybrid run it natively.
LONG_CONTEXT_WINDOW = 8192


def variant_for_shape(cfg: ModelConfig, shape: ShapeCase) -> ModelConfig:
    """Apply the long-context sliding-window variant where required."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return dataclasses.replace(
            cfg, name=cfg.name + "+swa", sliding_window=LONG_CONTEXT_WINDOW
        )
    return cfg


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def input_specs(cfg: ModelConfig, shape: ShapeCase, mesh=None) -> Dict[str, Any]:
    """Batch structs for the given program kind."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.n_codebooks:
            tokens = struct(mesh, ("batch", None, None), (b, s, cfg.n_codebooks), torch.int32)
        else:
            tokens = struct(mesh, ("batch", None), (b, s), torch.int32)
        batch = {"tokens": tokens}
        if cfg.cross_attn_every:
            batch["image_embeds"] = struct(mesh, ("batch", None, None),
                                           (b, cfg.n_image_tokens, cfg.d_model), _dtype(cfg))
        return batch
    # decode: one new token against a seq_len cache
    if cfg.n_codebooks:
        token = struct(mesh, ("batch", None, None), (b, 1, cfg.n_codebooks), torch.int32)
    else:
        token = struct(mesh, ("batch", None), (b, 1), torch.int32)
    return {"token": token, "pos": struct(None, (), (), torch.int32)}


def cache_structs(cfg: ModelConfig, shape: ShapeCase, mesh=None) -> Dict[str, Any]:
    """Decode-cache structs of `model.cache_spec`, in the model's dtype."""
    spec = M.cache_spec(cfg, shape.global_batch, shape.seq_len)

    def leaf(ps: ParamSpec):
        return struct(mesh, ps.axes, ps.shape, _dtype(cfg))

    return {k: leaf(v) for k, v in spec.items()}


def program_for(kind: str) -> str:
    """Map a shape kind to the (cfg, params, ...) program it lowers."""
    return {"train": "train_step", "prefill": "prefill", "decode": "decode_step"}[kind]
