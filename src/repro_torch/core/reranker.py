"""OATS-S2: learned re-ranking MLP (§4.2). 2,625 parameters, [7, 64, 32, 1].

Counterpart of `repro/core/reranker.py`. Trained with BCE (Eq. 9) over
outcome-labelled (query, candidate) pairs. At inference the gateway
retrieves C = alpha*K candidates by similarity, rescores them with f_phi
and keeps the top-K by MLP score. Params keep the JAX layout
(`w{i}: [din, dout]`, `b{i}: [dout]`).

Training runs with autograd on the device of its inputs; its init,
permutations and dropout masks are drawn from a CPU `torch.Generator`
seeded with `config.seed` and copied to that device, so one seed trains
the same model on the card as on the CPU, as a JAX key does. The draws
are other numbers than `jax.random`'s from the same seed, so trained
params agree with the reference's only statistically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import optim
from repro_torch.common.device import resolve_device
from repro_torch.core.features import N_FEATURES
from repro_torch.core.retrieval import NEG_INF, stable_topk

__all__ = [
    "LAYERS",
    "RerankerConfig",
    "init_mlp",
    "mlp_forward",
    "mlp_param_count",
    "rerank_topk",
    "rerank_topk_scored",
    "train_reranker",
]

LAYERS = (N_FEATURES, 64, 32, 1)  # paper §4.2: [7, 64, 32, 1] => 2,625 params


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    lr: float = 1e-3
    epochs: int = 30
    batch_size: int = 512
    dropout: float = 0.1  # §5.5
    weight_decay: float = 1e-4
    seed: int = 0
    candidate_multiplier: int = 5  # alpha: retrieve C = alpha*K then re-rank


def init_mlp(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """He-normal weights and zero biases on the generator's device."""
    dev = generator.device
    params = {}
    for li, (din, dout) in enumerate(zip(LAYERS[:-1], LAYERS[1:])):
        params[f"w{li}"] = torch.randn((din, dout), generator=generator, device=dev) * np.sqrt(
            2.0 / din)
        params[f"b{li}"] = torch.zeros((dout,), device=dev)
    return params


def mlp_param_count(params: Dict[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())


def mlp_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """x: [..., 7] -> logits [...]. Sigmoid is applied in the loss/score.

    With `dropout > 0` and a generator, each hidden unit is kept with
    probability 1 - dropout (inverted dropout, masks drawn from it on its
    own device and copied to x's)."""
    h = x
    n_layers = len(LAYERS) - 1
    for li in range(n_layers):
        h = h @ params[f"w{li}"] + params[f"b{li}"]
        if li < n_layers - 1:
            h = torch.relu(h)
            if dropout > 0.0 and generator is not None:
                keep = (torch.rand(h.shape, generator=generator, device=generator.device)
                        < 1.0 - dropout).to(h.device)
                h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h[..., 0]


def _bce_loss(params, x, y, generator, dropout):
    logits = mlp_forward(params, x, dropout=dropout, generator=generator)
    # Eq. 9: binary cross-entropy on outcome labels
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def train_reranker(
    features: Union[np.ndarray, torch.Tensor],  # [N, 7] flattened (query, candidate) rows
    labels: Union[np.ndarray, torch.Tensor],  # [N] outcome o in {0,1}
    config: RerankerConfig = RerankerConfig(),
    device: Union[str, torch.device, None] = None,
) -> tuple[dict, list[float]]:
    """BCE training with AdamW on `device` (None: the card), its draws from
    a CPU generator. Returns (params, per-epoch losses)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    params = {k: v.to(device) for k, v in init_mlp(gen).items()}
    opt = optim.adamw(config.lr, weight_decay=config.weight_decay)
    opt_state = opt.init(params)

    x = torch.as_tensor(features, dtype=torch.float32, device=device)
    y = torch.as_tensor(labels, dtype=torch.float32, device=device)
    n = x.shape[0]
    bs = min(config.batch_size, n)
    steps_per_epoch = max(n // bs, 1)

    def step(params, opt_state, xb, yb):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = _bce_loss(leaves, xb, yb, gen, config.dropout)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss.detach()

    losses = []
    for _ in range(config.epochs):
        perm = torch.randperm(n, generator=gen).to(device)
        epoch_loss = torch.zeros((), device=device)
        for s in range(steps_per_epoch):
            idx = perm[s * bs: s * bs + bs]
            params, opt_state, loss = step(params, opt_state, x[idx], y[idx])
            epoch_loss += loss
        losses.append(float(epoch_loss) / steps_per_epoch)
    return params, losses


def rerank_topk_scored(
    params: Dict[str, torch.Tensor],
    features: torch.Tensor,  # [Q, C, 7] similarity-ordered candidates
    cand_idx: torch.Tensor,  # [Q, C]
    k: int,
    valid: Optional[torch.Tensor] = None,  # [Q, C] — False for padded slots
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score candidates with f_phi; return (top-K ids, their f_phi scores).

    Invalid slots score `NEG_INF`, and the top-K is a stable sort, so they
    rank last and tie toward the lowest slot as `lax.top_k` orders them.
    """
    scores = mlp_forward(params, features)  # [Q, C]
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    top_scores, order = stable_topk(scores, k)
    return torch.gather(cand_idx, 1, order), top_scores


def rerank_topk(
    params: Dict[str, torch.Tensor],
    features: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ids-only wrapper around `rerank_topk_scored`."""
    return rerank_topk_scored(params, features, cand_idx, k, valid)[0]
