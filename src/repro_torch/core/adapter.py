"""OATS-S3: contrastive embedding adaptation (§4.3). 197,248 parameters.

Counterpart of `repro/core/adapter.py`. A residual two-layer projection
head h(e) = normalize(e + W2 relu(W1 e + b1) + b2) with W2 zero-init, so
the adapter starts as the identity, with the JAX package's parameter
layout: `w1 [384, 256]`, `b1 [256]`, `w2 [256, 384]`, `b2 [384]`
(`[din, dout]`, so `x @ w`). Trained with InfoNCE (Eq. 6, tau=0.07) over
mined triplets (q, d+, hard d-), combining in-batch negatives with the
mined hard negatives, early-stopped on validation NDCG@5.

Triplet mining is numpy with `np.random.default_rng(seed)`, bitwise the
reference's. Training runs with autograd on the device of its inputs; its
init and permutations are drawn from a CPU `torch.Generator` seeded with
`config.seed` and copied to that device, so one seed trains the same
adapter on the card as on the CPU, as a JAX key does. The draws are other
numbers than `jax.random`'s from the same seed, so trained params agree
with the reference's only statistically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import optim
from repro_torch.common.device import resolve_device
from repro_torch.core.retrieval import NEG_INF, stable_topk
from repro_torch.metrics.retrieval import batched_ndcg_at_k

__all__ = [
    "DIM",
    "HIDDEN",
    "AdapterConfig",
    "init_adapter",
    "adapter_apply",
    "adapter_param_count",
    "mine_triplets",
    "train_adapter",
]

DIM = 384
HIDDEN = 256  # [384, 256, 384] => 197,248 params (98,304+256+98,304+384)


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    lr: float = 1e-5
    temperature: float = 0.07
    epochs: int = 5
    batch_size: int = 128
    n_hard_negatives: int = 4
    seed: int = 0
    # scale the residual branch
    residual_scale: float = 1.0
    # adapt_tools=True is the paper's symmetric deployment: h() applied to
    # both sides, tool embeddings recomputed once at deploy time; False
    # trains h() on queries only, the tool table frozen
    adapt_tools: bool = True


def init_adapter(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh params on the generator's device: He-normal W1, zero W2 (the
    identity at step 0), zero biases."""
    dev = generator.device
    return {
        "w1": torch.randn((DIM, HIDDEN), generator=generator, device=dev) * np.sqrt(2.0 / DIM),
        "b1": torch.zeros((HIDDEN,), device=dev),
        "w2": torch.zeros((HIDDEN, DIM), device=dev),
        "b2": torch.zeros((DIM,), device=dev),
    }


def adapter_param_count(params: Dict[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())


def adapter_apply(
    params: Dict[str, torch.Tensor], emb: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """emb: [..., 384] unit rows -> adapted unit rows (drop-in, same dim)."""
    h = torch.relu(emb @ params["w1"] + params["b1"])
    out = emb + scale * (h @ params["w2"] + params["b2"])
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-9)
    return out / norm


def mine_triplets(
    query_emb: np.ndarray,  # [Q, D] train queries
    tool_emb: np.ndarray,  # [T, D]
    relevance: np.ndarray,  # [Q, T]
    n_hard: int = 4,
    candidate_mask: Optional[np.ndarray] = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triplets (q_idx, pos_tool, [n_hard] hard_neg_tools) (§4.3).

    Hard negatives = highest-similarity non-relevant tools for the query —
    the functional boundaries static embeddings miss. Numpy, as the
    reference.
    """
    rng = np.random.default_rng(seed)
    sims = query_emb @ tool_emb.T
    if candidate_mask is not None:
        sims = np.where(candidate_mask > 0, sims, -np.inf)
    sims = np.where(relevance > 0, -np.inf, sims)  # negatives only
    q_idx, pos, negs = [], [], []
    hard_order = np.argsort(-sims, axis=1)[:, : max(n_hard * 3, n_hard)]
    for j in range(query_emb.shape[0]):
        rel = np.flatnonzero(relevance[j])
        if len(rel) == 0:
            continue
        pool = hard_order[j]
        pool = pool[np.isfinite(sims[j, pool])]
        if len(pool) < n_hard:
            continue
        for t in rel:
            q_idx.append(j)
            pos.append(t)
            negs.append(rng.choice(pool, size=n_hard, replace=False))
    return (
        np.array(q_idx, dtype=np.int64),
        np.array(pos, dtype=np.int64),
        np.stack(negs).astype(np.int64) if negs else np.zeros((0, n_hard), np.int64),
    )


def _info_nce(params, q, pos, negs, temperature, scale, adapt_tools=True):
    """InfoNCE (Eq. 6) with in-batch + mined hard negatives.

    q: [B, D]; pos: [B, D]; negs: [B, H, D]. With `adapt_tools=False` the
    tool-side embeddings pass through unadapted (query-side-only training).
    """
    qa = adapter_apply(params, q, scale)
    if adapt_tools:
        pa = adapter_apply(params, pos, scale)
        na = adapter_apply(params, negs.reshape(-1, negs.shape[-1]), scale).reshape(negs.shape)
    else:
        pa, na = pos, negs
    pos_logit = (qa * pa).sum(-1, keepdim=True)  # [B, 1]
    inbatch = qa @ pa.T  # [B, B] — off-diagonal are in-batch negatives
    mask = torch.eye(qa.shape[0], dtype=torch.bool, device=qa.device)
    inbatch = torch.where(mask, NEG_INF, inbatch)
    hard = torch.einsum("bd,bhd->bh", qa, na)  # [B, H]
    logits = torch.cat([pos_logit, inbatch, hard], dim=1) / temperature
    return -torch.mean(torch.log_softmax(logits, dim=1)[:, 0])


def train_adapter(
    query_emb: Union[np.ndarray, torch.Tensor],
    tool_emb: Union[np.ndarray, torch.Tensor],
    triplets: tuple[np.ndarray, np.ndarray, np.ndarray],
    val_query_emb: Union[np.ndarray, torch.Tensor],
    val_relevance: Union[np.ndarray, torch.Tensor],
    val_candidate_mask: Optional[Union[np.ndarray, torch.Tensor]] = None,
    config: AdapterConfig = AdapterConfig(),
    device: Union[str, torch.device, None] = None,
) -> tuple[dict, dict]:
    """InfoNCE training with early stopping on validation NDCG@5 (§5.5).

    Arrays may be numpy (copied to `device`, None meaning the card) or
    tensors already there; the init and permutations are drawn on the CPU.
    Returns (best params, history).
    """
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    params = {k: v.to(device) for k, v in init_adapter(gen).items()}
    opt = optim.adamw(config.lr)
    opt_state = opt.init(params)

    def on_device(x):
        return None if x is None else torch.as_tensor(x, device=device)

    q_idx, pos_idx, neg_idx = (torch.as_tensor(a, device=device) for a in triplets)
    n = len(q_idx)
    qe, te, vqe, vrel = map(on_device, (query_emb, tool_emb, val_query_emb, val_relevance))
    vmask = on_device(val_candidate_mask)

    def step(params, opt_state, qb, pb, nb):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = _info_nce(leaves, qb, pb, nb, config.temperature, config.residual_scale,
                         config.adapt_tools)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss.detach()

    @torch.no_grad()
    def val_ndcg(params) -> float:
        qa = adapter_apply(params, vqe, config.residual_scale)
        ta = adapter_apply(params, te, config.residual_scale) if config.adapt_tools else te
        sims = qa @ ta.T
        if vmask is not None:
            sims = torch.where(vmask > 0, sims, NEG_INF)
        _, topk = stable_topk(sims, 5)
        return float(batched_ndcg_at_k(topk, vrel))

    best = {"params": params, "ndcg": val_ndcg(params), "epoch": -1}
    history = {"loss": [], "val_ndcg": [best["ndcg"]]}
    bs = min(config.batch_size, max(n, 1))
    if n == 0:
        return params, history
    steps_per_epoch = max(n // bs, 1)
    for epoch in range(config.epochs):
        perm = torch.randperm(n, generator=gen).to(device)
        ep_loss = torch.zeros((), device=device)
        for s in range(steps_per_epoch):
            rows = perm[s * bs: (s + 1) * bs]
            qb = qe[q_idx[rows]]
            pb = te[pos_idx[rows]]
            nb = te[neg_idx[rows].reshape(-1)].reshape(len(rows), -1, DIM)
            params, opt_state, loss = step(params, opt_state, qb, pb, nb)
            ep_loss += loss
        history["loss"].append(float(ep_loss) / steps_per_epoch)
        ndcg = val_ndcg(params)
        history["val_ndcg"].append(ndcg)
        if ndcg > best["ndcg"]:
            best = {"params": params, "ndcg": ndcg, "epoch": epoch}
    return best["params"], history
