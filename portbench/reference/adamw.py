"""AdamW with decoupled weight decay, and the warmup-cosine schedule, as
the configuration's training job states them: the gradients clipped to a
global norm, then m and v in float32, bias-corrected, the update
-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) added to the parameter,
which is stored back in its own dtype. Plain PyTorch; imports nothing of
the program."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def lr_at(step: int, tc: Mapping) -> float:
    """Linear warmup to the peak over `warmup_steps`, then a cosine to 0
    at `total_steps`; computed in float32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    peak, warm_n, total = tc["learning_rate"], tc["warmup_steps"], tc["total_steps"]
    if step < warm_n:
        return float(peak * torch.clamp(s / max(warm_n, 1), max=1.0))
    t = torch.clamp((s - warm_n) / max(total - warm_n, 1), 0.0, 1.0)
    return float(peak * 0.5 * (1.0 + torch.cos(math.pi * t)))


class AdamW:
    def __init__(self, tc: Mapping, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.tc, self.b1, self.b2, self.eps = dict(tc), b1, b2, eps
        self.step = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
        scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
        return {k: g.float() * scale for k, g in grads.items()}

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """New parameters (in the dtypes of `params`) from clipped `grads`;
        the clipped gradients are kept as `last_grads`."""
        self.step += 1
        g = self.clip(grads, self.tc["grad_clip"])
        self.last_grads = g
        lr = lr_at(self.step, self.tc)
        bc1 = 1.0 - self.b1 ** self.step
        bc2 = 1.0 - self.b2 ** self.step
        wd = self.tc["weight_decay"]
        out = {}
        for k, p in params.items():
            m = self.mu.get(k, torch.zeros_like(g[k]))
            v = self.nu.get(k, torch.zeros_like(g[k]))
            m = self.b1 * m + (1 - self.b1) * g[k]
            v = self.b2 * v + (1 - self.b2) * g[k].square()
            self.mu[k], self.nu[k] = m, v
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps) - lr * wd * p.float()
            out[k] = (p.float() + u).to(p.dtype)
        return out
