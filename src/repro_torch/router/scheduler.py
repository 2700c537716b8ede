"""Continuous-batching scheduler for the backend decode pool.

Counterpart of `repro/router/scheduler.py`. The paper's gateway (Fig. 1b)
forwards requests to model pools; this is the pool-side scheduler: a fixed
number of decode *slots*, requests admitted from a queue as slots free up,
prefill on admission (batch 1, spliced into the slot's cache rows), one
batched decode step per tick (all active slots advance together at the
largest active position, as the reference steps them), and retirement when
a request has its tokens or its slot reaches `max_len - 1`. When given a
`SemanticRouter`, admission tool-routes the requests it is about to admit
in one `route_batch` call. Decode is eager PyTorch on the params' device;
prefill runs the hand-written kernels there (`models/layers.py`,
`models/ssm.py`). As in the reference, a codebook model's slots carry K
ids a token (each generated token is a list of K ids), and a VLM's
requests are prefilled with zero image embeddings, their image K/V
spliced into the slot's rows like every other cache entry. An MoE
model's decode runs all `n_slots` rows, empty ones too, through its
experts: they take capacity, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, tree_leaves

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # [S] (or [S, K] for codebook archs)
    max_new_tokens: int
    tools: Optional[List[int]] = None  # attached by the semantic router
    query_tokens: Optional[np.ndarray] = None  # routed at admission when set
    route_result: Optional[object] = None  # RouteResult from batched routing
    # filled by the scheduler
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_at_tick: int = -1
    finished_at_tick: int = -1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ContinuousBatcher:
    """Fixed-slot continuous batching over (prefill, decode_step).

    `params` must live on `device` (`None` means the CUDA card). The decode
    cache is updated in place by `decode_step`.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        n_slots: int = 4,
        max_len: int = 256,
        sample: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        router=None,  # Optional[SemanticRouter]: batch-routes at admission
        device: Union[str, torch.device, None] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_len = max_len
        self.sample = sample or (lambda logits: torch.argmax(logits, dim=-1))
        self.router = router
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int32)  # next position
        self.tick_count = 0
        self.completed: List[Request] = []
        self._prefill = lambda p, b: M.prefill(cfg, p, b, max_cache_len=max_len)
        self._decode = lambda p, c, b: M.decode_step(cfg, p, c, b)
        self._cache = self._empty_cache()
        self._tokens = torch.zeros(self._token_shape(n_slots), dtype=torch.int64,
                                   device=self.device)

    # ---------------------------------------------------------------- setup
    def _empty_cache(self) -> Dict[str, torch.Tensor]:
        dtype = getattr(torch, self.cfg.dtype)
        return {
            name: torch.zeros(s.shape, dtype=dtype, device=self.device)
            for name, s in tree_leaves(M.cache_spec(self.cfg, self.n_slots, self.max_len))
            if isinstance(s, ParamSpec)
        }

    def _token_shape(self, rows: int):
        return (rows, 1, self.cfg.n_codebooks) if self.cfg.n_codebooks else (rows, 1)

    def _generated(self, tok: np.ndarray):
        """One row's sampled token as a request records it: an int, or the
        list of K codebook ids."""
        return tok.reshape(-1).tolist() if self.cfg.n_codebooks else int(tok.reshape(-1)[0])

    # ------------------------------------------------------------- admission
    def submit(self, req: Request):
        self.queue.append(req)

    def _route_admissible(self):
        """Tool-route the queue head in ONE `route_batch` call.

        Only the requests that can actually be admitted this tick (up to the
        number of free slots) are routed, so routing work tracks admission
        rate rather than queue depth.
        """
        if self.router is None:
            return
        free = sum(1 for s in self.slots if s is None)
        head = itertools.islice(self.queue, free)
        pending = [r for r in head if r.tools is None and r.query_tokens is not None]
        if not pending:
            return
        results = self.router.route_batch([r.query_tokens for r in pending])
        for req, res in zip(pending, results):
            req.tools = res.tools
            req.route_result = res

    def _admit(self):
        self._route_admissible()
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.admitted_at_tick = self.tick_count
            # prefill this request alone (batch-1) and splice into the cache
            batch = {"tokens": torch.as_tensor(np.asarray(req.prompt)[None], device=self.device)}
            if self.cfg.cross_attn_every:
                batch["image_embeds"] = torch.zeros(
                    (1, self.cfg.n_image_tokens, self.cfg.d_model),
                    dtype=getattr(torch, self.cfg.dtype), device=self.device)
            logits, cache1 = self._prefill(self.params, batch)
            self._splice_cache(slot, cache1)
            tok = self.sample(logits[:, -1])
            req.generated.append(self._generated(tok.cpu().numpy()))
            self._tokens[slot] = tok.reshape(self._token_shape(1))[0]
            self.slots[slot] = req
            self.slot_pos[slot] = len(req.prompt)

    def _splice_cache(self, slot: int, cache1: Dict[str, torch.Tensor]):
        for name, full in self._cache.items():
            full[:, slot:slot + 1] = cache1[name].to(full.dtype)

    # ------------------------------------------------------------------ tick
    def tick(self) -> Dict[str, int]:
        """Admit -> one batched decode step -> retire finished requests."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if active:
            # positions differ per slot; decode_step takes one position, so
            # every slot steps at the largest (as the reference does)
            pos = int(self.slot_pos[active].max())
            logits, self._cache = self._decode(
                self.params, self._cache, {"token": self._tokens, "pos": pos},
            )
            toks = self.sample(logits[:, -1]).reshape(self._token_shape(self.n_slots))
            self._tokens[active] = toks[active]  # empty slots keep their pad token
            host = toks.cpu().numpy()
            for i in active:
                req = self.slots[i]
                req.generated.append(self._generated(host[i]))
                self.slot_pos[i] += 1
                if req.done or self.slot_pos[i] >= self.max_len - 1:
                    req.finished_at_tick = self.tick_count
                    self.completed.append(req)
                    self.slots[i] = None
        self.tick_count += 1
        return {
            "tick": self.tick_count,
            "active": len(active),
            "queued": len(self.queue),
            "completed": len(self.completed),
        }

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        while (self.queue or any(s is not None for s in self.slots)) and self.tick_count < max_ticks:
            self.tick()
        return self.completed
