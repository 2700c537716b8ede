"""Frozen bag-of-word-vectors encoder (the production router's e(.), §5.5).

Counterpart of `repro/embedding/bag_encoder.py`. Stands in for
all-MiniLM-L6-v2: mean-pool word vectors, L2-normalize. The ragged
`encode` stays numpy on the host (the gateway's `embed_batch_fn`, exactly
as the JAX launcher wires it); the padded `encode_padded` is PyTorch on the
encoder's `device` and agrees with it.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.embedding.vocab import Vocab

__all__ = ["BagEncoder", "pad_token_lists"]


class BagEncoder:
    def __init__(self, vocab: Vocab, device: Union[str, torch.device, None] = None):
        self.vocab = vocab
        self.device = resolve_device(device)
        self.word_vecs = vocab.word_vecs  # [V, 384] float32
        self._word_vecs_t = torch.from_numpy(
            np.ascontiguousarray(self.word_vecs, np.float32)
        ).to(self.device)

    @property
    def dim(self) -> int:
        return self.word_vecs.shape[1]

    # ---- ragged numpy path (host) ---------------------------------------
    def encode(self, token_lists: Sequence[np.ndarray]) -> np.ndarray:
        out = np.zeros((len(token_lists), self.dim), dtype=np.float32)
        for i, toks in enumerate(token_lists):
            if len(toks) == 0:
                continue
            v = self.word_vecs[np.asarray(toks)].mean(axis=0)
            n = np.linalg.norm(v)
            out[i] = v / max(n, 1e-9)
        return out

    def encode_one(self, tokens: np.ndarray) -> np.ndarray:
        return self.encode([tokens])[0]

    # ---- padded torch path (on `device`) --------------------------------
    def encode_padded(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids: [B, L] int, mask: [B, L] {0,1}. Returns [B, 384] unit rows."""
        ids = torch.as_tensor(ids, device=self.device).long()
        mask = torch.as_tensor(mask, device=self.device)
        vecs = self._word_vecs_t[ids]  # [B, L, D]
        m = mask[..., None].to(vecs.dtype)
        summed = (vecs * m).sum(dim=1)
        count = m.sum(dim=1).clamp_min(1.0)
        mean = summed / count
        norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp_min(1e-9)
        return mean / norm


def pad_token_lists(
    token_lists: Sequence[np.ndarray], max_len: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged token lists into (ids, mask) for the padded path."""
    if max_len is None:
        max_len = max((len(t) for t in token_lists), default=1)
        max_len = max(max_len, 1)
    ids = np.zeros((len(token_lists), max_len), dtype=np.int32)
    mask = np.zeros((len(token_lists), max_len), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        n = min(len(toks), max_len)
        ids[i, :n] = np.asarray(toks)[:n]
        mask[i, :n] = 1
    return ids, mask
