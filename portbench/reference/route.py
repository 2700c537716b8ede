"""The gateway's answer worked out again: each query's word vectors
mean-pooled and L2-normalised, scored against every table row in float32
(TF32 off), the k best kept. Imports nothing of the program."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def encode(word_vecs: torch.Tensor, queries: Sequence[np.ndarray]) -> torch.Tensor:
    """[Q, D] float32 unit rows (a zero row for an empty query)."""
    rows = []
    for q in queries:
        if len(q) == 0:
            rows.append(torch.zeros(word_vecs.shape[1], device=word_vecs.device))
            continue
        v = word_vecs[torch.as_tensor(np.asarray(q), device=word_vecs.device)].mean(dim=0)
        rows.append(v / v.norm().clamp_min(1e-9))
    return torch.stack(rows)


def scores(q: torch.Tensor, table: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """q @ table.T in float32; `tf32` multiplies in TF32 instead (the
    control's precision for a float32 product)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        if tf32 and q.device.type == "cpu":  # the CPU has no TF32: round the operands
            q, table = (t.view(torch.int32).bitwise_and(~0x1FFF).view(torch.float32)
                        for t in (q, table))
        return q @ table.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def route_error(q: torch.Tensor, table: torch.Tensor, ids: np.ndarray, got: np.ndarray,
                tf32: bool = False, block: int = 256) -> Tuple[float, List[float]]:
    """How far the answers `ids` [Q, k] with their scores `got` [Q, k] lie
    from the exact top-k: for each query and rank r, the larger of
    |got[r] - best[r]| and |score(ids[r]) - best[r]|, where best is the
    reference's descending top-k and score() its exact score of a row. A
    repeated or out-of-range id counts as infinite. Returns (the largest
    over all, the largest of each query)."""
    per_query: List[float] = []
    k = ids.shape[1]
    for at in range(0, q.shape[0], block):
        s = scores(q[at:at + block], table, tf32)
        best = torch.topk(s, k, dim=1).values
        idx = torch.as_tensor(ids[at:at + block], device=s.device, dtype=torch.int64)
        bad = ((idx < 0) | (idx >= table.shape[0])).any(dim=1)
        srt = idx.sort(dim=1).values
        bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
        at_id = s.gather(1, idx.clamp(0, table.shape[0] - 1))
        g = torch.as_tensor(got[at:at + block], device=s.device, dtype=torch.float32)
        err = torch.maximum((g - best).abs(), (at_id - best).abs()).amax(dim=1)
        err = torch.where(bad, torch.full_like(err, float("inf")), err)
        per_query += err.double().cpu().tolist()
    return (max(per_query) if per_query else 0.0), per_query


def control_answers(q: torch.Tensor, table: torch.Tensor, k: int,
                    block: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """The control's answers: top-k of the TF32 scores (ids, scores)."""
    ids, vals = [], []
    for at in range(0, q.shape[0], block):
        v, i = torch.topk(scores(q[at:at + block], table, tf32=True), k, dim=1)
        ids.append(i.cpu().numpy())
        vals.append(v.cpu().numpy())
    return np.concatenate(ids), np.concatenate(vals)
