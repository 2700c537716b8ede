"""IVFBackend: coarse k-means quantization + int8 candidate scoring + exact
re-rank — sublinear per-query work for MCP-registry-scale tool tables.

Counterpart of `repro/index/ivf.py`, with the index on the backend's
`device` (`None` means the CUDA card). Per query it scores C ≈ 4·√T
centroids, visits the `nprobe` closest clusters, shortlists their members
with int8 codes and re-ranks the shortlist exactly in float32: at 100k
tools and the default nprobe = 8 a query touches ~650 candidate rows
instead of 100k.

Build (deterministic in `config.seed`):

  * every random draw stays on the host, from
    `np.random.default_rng(config.seed)` in the reference's order — the
    train subsample, the seed centroids, the reseeding of dead centroids —
    so both packages start k-means from the same rows;
  * spherical k-means on the device (matmul, argmax, `index_add_`,
    `bincount`, unit rows), trained on a bounded sample (`train_sample`)
    and then one full assignment pass. Its dtypes follow the reference's
    numpy promotions: the first assignment scores float32 centroids, the
    update divides by integer counts and so yields float64 centroids, and
    the later assignments score in float64; the final centroids are
    float32. An unchanged assignment ends the loop (`kmeans_iters_run`),
    which is what makes a warm start cheap;
  * members stored CSR-style in cluster order (`member_ids` + `offsets`,
    a stable sort by cluster), so a cluster is a contiguous slice;
  * member rows stored as int8 codes with per-dimension scales from
    `models/quant.quantize_tree` (the scale rounded to bf16, as the
    reference stores it), and the float32 table kept for the exact
    re-rank, so the scores a query returns are true similarities of the
    indexed table (the contract `RouteResult.scores` depends on).

Query, cluster-major in one pass over the batch instead of the reference's
Python loop over clusters: the batch's probed clusters are gathered once
through the CSR offsets into one block of code rows (each probed cluster
once, however many queries probe it), the int8 scales are folded into the
queries, one product scores the block for every query, and a row outside a
query's probed clusters scores `NEG_INF`. `topk` shortlists
`rerank_multiplier · k` candidates per query, the shortlist is re-scored
exactly from the gathered float32 table rows, and the top-k is ordered by
score, ties to the lowest tool index. A query whose probed clusters hold
fewer rows than the shortlist quota (tiny or skewed tables; rare) extends
its probes in coarse order on the host, as the reference does. Slots with
fewer than k reachable candidates pad `NEG_INF` with index 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.retrieval import NEG_INF, stable_topk
from repro_torch.models.quant import quantize_tree

__all__ = ["IVFConfig", "IVFBackend"]


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    n_clusters: Optional[int] = None  # default: ~4·√T, clamped to [1, T//4]
    nprobe: int = 8  # clusters visited per query (floor; see shortlist quota)
    kmeans_iters: int = 6
    train_sample: int = 20_000  # k-means training subsample bound
    rerank_multiplier: int = 8  # exact-re-rank shortlist = multiplier · k
    seed: int = 0


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-9)


def _chunked_argmax_sim(x: torch.Tensor, centroids: torch.Tensor,
                        chunk: int = 8192) -> torch.Tensor:
    """argmax_c <x_i, centroid_c> (first maximum on ties) without the full
    [N, C] block, in the centroids' dtype."""
    x = x.to(centroids.dtype)
    return torch.cat([torch.argmax(x[lo:lo + chunk] @ centroids.T, dim=1)
                      for lo in range(0, x.shape[0], chunk)])


class IVFBackend:
    name = "ivf"
    supports_masks = False
    # k-means takes seconds at registry scale: the manager builds it on a
    # background thread and serves the exact fallback meanwhile
    build_is_cheap = False

    def __init__(
        self,
        table: np.ndarray,
        table_version: int,
        config: IVFConfig = IVFConfig(),
        warm_start=None,
        device: Union[str, torch.device, None] = None,
    ):
        """`warm_start`: centroids from a previous index over an earlier
        version of this table (`warm_start_state()`, a tensor or an array),
        used to seed k-means instead of random rows. Control-plane swaps
        move the table gently, so warm-started k-means converges in a
        fraction of the iterations — the manager passes it automatically
        on swap-triggered rebuilds. A shape-incompatible warm start
        (different cluster count/dim) is ignored."""
        self.device = resolve_device(device)
        table = np.asarray(table, np.float32)
        self.table_version = int(table_version)
        self.config = config
        self.n_tools, d = table.shape
        dev = self.device
        self._table = torch.from_numpy(np.ascontiguousarray(table)).to(dev)  # exact re-rank
        rng = np.random.default_rng(config.seed)

        n_clusters = config.n_clusters or int(round(4 * math.sqrt(self.n_tools)))
        n_clusters = max(1, min(n_clusters, max(self.n_tools // 4, 1)))
        self.n_clusters = n_clusters

        # ---- spherical k-means (sampled train, full final assign) ---------
        if self.n_tools > config.train_sample:
            pick = rng.choice(self.n_tools, config.train_sample, replace=False)
            train = self._table[torch.from_numpy(pick).to(dev)]
        else:
            train = self._table
        if warm_start is not None and tuple(np.shape(warm_start)) == (n_clusters, d):
            centroids = _unit_rows(torch.as_tensor(warm_start, dtype=torch.float32,
                                                   device=dev).clone())
        else:
            seeds = rng.choice(len(train), n_clusters, replace=False)
            centroids = train[torch.from_numpy(seeds).to(dev)].clone()
        prev_assign: Optional[torch.Tensor] = None
        iters_run = 0
        for _ in range(config.kmeans_iters):
            assign = _chunked_argmax_sim(train, centroids)
            if prev_assign is not None and torch.equal(assign, prev_assign):
                # converged: re-updating from an identical assignment is the
                # identity, so the remaining iterations are pure waste
                break
            prev_assign = assign
            iters_run += 1
            sums = torch.zeros_like(centroids).index_add_(0, assign, train.to(centroids.dtype))
            counts = torch.bincount(assign, minlength=n_clusters)
            # float / integer counts promotes to float64, as in numpy
            centroids = _unit_rows(sums.double() / torch.clamp(counts, min=1)[:, None])
            empty = counts == 0
            n_empty = int(empty.sum())
            if n_empty:  # re-seed dead centroids from random train rows
                reseed = torch.from_numpy(rng.choice(len(train), n_empty)).to(dev)
                centroids[empty] = train[reseed].double()
        self.kmeans_iters_run = iters_run
        self.centroids = centroids.to(torch.float32)

        # ---- inverted lists: CSR layout in cluster order ------------------
        assign = _chunked_argmax_sim(self._table, self.centroids)
        order = torch.argsort(assign, stable=True)
        self.member_ids = order  # int64
        self._sizes = torch.bincount(assign, minlength=n_clusters)
        self.offsets = torch.cat([self._sizes.new_zeros(1), torch.cumsum(self._sizes, 0)])
        self._sizes_host = self._sizes.cpu().numpy()

        # ---- int8 cluster storage (models/quant machinery) ----------------
        leaf = quantize_tree({"codes": self._table[order]})["codes"]
        if isinstance(leaf, dict):  # {"q": int8 [T, D], "scale": bf16 [1, D]}
            self._codes = leaf["q"]
            self._scale = leaf["scale"].to(torch.float32).reshape(-1)
        else:  # tiny tables fall below quant's size floor; store fp32 codes
            self._codes = leaf
            self._scale = torch.ones(d, dtype=torch.float32, device=dev)
        self._max_cluster = int(self._sizes_host.max(initial=1))
        self._dim = d

    def warm_start_state(self) -> torch.Tensor:
        """Centroids to seed the next rebuild's k-means (see `warm_start`);
        `ToolIndexManager` passes them on a swap-triggered rebuild."""
        return self.centroids

    # ------------------------------------------------------------------ query
    def _probed(self, qc: torch.Tensor, nprobe: int, quota: int) -> torch.Tensor:
        """[Q, C] bool: the clusters each query visits — its `nprobe`
        coarse-closest, extended in coarse order on the host for the rare
        query whose clusters hold fewer rows than `quota`."""
        if nprobe < self.n_clusters:
            probed = torch.zeros_like(qc, dtype=torch.bool)
            probed.scatter_(1, torch.topk(qc, nprobe, dim=1).indices, True)
        else:
            probed = torch.ones_like(qc, dtype=torch.bool)
        n_cand = (probed * self._sizes).sum(dim=1)
        under = torch.nonzero(n_cand < quota).flatten().tolist()
        if under:
            qc_host = qc[under].cpu().numpy()
            for row, j in enumerate(under):
                ranked = np.argsort(-qc_host[row], kind="stable")
                n_cum = np.cumsum(self._sizes_host[ranked])
                stop = int(np.searchsorted(n_cum, quota)) + 1
                probed[j, torch.from_numpy(ranked[: max(stop, nprobe)]).to(qc.device)] = True
        return probed

    def topk(
        self,
        queries: np.ndarray,
        k: int,
        candidate_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        assert candidate_mask is None, (
            "IVFBackend cannot honor candidate masks (tools outside the probed "
            "clusters would silently vanish); ToolIndexManager routes masked "
            "batches to the exact fallback"
        )
        q_np = np.ascontiguousarray(queries, np.float32)
        n_q = q_np.shape[0]
        if n_q == 0:  # contract: any Q, including an empty batch
            return np.full((0, k), NEG_INF, np.float32), np.zeros((0, k), np.int64)
        cfg = self.config
        q = torch.from_numpy(q_np).to(self.device)
        shortlist = max(cfg.rerank_multiplier * k, k)
        nprobe = min(cfg.nprobe, self.n_clusters)
        probed = self._probed(q @ self.centroids.T, nprobe, min(shortlist, self.n_tools))

        # ---- cluster-major int8 scoring: every probed cluster's code rows
        # gathered once, through the CSR offsets, for all queries ----------
        clusters = torch.nonzero(probed.any(dim=0)).flatten()  # [U]
        sizes = self._sizes[clusters]
        n_rows = int(sizes.sum())
        seg_start = torch.cumsum(sizes, 0) - sizes
        pos = torch.repeat_interleave(self.offsets[clusters] - seg_start, sizes,
                                      output_size=n_rows)
        pos += torch.arange(n_rows, device=pos.device)  # CSR positions, cluster by cluster
        owner = torch.repeat_interleave(clusters, sizes, output_size=n_rows)
        block = self._codes[pos].to(torch.float32)  # [N, D]
        approx = (q * self._scale) @ block.T  # [Q, N]: scales folded into queries
        approx = approx.masked_fill(~probed[:, owner], NEG_INF)

        # ---- per-query shortlist + exact float32 re-rank ------------------
        n_short = min(shortlist, n_rows)
        approx_top, sel = torch.topk(approx, n_short, dim=1)
        valid = approx_top > NEG_INF / 2
        ids = self.member_ids[pos[sel]]  # [Q, S] tool indices
        exact = torch.einsum("qsd,qd->qs", self._table[ids], q)
        # order by (score desc, tool index asc): sort by index, then a
        # stable sort by score; unreachable slots rank last
        ids = torch.where(valid, ids, self.n_tools)
        ids, by_id = torch.sort(ids, dim=1, stable=True)
        exact = torch.where(valid, exact, NEG_INF).gather(1, by_id)
        kk = min(k, n_short)
        top_s, order = stable_topk(exact, kk)
        top_i = ids.gather(1, order)
        out_s = np.full((n_q, k), NEG_INF, np.float32)
        out_i = np.zeros((n_q, k), np.int64)
        top_s, top_i = top_s.cpu().numpy(), top_i.cpu().numpy()
        filled = top_s > NEG_INF / 2
        out_s[:, :kk] = np.where(filled, top_s, NEG_INF)
        out_i[:, :kk] = np.where(filled, top_i, 0)
        return out_s, out_i
