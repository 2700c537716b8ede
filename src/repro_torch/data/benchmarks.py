"""Synthetic tool-selection benchmarks matched to MetaTool / ToolBench.

The real datasets are not available offline; these generators
reproduce the *structure* the paper's results depend on (DESIGN.md §2):

  * scale — `metatool_like`: 199 tools / 4,287 queries / ~10-candidate subsets
    / 4 subtask types; `toolbench_like`: 2,413 tools / 600 queries / 46
    categories / full-corpus retrieval;
  * failure modes — opaque (brand-heavy) descriptions, semantic decoys,
    lexical-overlap traps, low-similarity regimes (App. A.7);
  * the lexical/semantic split — MetaTool-like queries paraphrase (low token
    overlap → dense ≫ BM25), ToolBench-like queries quote API names and
    description tokens (high token overlap → BM25 ≥ dense), matching Table 4.

Everything is deterministic in `seed`.

Description composition per tool (length L, opacity o):
    [name token] + (1-o)·L functional words + o·L generic words + stopwords
where functional words split between *tool-specific* and *topic-shared*
vocabulary, and decoy tools swap part of their functional words for another
topic's shared vocabulary (similar description, different function).

Query composition per ground-truth tool (length L):
    lexical_overlap·L tokens copied verbatim from the description (BM25
    signal) + topic_word_frac·L topic-shared words + remaining tool-specific
    *query-side* words (dense-only signal) + optional name mention + stopwords.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.embedding.vocab import Vocab, make_vocab

__all__ = [
    "Benchmark",
    "SUBTASKS",
    "make_metatool_like",
    "make_toolbench_like",
    "make_benchmark",
    "scale_tool_corpus",
]

SUBTASKS = ("similar", "scenario", "reliability", "multi")


@dataclasses.dataclass
class Benchmark:
    name: str
    vocab: Vocab
    # tools
    desc_tokens: List[np.ndarray]  # ragged, per tool
    tool_category: np.ndarray  # [T] int
    tool_topic: np.ndarray  # [T] int   (latent; analysis only — never used by methods)
    tool_opacity: np.ndarray  # [T] float (latent; analysis only)
    # queries
    query_tokens: List[np.ndarray]  # ragged, per query
    relevant: List[np.ndarray]  # ground-truth tool indices per query
    candidates: Optional[List[np.ndarray]]  # candidate subset per query, or None
    subtask: np.ndarray  # [Q] int index into SUBTASKS
    # split (70/30, deterministic — paper §5.5)
    train_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def n_tools(self) -> int:
        return len(self.desc_tokens)

    @property
    def n_queries(self) -> int:
        return len(self.query_tokens)

    def relevance_matrix(self) -> np.ndarray:
        """Dense [Q, T] binary relevance."""
        rel = np.zeros((self.n_queries, self.n_tools), dtype=np.float32)
        for j, r in enumerate(self.relevant):
            rel[j, r] = 1.0
        return rel

    def candidate_mask(self) -> np.ndarray:
        """[Q, T] 1 where a tool may be ranked for the query."""
        if self.candidates is None:
            return np.ones((self.n_queries, self.n_tools), dtype=np.float32)
        m = np.zeros((self.n_queries, self.n_tools), dtype=np.float32)
        for j, c in enumerate(self.candidates):
            m[j, c] = 1.0
        return m


def _sample_description(
    rng: np.random.Generator,
    vocab: Vocab,
    topic: int,
    tool_id: int,
    opacity: float,
    length: int,
    decoy_topic: int | None,
    tool_word_frac: float,
) -> np.ndarray:
    """Tool description tokens; see module docstring."""
    toks: List[int] = [vocab.name_token(tool_id)]  # every description brands itself
    n_body = max(length - 1, 4)
    n_func = int(round(n_body * (1.0 - opacity)))
    n_func = max(n_func, 1)  # even opaque tools leak one functional word
    n_generic = n_body - n_func
    n_tool = int(round(n_func * tool_word_frac))
    n_topic = n_func - n_tool
    if n_tool > 0:
        toks.extend(rng.choice(vocab.desc_words(tool_id), size=n_tool, replace=True))
    if n_topic > 0:
        toks.extend(rng.choice(vocab.topic_desc_words(topic), size=n_topic, replace=True))
    if decoy_topic is not None and n_func >= 2:
        # semantic decoy: replace ~40% of functional words with another topic's
        # surface vocabulary (similar description, different function — App. A.7)
        n_swap = max(1, int(0.4 * n_func))
        swap = rng.choice(vocab.topic_desc_words(decoy_topic), size=n_swap, replace=True)
        toks[1 : 1 + n_swap] = [int(w) for w in swap]
    if n_generic > 0:
        toks.extend(rng.choice(vocab.generic_words(), size=n_generic, replace=True))
    toks.extend(rng.choice(vocab.stop_words(), size=2, replace=True))
    return np.array(toks, dtype=np.int64)


def _sample_query(
    rng: np.random.Generator,
    vocab: Vocab,
    desc_tokens: List[np.ndarray],
    tool_topic: np.ndarray,
    gt: np.ndarray,
    lexical_overlap: float,
    topic_word_frac: float,
    name_mention_p: float,
    length: int,
    noise_words: int,
    hard: bool = False,
) -> np.ndarray:
    """Query tokens for ground-truth tool(s) `gt`; see module docstring.

    `hard` queries are irreducibly ambiguous: their semantic words name the
    function *family* (topic query bank) rather than the tool — the
    low-similarity regime of App. A.7 where no embedding method can fully
    resolve the tool.
    """
    toks: List[int] = []
    per_tool = max(length // max(len(gt), 1), 3)
    for t in gt:
        t = int(t)
        topic = int(tool_topic[t])
        n_copy = int(rng.binomial(per_tool, lexical_overlap))
        n_topic = int(rng.binomial(per_tool, topic_word_frac))
        n_sem = max(per_tool - n_copy - n_topic, 1)
        if n_copy > 0 and len(desc_tokens[t]) > 0:
            toks.extend(rng.choice(desc_tokens[t], size=n_copy, replace=True))
        if n_topic > 0:
            toks.extend(
                rng.choice(vocab.topic_desc_words(topic), size=n_topic, replace=True)
            )
        sem_bank = vocab.topic_query_words(topic) if hard else vocab.query_words(t)
        toks.extend(rng.choice(sem_bank, size=n_sem, replace=True))
        if rng.random() < name_mention_p:
            toks.append(vocab.name_token(t))
    if noise_words > 0:
        toks.extend(rng.choice(vocab.stop_words(), size=noise_words, replace=True))
    return np.array(toks, dtype=np.int64)


def make_benchmark(
    *,
    name: str,
    n_tools: int,
    n_queries: int,
    n_topics: int,
    n_categories: int,
    candidate_set_size: int | None,
    lexical_overlap: float,
    topic_word_frac: float,
    name_mention_p: float,
    opacity_beta: tuple[float, float] = (1.2, 3.0),
    decoy_fraction: float = 0.20,
    tool_word_frac: float = 0.65,
    function_spread: float = 0.9,
    desc_len: int = 12,
    query_len: int = 9,
    query_noise_words: int = 2,
    subtask_mix: tuple[float, float, float, float] = (0.23, 0.42, 0.23, 0.12),
    multi_tool_max: int = 3,
    reliability_extra_noise: int = 4,
    hard_query_frac: float = 0.12,
    candidate_style: str = "topic",  # "topic" | "function_nn" (hard pools)
    train_frac: float = 0.7,
    seed: int = 0,
    tool_word_noise: float = 0.45,
    topic_word_noise: float = 0.50,
) -> Benchmark:
    rng = np.random.default_rng(seed)
    tool_topic = rng.integers(0, n_topics, size=n_tools)
    vocab = make_vocab(
        tool_topic=tool_topic,
        n_topics=n_topics,
        function_spread=function_spread,
        tool_word_noise=tool_word_noise,
        topic_word_noise=topic_word_noise,
        seed=seed + 1,
    )

    # ---- tools ----------------------------------------------------------
    # categories group topics (S2's category feature; ToolBench has 46)
    topic_category = rng.integers(0, n_categories, size=n_topics)
    tool_category = topic_category[tool_topic]
    tool_opacity = rng.beta(*opacity_beta, size=n_tools)
    # decoys: a fraction of tools borrows surface vocabulary from another topic
    is_decoy = rng.random(n_tools) < decoy_fraction
    decoy_topic = np.where(is_decoy, rng.integers(0, n_topics, size=n_tools), -1)
    desc_tokens: List[np.ndarray] = []
    for i in range(n_tools):
        dt = (
            int(decoy_topic[i])
            if decoy_topic[i] >= 0 and decoy_topic[i] != tool_topic[i]
            else None
        )
        desc_tokens.append(
            _sample_description(
                rng,
                vocab,
                int(tool_topic[i]),
                i,
                float(tool_opacity[i]),
                desc_len + int(rng.integers(-2, 3)),
                dt,
                tool_word_frac,
            )
        )

    # ---- queries --------------------------------------------------------
    subtask = rng.choice(len(SUBTASKS), size=n_queries, p=np.array(subtask_mix))
    query_tokens: List[np.ndarray] = []
    relevant: List[np.ndarray] = []
    for j in range(n_queries):
        st = SUBTASKS[subtask[j]]
        if st == "multi":
            k = int(rng.integers(2, multi_tool_max + 1))
            gt = rng.choice(n_tools, size=k, replace=False)
        else:
            gt = np.array([int(rng.integers(0, n_tools))])
        noise = query_noise_words + (reliability_extra_noise if st == "reliability" else 0)
        query_tokens.append(
            _sample_query(
                rng,
                vocab,
                desc_tokens,
                tool_topic,
                gt,
                lexical_overlap,
                topic_word_frac,
                name_mention_p,
                query_len + int(rng.integers(-2, 3)),
                noise,
                hard=bool(rng.random() < hard_query_frac),
            )
        )
        relevant.append(np.sort(gt))

    # ---- candidate subsets (MetaTool-style) ------------------------------
    candidates: Optional[List[np.ndarray]] = None
    if candidate_set_size is not None:
        # only the host-side numpy `encode` runs here, so no device is needed
        enc = BagEncoder(vocab, device="cpu")
        tool_emb = enc.encode(desc_tokens)  # [T, D] for hard-distractor mining
        sims_tt = tool_emb @ tool_emb.T
        np.fill_diagonal(sims_tt, -np.inf)
        candidates = []
        for j in range(n_queries):
            gt = relevant[j]
            st = SUBTASKS[subtask[j]]
            n_fill = max(candidate_set_size - len(gt), 0)
            pool: List[int] = []
            if candidate_style == "function_nn":
                # ToolBench-style hard pools: distractors are the nearest
                # tools in *function* space (intra-category confusables)
                f = vocab.tool_function
                for t in gt:
                    nn = np.argsort(-(f @ f[int(t)]))
                    pool.extend(int(x) for x in nn[1 : n_fill + 2])
            elif st == "similar":
                # hardest split: distractors are the gt tools' nearest
                # neighbours in description-embedding space
                for t in gt:
                    pool.extend(np.argsort(-sims_tt[t])[:n_fill].tolist())
            # pad with same-topic (functionally adjacent), then random tools
            same_topic = np.flatnonzero(tool_topic == tool_topic[gt[0]])
            pool.extend(rng.permutation(same_topic).tolist())
            pool.extend(rng.permutation(n_tools).tolist())
            seen = set(int(t) for t in gt)
            cand = [int(t) for t in gt]
            for t in pool:
                if len(cand) >= candidate_set_size:
                    break
                if t not in seen:
                    cand.append(int(t))
                    seen.add(int(t))
            candidates.append(np.sort(np.array(cand, dtype=np.int64)))

    # ---- split ------------------------------------------------------------
    perm = rng.permutation(n_queries)
    n_train = int(round(train_frac * n_queries))
    train_idx = np.sort(perm[:n_train])
    test_idx = np.sort(perm[n_train:])

    return Benchmark(
        name=name,
        vocab=vocab,
        desc_tokens=desc_tokens,
        tool_category=tool_category.astype(np.int64),
        tool_topic=tool_topic.astype(np.int64),
        tool_opacity=tool_opacity.astype(np.float32),
        query_tokens=query_tokens,
        relevant=relevant,
        candidates=candidates,
        subtask=subtask.astype(np.int64),
        train_idx=train_idx,
        test_idx=test_idx,
    )


def scale_tool_corpus(
    table: np.ndarray,
    n_tools: int,
    seed: int = 0,
    noise: float = 0.02,
) -> np.ndarray:
    """Tile + perturb a real tool table to MCP-registry scale.

    The paper's tables stop at 2,413 tools; public MCP registries reach tens
    of thousands. This scaler preserves the structure index benchmarks care
    about: row `i` is a perturbed clone of source row `i % T` (provenance by
    modulo), so the scaled corpus keeps the real table's topic geometry —
    clusters of near-duplicate tools around each true tool direction, the
    regime where IVF coarse quantization must still separate neighbors. The
    first `T` rows are the original table bit-exact; clones get iid gaussian
    perturbation (`noise` per dimension) and are re-unit-normalized.
    Deterministic in `seed`.
    """
    base = np.asarray(table, np.float32)
    t = base.shape[0]
    assert n_tools >= t, f"cannot scale {t} tools down to {n_tools}"
    reps = -(-n_tools // t)  # ceil
    big = np.tile(base, (reps, 1))[:n_tools].copy()
    rng = np.random.default_rng(seed)
    clones = big[t:]
    clones += noise * rng.standard_normal(size=clones.shape).astype(np.float32)
    clones /= np.maximum(np.linalg.norm(clones, axis=-1, keepdims=True), 1e-9)
    return big


def make_metatool_like(seed: int = 0, n_tools: int = 199, n_queries: int = 4287) -> Benchmark:
    """199 tools, 4,287 queries, ~10-candidate subsets, 4 subtask types.

    Paraphrase-style queries: low lexical overlap (dense ≫ BM25, Table 4) and
    a rich outcome log (~13 positives/tool in the 70% train split).
    """
    return make_benchmark(
        name="metatool-like",
        n_tools=n_tools,
        n_queries=n_queries,
        n_topics=max(n_tools // 5, 4),
        n_categories=24,
        candidate_set_size=10,
        lexical_overlap=0.06,
        topic_word_frac=0.30,  # shared-topic tokens: BM25 gets topic-level signal only
        name_mention_p=0.02,
        opacity_beta=(1.0, 4.0),
        decoy_fraction=0.15,
        function_spread=1.05,
        hard_query_frac=0.14,
        tool_word_noise=0.35,
        query_noise_words=0,
        reliability_extra_noise=2,
        subtask_mix=(0.232, 0.420, 0.232, 0.116),  # 995/1800/995/497 of 4287
        seed=seed,
    )


def make_toolbench_like(seed: int = 0, n_tools: int = 2413, n_queries: int = 600) -> Benchmark:
    """2,413 APIs, 46 categories, 600 queries, hard candidate pools.

    API-quoting queries (lexical overlap ⇒ BM25 ≥ dense, Table 4) and a
    sparse outcome log (<0.15 positives/tool — the regime where the paper's
    MLP re-ranker hurts). The paper's random baseline (R@5=0.829) implies
    evaluation within small retrieved candidate pools rather than the full
    corpus, so we rank within 6-tool pools of function-space nearest
    neighbours (intra-category confusables, the G1-Category setting).
    """
    return make_benchmark(
        name="toolbench-like",
        n_tools=n_tools,
        n_queries=n_queries,
        n_topics=max(n_tools // 8, 4),
        n_categories=46,
        candidate_set_size=6,
        candidate_style="function_nn",
        lexical_overlap=0.18,
        topic_word_frac=0.10,
        name_mention_p=0.05,
        function_spread=0.9,
        tool_word_noise=0.40,
        query_noise_words=1,
        hard_query_frac=0.27,
        # G1-Instruction / G1-Category / G2-Instruction ≈ single, intra-category,
        # multi-tool thirds (§5.1)
        subtask_mix=(0.17, 0.33, 0.17, 0.33),
        multi_tool_max=3,
        seed=seed,
    )
