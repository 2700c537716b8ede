"""Hashed word tokenizer: real text -> synthetic-vocab token ids (a copy of
`repro/embedding/tokenizer.py`).

The synthetic benchmarks speak token ids; production routers speak strings.
This deterministic hashed tokenizer maps whitespace/punctuation-split words
into the stopword band of a `Vocab` (unknown surface forms carry no topic
signal, exactly like stopwords), while letting callers register known words
(tool names, domain terms) to specific ids. It makes the gateway API
string-capable end-to-end without pretending we have a trained BPE.
"""
from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List

import numpy as np

from repro_torch.embedding.vocab import Vocab

__all__ = ["HashTokenizer"]

_SPLIT = re.compile(r"[^a-z0-9_]+")


class HashTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._known: Dict[str, int] = {}

    def register(self, word: str, token_id: int):
        """Pin a surface form (e.g. a tool name) to a vocabulary id."""
        assert 0 <= token_id < self.vocab.size
        self._known[word.lower()] = int(token_id)

    def register_tool_names(self, names: Iterable[str]):
        for i, name in enumerate(names):
            self.register(name, self.vocab.name_token(i))

    def _hash_to_stopword(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.encode(), digest_size=4).digest(), "little")
        return self.vocab.stop_block + (h % self.vocab.n_stop)

    def encode(self, text: str) -> np.ndarray:
        words = [w for w in _SPLIT.split(text.lower()) if w]
        ids: List[int] = []
        for w in words:
            ids.append(self._known.get(w, self._hash_to_stopword(w)))
        return np.array(ids or [self.vocab.stop_block], dtype=np.int64)
