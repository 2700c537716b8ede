"""Tool embeddings: the frozen bag-of-word-vectors encoder and its vocab."""
