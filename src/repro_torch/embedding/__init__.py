"""Tool and query embeddings: the frozen bag-of-word-vectors encoder and its
vocab, the hashed word tokenizer and the MiniLM-shaped query encoder."""
