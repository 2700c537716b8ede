"""Fused cosine similarity + top-K over a tool table."""
