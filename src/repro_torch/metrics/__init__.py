"""Retrieval metrics (paper §5.2): numpy per query, torch in batches."""
