"""Retrieval core, learned serving stages and the outcome featurizer."""
