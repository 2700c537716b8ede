"""Canonical power-of-two batch bucketing.

The gateway pads its miss block to the next power of two so the set of
batch shapes the scoring path sees stays logarithmic in the largest batch
ever served, exactly as the JAX reference does (there it bounds the jit
compile cache; here it keeps the two packages' padded blocks identical,
which the parity tests rely on). This module is the ONE place that
arithmetic lives in the port — the `pow2-bucket` lint rule flags
hand-rolled copies. It is a copy of `repro.common.bucketing`: the port
imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Iterable, List

__all__ = ["pow2_bucket", "pad_amount", "expected_buckets"]


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (bucket for a batch of n; n >= 1 -> >= 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()  # repro: noqa[pow2-bucket]


def pad_amount(n: int) -> int:
    """Rows of padding needed to lift a batch of n into its bucket."""
    return pow2_bucket(n) - n


def expected_buckets(batch_sizes: Iterable[int]) -> List[int]:
    """Sorted distinct buckets a sweep over `batch_sizes` may compile."""
    return sorted({pow2_bucket(n) for n in batch_sizes})
