"""Tool-index subsystem: pluggable similarity-scoring backends behind
`SemanticRouter.route_batch` (counterpart of `repro.index`).

Scoring is a `ScorerBackend` built from one table snapshot, and
`ToolIndexManager` keeps the index consistent with the table's
swap/rollback protocol (inline rebuild on a new version, masked batches to
the exact path — see `manager.py`).

Backend-selection guide
=======================

``dense`` — `DenseBackend` (default)
    Exact brute force: one float32 matmul + stable sort, candidate masks
    supported natively. It writes the [Q, T] score matrix and sorts every
    row of it. The oracle every other backend is held against.

``fused`` — `FusedBackend`
    The hand-written Hopper kernel (`kernels/topk_sim`): splits the table
    across the SMs, keeps a running top-K per query in shared memory, and
    never writes the [Q, T] score matrix — exact results. On the CPU it
    serves the plain version, identical to ``dense``. No candidate-mask
    support (masked batches fall back to the exact path).

The JAX package's ``ivf`` backend is not ported yet.
"""
from repro_torch.index.base import NEG_INF, ScorerBackend
from repro_torch.index.dense import DenseBackend
from repro_torch.index.fused_backend import FusedBackend
from repro_torch.index.manager import ToolIndexManager

__all__ = [
    "NEG_INF",
    "ScorerBackend",
    "DenseBackend",
    "FusedBackend",
    "ToolIndexManager",
    "BACKENDS",
    "build_backend",
]

BACKENDS = {
    DenseBackend.name: DenseBackend,
    FusedBackend.name: FusedBackend,
}


def build_backend(kind: str, table, table_version: int, device=None) -> ScorerBackend:
    """Construct a registered backend over one table snapshot."""
    if kind not in BACKENDS:
        raise ValueError(f"unknown backend {kind!r} (available: {sorted(BACKENDS)})")
    return BACKENDS[kind](table, table_version, device=device)
