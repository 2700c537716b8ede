"""PyTorch/CUDA port of the OATS semantic router (`repro`'s counterpart).

Each module sits at the same relative path as the JAX module it is held
against (`repro/<path>` -> `repro_torch/<path>`); the JAX package stays the
reference. The port imports `torch` and numpy, never `jax` and nothing of
`repro`: the host-only modules it needs (tool database, metrics, clocks,
bucketing, vocab, featurizer, benchmark generators) are copies.

Entry points take `device=None`, which means the CUDA card; without one
they raise instead of falling back. Tests and CPU callers pass
`device="cpu"`, where every kernel wrapper serves its plain PyTorch version.
"""
