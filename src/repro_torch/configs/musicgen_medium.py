"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 over EnCodec tokens, 4 codebooks summed at the input and predicted
by 4 parallel heads. Source: [arXiv:2306.05284]. The EnCodec frontend
(mel/conv codec) is stubbed: tokens arrive as [B, S, 4] codebook ids
(DESIGN.md §5); the delay-pattern interleaver is part of the stubbed codec."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
)
