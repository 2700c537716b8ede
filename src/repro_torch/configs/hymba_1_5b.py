"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + Mamba heads in every layer
per [arXiv:2411.13676]. Hymba uses sliding-window attention in most layers;
we window all attention heads (1024) — the SSM path carries global context."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="dense",
    hybrid=True,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,  # d_inner=3200 => 50 SSD heads
    ssm_chunk=256,
    sliding_window=1024,
    tie_embeddings=True,
)
