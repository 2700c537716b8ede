"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32 => MHA) d_ff=6912
vocab=50304. Source: [hf:stabilityai/stablelm-2-1_6b] family scaled per the
assignment table."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,  # kv=32: full multi-head attention
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10000.0,
)
