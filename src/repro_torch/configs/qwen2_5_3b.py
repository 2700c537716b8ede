"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias. Source: [hf:Qwen/Qwen2.5-0.5B] scaled per the
assignment table."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,  # qwen-style attention biases
    rope_theta=1000000.0,
)
