"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no biases. Source: [hf:CohereForAI/c4ai-command-r-v01]
scaled per the assignment table."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,  # no-bias per model card
    rope_theta=75000000.0,
)
