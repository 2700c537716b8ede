"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).
Source: [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    moe_d_ff=10752,
    rope_theta=500000.0,
)
