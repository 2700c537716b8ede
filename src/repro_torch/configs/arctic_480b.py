"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP.
Source: [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual branch
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,  # arctic: dense MLP in parallel with the MoE
)
