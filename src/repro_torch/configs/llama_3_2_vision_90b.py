"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, gated cross-attention image layers every 5th layer.
Source: [hf:meta-llama/Llama-3.2-11B-Vision] scaled per the assignment table.
The vision tower (ViT + projector) is stubbed: `input_specs` provides
precomputed patch embeddings [B, n_image_tokens, d_model] (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    n_layers=100,  # 80 self-attention + 20 cross-attention (every 5th)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1600,  # ~1601 patches per image tile; rounded for tiling
    rope_theta=500000.0,
)
