"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128. SSD (state-space duality) per [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # no FFN: the Mamba-2 block is the layer
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # d_inner=5120 => 80 SSD heads
    ssm_chunk=256,
    ssm_n_groups=1,
    tie_embeddings=True,
)
