"""Mamba2 1.3B [arXiv:2405.21060]: attention-free SSD (state-space
duality), state 128, 48 mixer blocks."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv=1, d_ff=0,
    vocab=50280, head_dim=64,
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_expand=2,
    tie_embeddings=True,
)
