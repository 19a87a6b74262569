"""Gemma 2 27B [arXiv:2408.00118]: local+global alternating attention,
logit/attention softcaps, sandwich norms, tied embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, d_ff=36864,
    vocab=256000, head_dim=128,
    local_global=True, local_window=4096,
    logit_softcap=30.0, attn_softcap=50.0, post_norms=True,
    tie_embeddings=True, act="gelu", rope_theta=10000.0,
)
