"""InternVL2 26B [arXiv:2404.16821]: InternViT frontend (stub — patch
embeddings arrive precomputed) + InternLM2-style dense backbone."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=92553, head_dim=128,
    vis_tokens=256, vis_dim=3200,
)
