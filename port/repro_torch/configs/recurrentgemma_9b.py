"""RecurrentGemma 9B [arXiv:2402.19427]: Griffin — RG-LRU recurrent
blocks and local attention in a 2:1 pattern (rec, rec, local)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, head_dim=256,
    block_pattern=("rec", "rec", "local"), local_window=2048,
    rglru_width=4096, tie_embeddings=True, act="gelu",
)
