"""Whisper medium [arXiv:2212.04356]: enc-dec; conv/mel frontend is a
stub — input_specs feeds precomputed frame embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=4096, vocab=51865, head_dim=64, src_len=1500,
    act="gelu", tie_embeddings=True,
)
