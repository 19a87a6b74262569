"""Command-R 35B [hf:CohereForAI]: wide dense GQA, no biases."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528,
    vocab=256000, head_dim=128,
)
