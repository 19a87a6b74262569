"""Mixtral 8x22B [arXiv:2401.04088]: 8-expert top-2 MoE with SWA.
Experts are few (8 < model-axis 16), so TP shards the expert hidden dim
rather than the expert axis (shard_experts=False)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=32768, head_dim=128, window=4096,
    n_experts=8, top_k=2, shard_experts=False,
)
