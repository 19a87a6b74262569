"""Snowflake Arctic 480B [hf:Snowflake]: 128-expert top-2 MoE with a
parallel dense residual MLP; experts sharded over the model axis (EP)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    n_experts=128, top_k=2, moe_ff=4864, dense_residual=True,
    shard_experts=True,
)
