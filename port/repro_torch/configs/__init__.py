"""Assigned-architecture registry: the port's copy of ``repro.configs``.

Every module defines ``CONFIG`` (the exact published configuration) —
``get(name)`` returns it, ``smoke(name)`` returns a reduced same-family
config for CPU tests (small dims, same block pattern / features).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

ARCHS = [
    "gemma2_27b", "stablelm_12b", "qwen15_4b", "command_r_35b",
    "whisper_medium", "mixtral_8x22b", "arctic_480b", "internvl2_26b",
    "recurrentgemma_9b", "mamba2_1p3b",
]

# canonical dashed ids used by the assignment table
ALIASES = {
    "gemma2-27b": "gemma2_27b", "stablelm-12b": "stablelm_12b",
    "qwen1.5-4b": "qwen15_4b", "command-r-35b": "command_r_35b",
    "whisper-medium": "whisper_medium", "mixtral-8x22b": "mixtral_8x22b",
    "arctic-480b": "arctic_480b", "internvl2-26b": "internvl2_26b",
    "recurrentgemma-9b": "recurrentgemma_9b", "mamba2-1.3b": "mamba2_1p3b",
}


def get(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name)
    return importlib.import_module(f".{mod}", __package__).CONFIG


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, identical structure."""
    cfg = get(name)
    pat_len = len(cfg.pattern)
    n_layers = pat_len * 2 + (1 if cfg.block_pattern else 0)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        moe_ff=128 if cfg.n_experts else None,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        rglru_width=64 if cfg.rglru_width else None,
        local_window=32,
        window=32 if cfg.window else None,
        enc_layers=2 if cfg.enc_layers else 0,
        src_len=24 if cfg.enc_layers else cfg.src_len,
        vis_tokens=8 if cfg.vis_tokens else 0,
        vis_dim=48 if cfg.vis_dim else 0,
    )
