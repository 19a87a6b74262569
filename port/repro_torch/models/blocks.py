"""Decoder block assembly (twin of ``repro.models.blocks``), kind
``"ssm"`` only: a pre-norm residual around the Mamba2 mixer.  The other
kinds (attention, MoE, RG-LRU) raise until ROADMAP Queue 1 item 14c.

The reference stacks each kind's parameters over a leading super-block
axis for one ``lax.scan``; here a block is one layer's module and the
model walks them in a Python loop.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import not_ported
from . import layers, ssm


class Block(nn.Module):
    """One layer: ``norm1`` and the ``ssm`` mixer, named as in repro."""

    def __init__(self, norm1: torch.Tensor, mixer: ssm.Mixer):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.ssm = mixer


def _only_ssm(kind: str) -> None:
    if kind != "ssm":
        raise not_ported(f"block kind {kind!r}", "Queue 1 item 14c")


def block_init(gen: torch.Generator, cfg, kind: str) -> Block:
    _only_ssm(kind)
    return Block(torch.zeros(cfg.d_model, device=gen.device),
                 ssm.init_params(gen, cfg))


def apply_block(x, p: Block, cfg, kind: str, positions=None):
    """One block, prefill form. x: (B, S, D) -> (x, aux)."""
    _only_ssm(kind)
    return x + ssm.forward(layers.rms_norm(x, p.norm1, cfg.norm_eps),
                           p.ssm, cfg), {}


def block_cache_init(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    _only_ssm(kind)
    return ssm.init_cache(cfg, batch, dtype, device)


def decode_block(x, p: Block, cache: dict, cfg, kind: str, pos):
    _only_ssm(kind)
    y, nc = ssm.decode_step(layers.rms_norm(x, p.norm1, cfg.norm_eps),
                            cache, p.ssm, cfg)
    return x + y, nc
