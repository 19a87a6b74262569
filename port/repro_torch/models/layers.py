"""Shared neural layers (twin of ``repro.models.layers``): the weight
init and the RMS norm the Mamba2 slice uses.  ``rope``,
``chunked_attention``, ``decode_attention`` and ``gated_mlp`` come with
the attention families (ROADMAP Queue 1 item 14c)."""
from __future__ import annotations

import torch

INIT_STD = 0.02


def dense_init(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Normal with std 0.02, float32, on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * INIT_STD


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Scale by ``(1 + scale)`` in float32, cast back to x's type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
