"""Decoder-only LM assembly (twin of ``repro.models.lm``), for the ssm
family: embed, a ``nn.ModuleList`` of blocks walked in a Python loop
(the reference scans stacked super-blocks), final norm, tied or separate
unembed with the padded vocab rows masked to -1e9.

Inference only: ``remat`` matters for training and raises unless
``"none"`` (ROADMAP Queue 1 item 14b); the vlm image prefix raises with
item 14c.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import not_ported
from . import blocks, layers
from .config import ModelConfig


def structure(cfg: ModelConfig):
    pat = cfg.pattern
    n_super = cfg.n_layers // len(pat)
    rest = cfg.n_layers - n_super * len(pat)
    return pat, n_super, rest


def kinds(cfg: ModelConfig) -> list[str]:
    """The kind of every layer in order: super-blocks, then the rest."""
    pat, n_super, rest = structure(cfg)
    return list(pat) * n_super + list(pat[:rest])


class LM(nn.Module):
    """``embed``, ``final_norm``, [``unembed``] and ``blocks``, named
    after ``repro``'s parameter keys; ``blocks[i]`` is layer i."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers_: list, unembed: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.blocks = nn.ModuleList(layers_)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random init on the generator's device (float32 weights)."""
    if cfg.family == "vlm":
        raise not_ported("the vlm image prefix", "Queue 1 item 14c")
    d, v = cfg.d_model, cfg.vocab_padded
    embed = layers.dense_init(gen, (v, d))
    unembed = None if cfg.tie_embeddings else layers.dense_init(gen, (v, d))
    return LM(embed, torch.zeros(d, device=gen.device),
              [blocks.block_init(gen, cfg, k) for k in kinds(cfg)], unembed)


def _dt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed_in(params: LM, tokens, cfg, img=None):
    if img is not None:
        raise not_ported("the vlm image prefix", "Queue 1 item 14c")
    x = params.embed[tokens].to(_dt(cfg))
    if cfg.tie_embeddings:
        # the scale is rounded to the activations' type first, as
        # jnp.asarray(d ** 0.5, x.dtype) does (45.25 in bf16 at d = 2048)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _logits_of(x, params: LM, cfg):
    w_out = params.embed if cfg.tie_embeddings else params.unembed
    logits = (x @ w_out.to(x.dtype).T).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:   # mask pad rows out of the softmax
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits, -1e9)
    return logits


def forward(params: LM, tokens, cfg: ModelConfig, img=None,
            remat: str = "none", logits_mode: str = "all") -> tuple:
    """Teacher-forcing forward -> (logits float32, aux).

    logits_mode="last" computes the unembed only for the final position
    (the prefill path): the (B, S, V) tensor never exists.
    """
    if remat != "none":
        raise not_ported(f"remat={remat!r}", "Queue 1 item 14b")
    x = _embed_in(params, tokens, cfg, img)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = {}
    for blk, kind in zip(params.blocks, kinds(cfg)):
        x, _ = blocks.apply_block(x, blk, cfg, kind, positions)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]
    return _logits_of(x, params, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> list[dict]:
    """One cache a layer: the conv history in the activations' type and
    the SSM state in float32."""
    return [blocks.block_cache_init(cfg, k, batch, max_len, _dt(cfg), device)
            for k in kinds(cfg)]


def decode_step(params: LM, cache: list, token, pos, cfg: ModelConfig):
    """One greedy decode step.  token: (B,) int -> (logits, cache); the
    layers' states are updated in place."""
    x = _embed_in(params, token[:, None], cfg)
    new_cache = []
    for blk, c, kind in zip(params.blocks, cache, kinds(cfg)):
        x, nc = blocks.decode_block(x, blk, c, cfg, kind, pos)
        new_cache.append(nc)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits_of(x[:, 0], params, cfg), new_cache
