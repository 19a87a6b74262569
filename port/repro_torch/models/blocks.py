"""Decoder block assembly (twin of ``repro.models.blocks``): the kinds
``ssm`` (Mamba2), ``full``, ``local`` and ``global`` (attention and a
gated MLP), ``moe`` (attention and the routed experts, with arctic's
dense residual MLP beside them) and ``rec`` (RG-LRU and a gated MLP),
pre-norm residuals, gemma2's post-norms (``norm1b``, ``norm2b``).

The reference stacks each kind's parameters over a leading super-block
axis for one ``lax.scan``; here a block is one layer's module and the
model walks them in a Python loop.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers, moe, rglru, ssm


class Block(nn.Module):
    """One layer: its norms as parameters (``norm1``, ``norm2``, ...) and
    its parts as modules (``attn``, ``mlp``, ``moe``, ``rec``, ``ssm``),
    named as in repro."""

    def __init__(self, norms: dict, parts: dict):
        super().__init__()
        for name, t in norms.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        for name, m in parts.items():
            self.add_module(name, m)


def window_for(kind, cfg):
    if kind == "local":
        return cfg.local_window
    return cfg.window


# ----------------------------- init ---------------------------------------

def attn_init(gen: torch.Generator, cfg) -> layers.Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {"wq": layers.dense_init(gen, (d, h * hd)),
         "wk": layers.dense_init(gen, (d, kv * hd)),
         "wv": layers.dense_init(gen, (d, kv * hd)),
         "wo": layers.dense_init(gen, (h * hd, d))}
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros(h * hd, device=dev)
        p["bk"] = torch.zeros(kv * hd, device=dev)
        p["bv"] = torch.zeros(kv * hd, device=dev)
    return layers.Params(p)


def mlp_init(gen: torch.Generator, cfg) -> layers.Params:
    d, f = cfg.d_model, cfg.d_ff
    return layers.Params({"w1": layers.dense_init(gen, (d, f)),
                          "w3": layers.dense_init(gen, (d, f)),
                          "w2": layers.dense_init(gen, (f, d))})


def block_init(gen: torch.Generator, cfg, kind: str) -> Block:
    def norm():
        return torch.zeros(cfg.d_model, device=gen.device)

    if kind == "ssm":
        return Block({"norm1": norm()}, {"ssm": ssm.init_params(gen, cfg)})
    if kind == "rec":
        return Block({"norm1": norm(), "norm2": norm()},
                     {"rec": rglru.init_params(gen, cfg),
                      "mlp": mlp_init(gen, cfg)})
    if kind not in ("full", "local", "global", "moe"):
        raise ValueError(f"unknown block kind {kind!r}")
    norms = {"norm1": norm(), "norm2": norm()}
    parts = {"attn": attn_init(gen, cfg)}
    if kind == "moe":
        parts["moe"] = moe.init_params(gen, cfg)
        if cfg.dense_residual:
            parts["mlp"] = mlp_init(gen, cfg)
    else:
        parts["mlp"] = mlp_init(gen, cfg)
    if cfg.post_norms:
        norms["norm1b"] = norm()
        norms["norm2b"] = norm()
    return Block(norms, parts)


# ---------------------------- forward -------------------------------------

def mlp(x, p, cfg):
    """The gated MLP with ``p``'s float32 weights cast to x's type."""
    return layers.gated_mlp(x, p.w1.to(x.dtype), p.w3.to(x.dtype),
                            p.w2.to(x.dtype), cfg.act)


def _qkv(x, p, cfg):
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return q, k, v


def _attn_apply(x, p, cfg, kind, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = _qkv(x, p, cfg)
    q = layers.rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = layers.rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
    out = layers.chunked_attention(
        q, k, v.reshape(b, s, kv, hd), causal=True,
        window=window_for(kind, cfg), softcap=cfg.attn_softcap)
    return out.reshape(b, s, h * hd) @ p.wo.to(x.dtype)


def _ffn(x, p: Block, cfg, kind):
    """The residual's second half: norm2, the MLP or the experts (and
    the dense residual), post-norm -> (x, aux)."""
    eps = cfg.norm_eps
    hin = layers.rms_norm(x, p.norm2, eps)
    aux = {}
    if kind == "moe":
        m, aux = moe.moe_ffn(hin, p.moe, cfg)
        if cfg.dense_residual:
            m = m + mlp(hin, p.mlp, cfg)
    else:
        m = mlp(hin, p.mlp, cfg)
    if cfg.post_norms:
        m = layers.rms_norm(m, p.norm2b, eps)
    return x + m, aux


def apply_block(x, p: Block, cfg, kind: str, positions=None):
    """One block, prefill form. x: (B, S, D) -> (x, aux)."""
    eps = cfg.norm_eps
    if kind == "ssm":
        return x + ssm.forward(layers.rms_norm(x, p.norm1, eps),
                               p.ssm, cfg), {}
    if kind == "rec":
        x = x + rglru.forward(layers.rms_norm(x, p.norm1, eps), p.rec, cfg)
        return x + mlp(layers.rms_norm(x, p.norm2, eps), p.mlp, cfg), {}
    a = _attn_apply(layers.rms_norm(x, p.norm1, eps), p.attn, cfg, kind,
                    positions)
    if cfg.post_norms:
        a = layers.rms_norm(a, p.norm1b, eps)
    return _ffn(x + a, p, cfg, kind)


# ---------------------------- decode --------------------------------------

def attn_cache_init(cfg, kind, batch, max_len, dtype, device) -> dict:
    """K and V of (B, W, KV, hd): W = min(max_len, window) for a
    windowed kind (a ring), else max_len."""
    w = window_for(kind, cfg)
    wlen = min(max_len, w) if w else max_len
    shape = (batch, wlen, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_cache_init(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    if kind == "ssm":
        return ssm.init_cache(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru.init_cache(cfg, batch, dtype, device)
    return attn_cache_init(cfg, kind, batch, max_len, dtype, device)


def _attn_decode(x, p, cache, cfg, pos):
    """One token's attention; K and V are written in place at slot
    ``pos % W`` (the ring holds exactly the window, so the read needs
    no window mask)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = _qkv(x, p, cfg)
    posv = torch.full((b, 1), pos, device=x.device)
    q = layers.rope(q.reshape(b, 1, h, hd), posv, cfg.rope_theta)
    k = layers.rope(k.reshape(b, 1, kv, hd), posv, cfg.rope_theta)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v.reshape(b, kv, hd).to(cache["v"].dtype)
    out = layers.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                  softcap=cfg.attn_softcap)
    return out.reshape(b, 1, h * hd) @ p.wo.to(x.dtype), cache


def decode_block(x, p: Block, cache: dict, cfg, kind: str, pos):
    """One layer's decode step -> (x, cache); caches are updated in
    place where the reference donates them."""
    eps = cfg.norm_eps
    if kind == "ssm":
        y, nc = ssm.decode_step(layers.rms_norm(x, p.norm1, eps),
                                cache, p.ssm, cfg)
        return x + y, nc
    if kind == "rec":
        y, nc = rglru.decode_step(layers.rms_norm(x, p.norm1, eps),
                                  cache, p.rec, cfg)
        x = x + y
        return x + mlp(layers.rms_norm(x, p.norm2, eps), p.mlp, cfg), nc
    a, nc = _attn_decode(layers.rms_norm(x, p.norm1, eps), p.attn, cache,
                         cfg, pos)
    if cfg.post_norms:
        a = layers.rms_norm(a, p.norm1b, eps)
    return _ffn(x + a, p, cfg, kind)[0], nc
