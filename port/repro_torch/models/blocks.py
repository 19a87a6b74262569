"""Decoder block assembly (twin of ``repro.models.blocks``): the kinds
``ssm`` (Mamba2), ``full``, ``local`` and ``global`` (attention and a
gated MLP), ``moe`` (attention and the routed experts, with arctic's
dense residual MLP beside them) and ``rec`` (RG-LRU and a gated MLP),
pre-norm residuals, gemma2's post-norms (``norm1b``, ``norm2b``).

The reference stacks each kind's parameters over a leading super-block
axis for one ``lax.scan``; here a block is one layer's module and the
model walks them in a Python loop.

Under a ``("data", "model")`` mesh (``par``, a ``dist.parallel.Parallel``)
a block holds this rank's shards of ``dist.sharding.param_specs`` and
runs Megatron's scheme: ``wq``, ``wk``, ``wv``, ``w1`` and ``w3`` as
column shards after ``par.copy``, ``wo`` and ``w2`` as row shards
before ``par.reduce``.  A rank holds the query heads ``[r·H/tp,
(r+1)·H/tp)``; each meets kv head ``h // (H/n_kv)`` in global head
numbering, so where the kv heads do not split with them (``n_kv % tp``,
or ``wk`` replicated because ``n_kv·hd`` does not divide) the rank forms
the whole K and V (gathering a split ``wk``) and takes its heads' kv
heads out of it.  Qwen's ``bq``, ``bk`` and ``bv`` are replicated and
each rank adds its columns' slice, as it does with a replicated ``wk``:
their gradients are partial on each model rank (``model_partial``).
Where the heads do not split (``H % tp``), the block gathers its
attention weights and runs whole on every rank.
"""
from __future__ import annotations

import types

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

def mlp(x, p, cfg, par=None):
    """The gated MLP with ``p``'s float32 weights cast to x's type;
    under a mesh with F split, on this rank's columns and rows."""
    w1, w3, w2 = p.w1.to(x.dtype), p.w3.to(x.dtype), p.w2.to(x.dtype)
    if par is None or w1.shape[-1] == cfg.d_ff:
        return layers.gated_mlp(x, w1, w3, w2, cfg.act)
    return par.reduce(layers.gated_mlp(par.copy(x), w1, w3, w2, cfg.act))


def splits_heads(cfg, tp: int, wq_cols: int) -> bool:
    """True where a rank holding ``wq_cols`` columns of ``wq`` runs its
    own query heads (the tensor-parallel attention)."""
    h = cfg.n_heads
    return tp > 1 and wq_cols * tp == h * cfg.hd and h % tp == 0


def model_partial(specs: dict, cfg, tp: int) -> set:
    """The replicated parameters that a tensor-parallel attention uses
    in slices (the QKV biases, a replicated ``wk`` and ``wv``): their
    gradients are partial on each model rank and are summed over
    ``"model"`` before the update."""
    out = set()
    for name, spec in specs.items():
        layer, _, leaf = name.rpartition(".")
        wq = specs.get(f"{layer}.wq")
        if (leaf in ("bq", "bk", "bv", "wk", "wv") and wq is not None
                and "model" in wq and "model" not in spec
                and splits_heads(cfg, tp, cfg.n_heads * cfg.hd // tp)):
            out.add(name)
    return out


def proj(x, w, cols: int, par=None):
    """``x @ w`` with ``cols`` output columns.  Where a mesh (``par``)
    splits ``w``'s columns over "model", this rank's columns' product
    is gathered whole: the activations cross the mesh, not the weight."""
    y = x @ w.to(x.dtype)
    if par is not None and w.shape[-1] != cols:
        y = par.mesh.all_gather(y, axis=par.tp_axis, dim=-1)
    return y


def out_proj(a, w, par=None):
    """``a @ w`` for a whole ``a``.  Where a mesh (``par``) splits
    ``w``'s rows over "model", this rank's rows times its block of
    ``a``, summed over "model"."""
    rows = w.shape[0]
    if par is None or rows == a.shape[-1]:
        return a @ w.to(a.dtype)
    r = par.tp_rank
    part = a[..., r * rows:(r + 1) * rows] @ w.to(a.dtype)
    return par.mesh.all_reduce(part, axis=par.tp_axis)


def _qkv(x, p, cfg, par=None):
    """Q, K and V of ``x``, whole (``proj``)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = proj(x, p.wq, h * hd, par)
    k = proj(x, p.wk, kv * hd, par)
    v = proj(x, p.wv, kv * hd, par)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return q, k, v


def _attn_apply(x, p, cfg, kind, positions, par=None):
    if par is not None and par.tp > 1:
        return _attn_tp(x, p, cfg, kind, positions, par)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = _qkv(x, p, cfg)
    q = layers.rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = layers.rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
    out = layers.chunked_attention(
        q, k, v.reshape(b, s, kv, hd), causal=True,
        window=window_for(kind, cfg), softcap=cfg.attn_softcap)
    return out.reshape(b, s, h * hd) @ p.wo.to(x.dtype)


def _attn_tp(x, p, cfg, kind, positions, par):
    """The attention on this model rank's query heads (module
    docstring); the row-parallel ``wo`` product summed over "model"."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    tp, r = par.tp, par.tp_rank
    if not splits_heads(cfg, tp, p.wq.shape[-1]):
        return _attn_apply(x, _whole_attn(p, cfg, par), cfg, kind, positions)
    hl = h // tp                                    # this rank's q heads
    dt = x.dtype
    xi = par.copy(x)
    q = xi @ p.wq.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq[r * hl * hd:(r + 1) * hl * hd].to(dt)
    if p.wk.shape[-1] * tp == kv * hd and kv % tp == 0:
        kvl = kv // tp                              # its own kv heads
        cols = slice(r * kvl * hd, (r + 1) * kvl * hd)
        k, v = xi @ p.wk.to(dt), xi @ p.wv.to(dt)
        if cfg.qkv_bias:
            k, v = k + p.bk[cols].to(dt), v + p.bv[cols].to(dt)
        k, v = k.reshape(b, s, kvl, hd), v.reshape(b, s, kvl, hd)
    else:                  # the whole K and V, then its heads' kv heads
        wk, wv = p.wk, p.wv
        if wk.shape[-1] != kv * hd:
            wk, wv = par.gather(wk, -1), par.gather(wv, -1)
        k, v = xi @ wk.to(dt), xi @ wv.to(dt)
        if cfg.qkv_bias:
            k, v = k + p.bk.to(dt), v + p.bv.to(dt)
        idx = (r * hl + torch.arange(hl, device=x.device)) // (h // kv)
        k = k.reshape(b, s, kv, hd)[:, :, idx]
        v = v.reshape(b, s, kv, hd)[:, :, idx]
    q = layers.rope(q.reshape(b, s, hl, hd), positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    out = layers.chunked_attention(
        q, k, v, causal=True, window=window_for(kind, cfg),
        softcap=cfg.attn_softcap)
    return par.reduce(out.reshape(b, s, hl * hd) @ p.wo.to(dt))


def _whole_attn(p, cfg, par):
    """``p`` with each split weight gathered whole (every model rank
    then computes the same, and takes its own block of the gradient)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    full = {"wq": (-1, h * hd), "wk": (-1, kv * hd), "wv": (-1, kv * hd),
            "wo": (0, h * hd)}
    out = dict(p.named_parameters()) if isinstance(p, torch.nn.Module) \
        else dict(vars(p))
    for n, (dim, size) in full.items():
        if out[n].shape[dim] != size:
            out[n] = par.gather(out[n], dim, "own")
    return types.SimpleNamespace(**out)


def _ffn(x, p: Block, cfg, kind, par=None):
    """The residual's second half: norm2, the MLP or the experts (and
    the dense residual), post-norm -> (x, aux)."""
    eps = cfg.norm_eps
    hin = layers.rms_norm(x, p.norm2, eps)
    aux = {}
    if kind == "moe":
        m, aux = moe.moe_ffn(hin, p.moe, cfg, par)
        if cfg.dense_residual:
            m = m + mlp(hin, p.mlp, cfg, par)
    else:
        m = mlp(hin, p.mlp, cfg, par)
    if cfg.post_norms:
        m = layers.rms_norm(m, p.norm2b, eps)
    return x + m, aux


def apply_block(x, p: Block, cfg, kind: str, positions=None, par=None):
    """One block, prefill form. x: (B, S, D) -> (x, aux); ``par`` the
    rank's place on a mesh (module docstring), None on one device."""
    eps = cfg.norm_eps
    if kind == "ssm":
        return x + ssm.forward(layers.rms_norm(x, p.norm1, eps),
                               p.ssm, cfg), {}
    if kind == "rec":
        x = x + rglru.forward(layers.rms_norm(x, p.norm1, eps), p.rec, cfg)
        return x + mlp(layers.rms_norm(x, p.norm2, eps), p.mlp, cfg,
                       par), {}
    a = _attn_apply(layers.rms_norm(x, p.norm1, eps), p.attn, cfg, kind,
                    positions, par)
    if cfg.post_norms:
        a = layers.rms_norm(a, p.norm1b, eps)
    return _ffn(x + a, p, cfg, kind, par)


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


def _attn_decode(x, p, cache, cfg, pos, par=None, spec=None):
    """One token's attention; K and V are written in place at slot
    ``pos % W`` (the ring holds exactly the window, so the read needs
    no window mask).  Under a mesh (``par``), ``cache`` holds this
    rank's block of the K and V of ``spec`` (``launch.cells.cache_specs``:
    batch rows, then slots, kv heads or head dimensions over mesh axes);
    each model rank projects with its block of the split weights and the
    products are gathered (``proj``), so every rank holds every head's
    query, ``layers.sharded_decode_attention`` writes the slot where
    this rank holds it and combines the ranks' parts, and ``wo``'s
    partial products are summed (``out_proj``)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q, k, v = _qkv(x, p, cfg, par)
    posv = torch.full((b, 1), pos, device=x.device)
    q = layers.rope(q.reshape(b, 1, h, hd), posv, cfg.rope_theta)
    k = layers.rope(k.reshape(b, 1, kv, hd), posv, cfg.rope_theta)
    if par is not None:
        out = layers.sharded_decode_attention(
            q, cache, pos + 1, par.mesh, spec, new_kv=(
                k[:, 0], v.reshape(b, kv, hd)), softcap=cfg.attn_softcap)
        return out_proj(out.reshape(b, 1, h * hd), p.wo, par), cache
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v.reshape(b, kv, hd).to(cache["v"].dtype)
    out = layers.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                  softcap=cfg.attn_softcap)
    return out.reshape(b, 1, h * hd) @ p.wo.to(x.dtype), cache


def decode_block(x, p: Block, cache: dict, cfg, kind: str, pos, par=None,
                 spec=None):
    """One layer's decode step -> (x, cache); caches are updated in
    place where the reference donates them.  ``par`` and ``spec``: the
    rank's place on a mesh and its cache block's spec (``_attn_decode``;
    the SSM and RG-LRU states split over "model" in ``ssm`` and
    ``rglru``), the MLP and the experts as in the forward."""
    eps = cfg.norm_eps
    if kind == "ssm":
        y, nc = ssm.decode_step(layers.rms_norm(x, p.norm1, eps),
                                cache, p.ssm, cfg, par, spec)
        return x + y, nc
    if kind == "rec":
        y, nc = rglru.decode_step(layers.rms_norm(x, p.norm1, eps),
                                  cache, p.rec, cfg, par, spec)
        x = x + y
        return x + mlp(layers.rms_norm(x, p.norm2, eps), p.mlp, cfg,
                       par), nc
    a, nc = _attn_decode(layers.rms_norm(x, p.norm1, eps), p.attn, cache,
                         cfg, pos, par, spec)
    if cfg.post_norms:
        a = layers.rms_norm(a, p.norm1b, eps)
    return _ffn(x + a, p, cfg, kind, par)[0], nc
