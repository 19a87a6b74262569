"""Whisper-style encoder-decoder backbone (twin of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: precomputed frame
embeddings (B, src_len, d_model) go straight into the encoder.  Encoder
= bidirectional attention blocks; decoder = causal self-attention,
cross-attention and gated-MLP blocks.  Encoder keys and decoder queries
are roped with their own positions, in the cross-attention too, as the
reference does.  The logits take no sqrt(d) embedding scale (unlike
``lm``).

Training differentiates the forward with autograd, each encoder and
decoder layer rematerialised in the backward, as the reference
checkpoints its layer bodies whatever ``remat`` says.

Parameters: ``embed``, ``enc[i]`` (``norm1``, ``attn``, ``norm2``,
``mlp``), ``dec[i]`` (``norm1``, ``attn``, ``normx``, ``xattn``,
``norm2``, ``mlp``), ``enc_norm``, ``final_norm``: ``enc.i.attn.wq`` is
layer i of the reference's stacked ``enc.attn.wq``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..dist.parallel import block_index, spec_axes
from . import blocks, layers, lm
from .config import ModelConfig


class EncDec(nn.Module):
    def __init__(self, embed, enc: list, dec: list, enc_norm, final_norm):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> EncDec:
    """Random init on the generator's device (float32 weights)."""
    d, v = cfg.d_model, cfg.vocab_padded

    def norm():
        return torch.zeros(d, device=gen.device)

    embed = layers.dense_init(gen, (v, d))
    enc = [blocks.Block({"norm1": norm(), "norm2": norm()},
                        {"attn": blocks.attn_init(gen, cfg),
                         "mlp": blocks.mlp_init(gen, cfg)})
           for _ in range(cfg.enc_layers)]
    dec = [blocks.Block({"norm1": norm(), "normx": norm(), "norm2": norm()},
                        {"attn": blocks.attn_init(gen, cfg),
                         "xattn": blocks.attn_init(gen, cfg),
                         "mlp": blocks.mlp_init(gen, cfg)})
           for _ in range(cfg.n_layers)]
    return EncDec(embed, enc, dec, norm(), norm())


def _positions(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def _mha(x, kv_src, p, cfg, *, causal, positions, kv_positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    src = kv_src.shape[1]
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, h, hd)
    k = (kv_src @ p.wk.to(x.dtype)).reshape(b, src, kv, hd)
    v = (kv_src @ p.wv.to(x.dtype)).reshape(b, src, kv, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, kv_positions, cfg.rope_theta)
    out = layers.chunked_attention(q, k, v, causal=causal)
    return out.reshape(b, s, h * hd) @ p.wo.to(x.dtype)


def _remat(fn, *args):
    """``fn(*args)``, rematerialised in the backward when grad is on."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


def _enc_layer(x, p, cfg, pos):
    hn = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    x = x + _mha(hn, hn, p.attn, cfg, causal=False, positions=pos,
                 kv_positions=pos)
    return x + blocks.mlp(layers.rms_norm(x, p.norm2, cfg.norm_eps), p.mlp,
                          cfg)


def _dec_layer(x, p, enc_out, cfg, pos, kv_pos):
    hn = layers.rms_norm(x, p.norm1, cfg.norm_eps)
    x = x + _mha(hn, hn, p.attn, cfg, causal=True, positions=pos,
                 kv_positions=pos)
    hx = layers.rms_norm(x, p.normx, cfg.norm_eps)
    x = x + _mha(hx, enc_out, p.xattn, cfg, causal=False, positions=pos,
                 kv_positions=kv_pos)
    return x + blocks.mlp(layers.rms_norm(x, p.norm2, cfg.norm_eps), p.mlp,
                          cfg)


def encode(params: EncDec, frames, cfg: ModelConfig):
    x = frames.to(lm._dt(cfg))
    b, s, _ = x.shape
    pos = _positions(b, s, x.device)
    for p in params.enc:
        x = _remat(_enc_layer, x, p, cfg, pos)
    return layers.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _logits_of(x, params: EncDec, cfg):
    logits = layers.up(x @ params.embed.to(x.dtype).T)
    if cfg.vocab_padded != cfg.vocab:
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits, -1e9)
    return logits


def _embed(params: EncDec, tokens, dtype):
    # cast, then gathered in training, as the reference does (the
    # embedding's gradient accumulates in the activations' type there);
    # inference gathers first: the same values, no (V, D) copy
    if torch.is_grad_enabled():
        return params.embed.to(dtype)[tokens]
    return params.embed[tokens].to(dtype)


def forward(params: EncDec, frames, tokens, cfg: ModelConfig,
            logits_mode: str = "all"):
    """Teacher-forcing enc-dec forward -> (logits float32, aux)."""
    enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens, enc_out.dtype)
    b, s, _ = x.shape
    pos = _positions(b, s, x.device)
    kv_pos = _positions(b, enc_out.shape[1], x.device)
    for p in params.dec:
        x = _remat(_dec_layer, x, p, enc_out, cfg, pos, kv_pos)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]
    return _logits_of(x, params, cfg), {}


def loss_fn(params: EncDec, batch: dict, cfg: ModelConfig,
            remat: str = "full", par=None):
    """Next-token cross-entropy and z-loss of the decoder's tokens ->
    (loss, {}).  batch: {frames, tokens}.  ``remat`` is taken and not
    read, as in the reference: every layer is rematerialised.  Under a
    mesh (``par``) the loss is this rank's part of the global loss, the
    forward whole on every model rank (the train step hands it the
    gathered weights)."""
    logits, aux = forward(params, batch["frames"], batch["tokens"], cfg)
    if par is not None:
        return par.objective(*lm.nll_sums(logits, batch["tokens"]),
                             aux), aux
    return lm.nll(logits, batch["tokens"]), aux


# ------------------------------ decode ------------------------------------

def init_cache(params: EncDec, frames, cfg: ModelConfig, max_len: int):
    """The cross-attention K/V of every decoder layer from the encoder
    (keys roped at the source positions), and a zeroed self-attention
    cache of ``max_len`` -> {"self": [{k, v}], "cross": [{k, v}]}."""
    enc_out = encode(params, frames, cfg)
    b, src, _ = enc_out.shape
    kv, hd = cfg.n_kv, cfg.hd
    kv_pos = _positions(b, src, enc_out.device)
    cross = []
    for p in params.dec:
        k = (enc_out @ p.xattn.wk.to(enc_out.dtype)).reshape(b, src, kv, hd)
        v = (enc_out @ p.xattn.wv.to(enc_out.dtype)).reshape(b, src, kv, hd)
        cross.append({"k": layers.rope(k, kv_pos, cfg.rope_theta), "v": v})
    self_c = [blocks.attn_cache_init(cfg, "full", b, max_len, lm._dt(cfg),
                                     enc_out.device)
              for _ in range(cfg.n_layers)]
    return {"self": self_c, "cross": cross}


def decode_step(params: EncDec, cache: dict, token, pos, cfg: ModelConfig,
                par=None, specs=None):
    """One decode step.  token: (B,) -> (logits, cache); the
    self-attention cache is written at ``pos`` in place.  Under a mesh
    (``par``; ``token`` this rank's rows) the self and cross caches hold
    this rank's blocks of ``specs`` (``launch.cells.cache_specs``) and
    run through ``layers.sharded_decode_attention``, the split attention
    weights' products gathered or summed (``blocks.proj``,
    ``blocks.out_proj``)."""
    x = _embed(params, token[:, None], lm._dt(cfg))
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    posv = torch.full((b, 1), pos, device=x.device)
    for i, (p, selfc, crossc) in enumerate(zip(params.dec, cache["self"],
                                               cache["cross"])):
        attn, xattn = p.attn, p.xattn
        hn = layers.rms_norm(x, p.norm1, cfg.norm_eps)
        q = blocks.proj(hn, attn.wq, h * hd, par).reshape(b, 1, h, hd)
        k = blocks.proj(hn, attn.wk, kv * hd, par).reshape(b, 1, kv, hd)
        v = blocks.proj(hn, attn.wv, kv * hd, par).reshape(b, kv, hd)
        q = layers.rope(q, posv, cfg.rope_theta)
        k = layers.rope(k, posv, cfg.rope_theta)
        src = crossc["k"].shape[1]
        if par is None:
            selfc["k"][:, pos] = k[:, 0].to(selfc["k"].dtype)
            selfc["v"][:, pos] = v.to(selfc["v"].dtype)
            a = layers.decode_attention(q, selfc["k"], selfc["v"], pos + 1)
        else:
            a = layers.sharded_decode_attention(
                q, selfc, pos + 1, par.mesh, specs["self"][i],
                new_kv=(k[:, 0], v))
            src *= _slot_blocks(par.mesh, specs["cross"][i])
        x = x + blocks.out_proj(a.reshape(b, 1, h * hd), attn.wo, par)
        hx = layers.rms_norm(x, p.normx, cfg.norm_eps)
        qx = blocks.proj(hx, xattn.wq, h * hd, par).reshape(b, 1, h, hd)
        qx = layers.rope(qx, posv, cfg.rope_theta)
        if par is None:
            ax = layers.decode_attention(qx, crossc["k"], crossc["v"],
                                         src)
        else:
            ax = layers.sharded_decode_attention(qx, crossc, src,
                                                 par.mesh,
                                                 specs["cross"][i])
        x = x + blocks.out_proj(ax.reshape(b, 1, h * hd), xattn.wo, par)
        x = x + blocks.mlp(layers.rms_norm(x, p.norm2, cfg.norm_eps),
                           p.mlp, cfg, par)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits_of(x[:, 0], params, cfg), cache


def _slot_blocks(mesh, spec: dict) -> int:
    """How many blocks the slots of a K/V leaf of ``spec`` split into."""
    return block_index(mesh, spec_axes(spec["k"][1]))[1]
