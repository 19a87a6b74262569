"""Decoder-only LM assembly (twin of ``repro.models.lm``) for the dense,
moe, ssm, hybrid and vlm families: embed (and the vlm image prefix), a
``nn.ModuleList`` of blocks walked in a Python loop (the reference scans
stacked super-blocks, then its ``rest`` layers), final norm, tied or
separate unembed with the padded vocab rows masked to -1e9, and the
training loss of every family.  ``cfg.dtype`` "float64" runs every
family but ssm in float64 (given float64 parameters): the yardstick the
float32 gradients are held to, where the reference's own are NaN too.

``remat`` rematerialises each layer in the backward, as the reference
checkpoints its super-block body (one layer for the ssm pattern):
``"full"`` saves only the layer's input, ``"dots"`` also the outputs of
the products without batch dimensions (``aten.mm`` and ``aten.addmm``,
the reference's ``dots_with_no_batch_dims_saveable``).

The reference keeps every block parameter stacked over the super-block
axis, so its leaves have one dimension more than the port's per-layer
tensors, and ``jax.tree.leaves`` walks them in the order of their sorted
keys.  ``ref_path`` maps a port parameter's name to its leaf there: the
optimizer's weight decay, the train step's bf16 cast and the order of
the global norm follow from it.
"""
from __future__ import annotations

import functools
import types

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

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
    """``embed``, ``final_norm``, [``unembed``], [``vis_proj``] and
    ``blocks``, named after ``repro``'s parameter keys; ``blocks[i]`` is
    layer i (the ``rest`` layers last)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers_: list, unembed: torch.Tensor | None = None,
                 vis_proj: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.vis_proj = (None if vis_proj is None
                         else nn.Parameter(vis_proj, requires_grad=False))
        self.blocks = nn.ModuleList(layers_)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random init on the generator's device (float32 weights)."""
    d, v = cfg.d_model, cfg.vocab_padded
    embed = layers.dense_init(gen, (v, d))
    unembed = None if cfg.tie_embeddings else layers.dense_init(gen, (v, d))
    layers_ = [blocks.block_init(gen, cfg, k) for k in kinds(cfg)]
    vis_proj = (layers.dense_init(gen, (cfg.vis_dim, d))
                if cfg.family == "vlm" else None)
    return LM(embed, torch.zeros(d, device=gen.device), layers_, unembed,
              vis_proj)


def ref_path(name: str, cfg: ModelConfig) -> tuple:
    """``(path, layer)``: the key path of parameter ``name`` in
    ``repro``'s pytree and its index along the super-block axis there
    (None for a leaf that is not stacked: ``embed``, ``final_norm``,
    ``unembed``, ``vis_proj`` and the ``rest`` layers').  The
    encoder-decoder's ``enc.i.*`` and ``dec.i.*`` are layer i of the
    stacked ``enc`` and ``dec`` trees."""
    parts = name.split(".")
    if parts[0] in ("enc", "dec"):
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return tuple(parts), None
    pat, n_super, _ = structure(cfg)
    i, leaf = int(parts[1]), tuple(parts[2:])
    if i < n_super * len(pat):
        return ("blocks", f"p{i % len(pat)}") + leaf, i // len(pat)
    return ("rest", f"r{i - n_super * len(pat)}") + leaf, None


def named_leaves(params: "LM", cfg: ModelConfig) -> dict:
    """Name -> parameter, in the order ``jax.tree.leaves`` walks the
    reference's leaves (and a stacked leaf's layers in turn)."""
    def order(name):
        path, layer = ref_path(name, cfg)
        return path, layer or 0

    named = dict(params.named_parameters())
    return {k: named[k] for k in sorted(named, key=order)}


def ref_ndims(params: dict, cfg: ModelConfig) -> dict:
    """Name -> the dimensions of its leaf in the reference: one more for
    a stacked leaf.  The reference decays, and casts to bf16 for the
    weight gather, the leaves with two or more."""
    return {k: p.dim() + (ref_path(k, cfg)[1] is not None)
            for k, p in params.items()}


def param_view(params: "LM", fn) -> types.SimpleNamespace:
    """``params``' structure with each parameter ``p`` named ``name``
    replaced by ``fn(name, p)``, namespaces standing for the modules:
    ``forward`` reads it as it reads the model (the train step's bf16
    weights, whose gradients reach the float32 parameters)."""
    def walk(mod, prefix):
        ns = types.SimpleNamespace(**{
            n: fn(prefix + n, p)
            for n, p in mod.named_parameters(recurse=False)})
        for n, child in mod.named_children():
            setattr(ns, n, [walk(c, f"{prefix}{n}.{i}.")
                            for i, c in enumerate(child)]
                    if isinstance(child, nn.ModuleList)
                    else walk(child, f"{prefix}{n}."))
        return ns
    return walk(params, "")


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}


def _dt(cfg):
    return _DTYPES[cfg.dtype]


def _embed_in(params: LM, tokens, cfg, img=None):
    # the reference casts before the gather; in training that makes the
    # embedding's gradient accumulate in the activations' type as there.
    # Inference gathers first (the same values, no (V, D) copy)
    x = (params.embed.to(_dt(cfg))[tokens] if torch.is_grad_enabled()
         else params.embed[tokens].to(_dt(cfg)))
    if cfg.tie_embeddings:
        # the scale is rounded to the activations' type first, as
        # jnp.asarray(d ** 0.5, x.dtype) does (45.25 in bf16 at d = 2048)
        x = x * layers.rounded(cfg.d_model ** 0.5, x.dtype)
    if img is not None:     # the vlm prefix: projected patches, then text
        vis = img.to(x.dtype) @ params.vis_proj.to(x.dtype)
        x = torch.cat([vis, x], dim=1)
    return x


def _logits_of(x, params: LM, cfg):
    w_out = params.embed if cfg.tie_embeddings else params.unembed
    logits = layers.up(x @ w_out.to(x.dtype).T)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:   # mask pad rows out of the softmax
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits, -1e9)
    return logits


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT = {
    "full": ckpt.noop_context_fn,
    "dots": functools.partial(ckpt.create_selective_checkpoint_contexts,
                              _save_dots),
}


def forward(params: LM, tokens, cfg: ModelConfig, img=None,
            remat: str = "none", logits_mode: str = "all",
            par=None) -> tuple:
    """Teacher-forcing forward -> (logits float32, aux).

    logits_mode="last" computes the unembed only for the final position
    (the prefill path): the (B, S, V) tensor never exists.  ``par``: the
    rank's place on a ``("data", "model")`` mesh (``models.blocks``),
    ``tokens`` its rows of the batch; the embedding, norms and head are
    replicated and run whole on every model rank.
    """
    if remat != "none" and remat not in _REMAT:
        raise ValueError(f"remat must be none, full or dots: {remat!r}")
    x = _embed_in(params, tokens, cfg, img)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    pat, n_super, _ = structure(cfg)
    stacked, aux = {}, {}
    for i, (blk, kind) in enumerate(zip(params.blocks, kinds(cfg))):
        if remat == "none":
            x, a = blocks.apply_block(x, blk, cfg, kind, positions, par)
        else:
            x, a = ckpt.checkpoint(blocks.apply_block, x, blk, cfg, kind,
                                   positions, par, use_reentrant=False,
                                   context_fn=_REMAT[remat])
        # the reference's keys: a pattern position's aux averaged over
        # the super-blocks, a rest layer's as it is
        if i < n_super * len(pat):
            for k, v in a.items():
                stacked.setdefault(f"{kind}{i % len(pat)}_{k}", []).append(v)
        else:
            aux.update({f"rest{i - n_super * len(pat)}_{k}": v
                        for k, v in a.items()})
    aux = {**{k: torch.stack(v).mean() for k, v in stacked.items()}, **aux}
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]
    return _logits_of(x, params, cfg), aux


def _lse_true(logits, tokens):
    txt = logits[:, -tokens.shape[1]:][:, :-1]
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(txt, dim=-1)
    return lse, torch.gather(txt, -1, tgt[..., None])[..., 0]


def nll(logits, tokens):
    """Mean next-token cross-entropy of ``tokens`` under ``logits`` (the
    text positions are the last S), plus the z-loss."""
    lse, true = _lse_true(logits, tokens)
    loss = torch.mean(lse - true)
    return loss + 1e-4 * torch.mean(lse ** 2)


def nll_sums(logits, tokens) -> tuple:
    """``nll``'s terms summed, not averaged -> (sum of cross-entropies,
    sum of lse², the count of labelled positions): a mesh forms the
    global mean from all-reduced sums and counts."""
    lse, true = _lse_true(logits, tokens)
    return torch.sum(lse - true), torch.sum(lse ** 2), lse.numel()


def loss_fn(params: LM, batch: dict, cfg: ModelConfig, remat: str = "full",
            par=None):
    """Next-token cross-entropy -> (loss, aux).  batch: {tokens, [img]},
    every decoder-only family.

    Single pass: nll = logsumexp(logits) - logits[label] over the text
    positions (the vlm's image prefix carries no labels), then the
    z-loss ``1e-4 * mean(lse ** 2)``, then ``0.01 *`` each MoE
    load-balance term of ``aux``.  Under a mesh (``par``, ``batch`` the
    rank's rows) the loss is this rank's part of the global loss
    (``dist.parallel.Parallel.objective``)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg, img=batch.get("img"),
                          remat=remat, par=par)
    if par is not None:
        return par.objective(*nll_sums(logits, tokens), aux), aux
    loss = nll(logits, tokens)
    for k, v in aux.items():
        if k.endswith("lb_loss"):
            loss = loss + 0.01 * v
    return loss, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> list[dict]:
    """One cache a layer: K and V (a ring of the window for a windowed
    kind), the conv history in the activations' type, the SSM and RG-LRU
    states in float32."""
    return [blocks.block_cache_init(cfg, k, batch, max_len, _dt(cfg), device)
            for k in kinds(cfg)]


def decode_step(params: LM, cache: list, token, pos, cfg: ModelConfig,
                par=None, specs=None):
    """One greedy decode step.  token: (B,) int -> (logits, cache); the
    SSM states and the K/V caches are updated in place.  Under a mesh
    (``par``; ``token`` this rank's rows) ``cache`` holds this rank's
    blocks of ``specs`` (``launch.cells.cache_specs``, one dict a
    layer); the head is replicated, so the logits of the rank's rows are
    whole on every model rank."""
    x = _embed_in(params, token[:, None], cfg)
    new_cache = []
    specs = [None] * len(cache) if specs is None else specs
    for blk, c, kind, sp in zip(params.blocks, cache, kinds(cfg), specs):
        x, nc = blocks.decode_block(x, blk, c, cfg, kind, pos, par, sp)
        new_cache.append(nc)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits_of(x[:, 0], params, cfg), new_cache
