"""Model factory (twin of ``repro.models.api``): ``build(cfg)``, the
train state and step, and the inference steps, prefill and greedy
decode.

Every family serves and trains.  Prefill and greedy decode run under
``torch.no_grad()``; the train step differentiates the model's loss
with ``torch.autograd.grad`` and updates the state in place.  The
encoder-decoder family has no ``init_cache``, as in the reference: its
cache comes from ``encdec.init_cache(params, frames, cfg, max_len)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import device as device_mod
from ..optim import adamw
from . import encdec, lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable             # (torch.Generator) -> lm.LM | EncDec
    loss_fn: Callable                 # (params, batch) -> (loss, aux)
    init_cache: Callable | None       # (batch, max_len) -> cache
    decode_step: Callable             # (params, cache, token, pos) -> ...


def build(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = device_mod.resolve(device)
    family = encdec if cfg.family == "encdec" else lm

    def init_params(gen: torch.Generator):
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return family.init_params(gen, cfg)

    if cfg.family == "encdec":
        return Model(
            cfg=cfg, init_params=init_params,
            loss_fn=lambda p, b, remat="full": encdec.loss_fn(p, b, cfg,
                                                              remat),
            init_cache=None,
            decode_step=lambda p, c, t, pos: encdec.decode_step(p, c, t, pos,
                                                                cfg))
    return Model(
        cfg=cfg, init_params=init_params,
        loss_fn=lambda p, b, remat="full": lm.loss_fn(p, b, cfg, remat),
        init_cache=lambda batch, max_len: lm.init_cache(cfg, batch, max_len,
                                                        dev),
        decode_step=lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
    )


@dataclasses.dataclass
class TrainState:
    params: lm.LM | encdec.EncDec     # float32, requires_grad
    opt: adamw.OptState               # keyed by the parameters' names
    step: torch.Tensor                # int32, 0-d


def init_train_state(model: Model, gen: torch.Generator,
                     opt_cfg: adamw.AdamWConfig) -> TrainState:
    """Random parameters from ``gen`` (which stands for the reference's
    key), with grad on, and zero moments."""
    params = model.init_params(gen).requires_grad_(True)
    return TrainState(
        params=params,
        opt=adamw.init_state(lm.named_leaves(params, model.cfg), opt_cfg),
        step=torch.zeros((), dtype=torch.int32, device=gen.device))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    remat: str = "full", n_micro: int = 1,
                    bf16_weight_gather: bool = False):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr",
    ...})``, and with ``n_micro`` 1 every aux of the loss whose key holds
    "skew" or "drop" (the MoE payload stats), as the reference's.

    ``n_micro`` > 1 accumulates the gradients of sequential microbatches
    in float32 and divides them by ``n_micro``.  ``bf16_weight_gather``
    casts the float32 parameters whose reference leaf has two dimensions
    or more to bf16 before the loss (the reference casts them before its
    FSDP gather); their gradients reach the float32 parameters.  The
    parameters and moments are updated in place, and the state is
    returned.
    """
    cfg = model.cfg

    def view(params):
        if not bf16_weight_gather:
            return params
        nd = lm.ref_ndims(dict(params.named_parameters()), cfg)
        return lm.param_view(params, lambda k, p: p.to(torch.bfloat16) if (
            p.dtype == torch.float32 and nd[k] >= 2) else p)

    def loss_and_grads(params, named, mb):
        loss, aux = model.loss_fn(view(params), mb, remat)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads)), aux

    def step(state: TrainState, batch):
        named = lm.named_leaves(state.params, cfg)
        stats = {}
        if n_micro == 1:
            loss, grads, aux = loss_and_grads(state.params, named, batch)
            stats = {k: v.detach() for k, v in aux.items()
                     if "skew" in k or "drop" in k}
        else:
            mbs = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(n_micro):
                li, gi, _ = loss_and_grads(state.params, named,
                                           {k: v[i] for k, v in mbs.items()})
                for k, g in gi.items():
                    grads[k] += g.float()
                loss = loss + li
                del gi
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        _, opt, om = adamw.update(grads, state.opt, named, opt_cfg,
                                  lm.ref_ndims(named, cfg))
        del grads
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), {"loss": loss, **om,
                                                 **stats}
    return step


def make_prefill_step(model: Model):
    """Inference prefill: no-grad forward, last-position logits.  batch:
    {tokens, [img] (vlm), [frames] (encdec)}."""
    cfg = model.cfg

    @torch.no_grad()
    def step(params, batch):
        if cfg.family == "encdec":
            logits, _ = encdec.forward(params, batch["frames"],
                                       batch["tokens"], cfg,
                                       logits_mode="last")
        else:
            logits, _ = lm.forward(params, batch["tokens"], cfg,
                                   img=batch.get("img"), remat="none",
                                   logits_mode="last")
        return logits[:, -1]
    return step


def make_serve_step(model: Model):
    """One decode step (greedy): token + cache -> next token + cache."""
    @torch.no_grad()
    def step(params, cache, token, pos):
        logits, new_cache = model.decode_step(params, cache, token, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
    return step
