"""Model factory (twin of ``repro.models.api``): ``build(cfg)`` and the
inference steps, prefill and greedy decode.

Only the ssm family (Mamba2) is ported; ``build`` raises for the others
(ROADMAP Queue 1 item 14c), and training raises until item 14b.  Both
steps run under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import device as device_mod
from ..device import not_ported
from . import lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable             # (torch.Generator) -> lm.LM
    loss_fn: Callable                 # (params, batch) -> (loss, aux)
    init_cache: Callable              # (batch, max_len) -> cache
    decode_step: Callable             # (params, cache, token, pos) -> ...


def _training(*_args, **_kwargs):
    raise not_ported("training", "Queue 1 item 14b")


def build(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` unless ``"cpu"``)."""
    if cfg.family != "ssm":
        raise not_ported(f"the {cfg.family!r} family", "Queue 1 item 14c")
    dev = device_mod.resolve(device)

    def init_params(gen: torch.Generator) -> lm.LM:
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return lm.init_params(gen, cfg)

    return Model(
        cfg=cfg, init_params=init_params, loss_fn=_training,
        init_cache=lambda batch, max_len: lm.init_cache(cfg, batch, max_len,
                                                        dev),
        decode_step=lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
    )


def init_train_state(*args, **kwargs):
    _training()


def make_train_step(*args, **kwargs):
    _training()


def make_prefill_step(model: Model):
    """Inference prefill: no-grad forward, last-position logits."""
    cfg = model.cfg

    @torch.no_grad()
    def step(params, batch):
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
