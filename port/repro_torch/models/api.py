"""Model factory (twin of ``repro.models.api``): ``build(cfg)``, the
train state and step, and the inference steps, prefill and greedy
decode.

Every family serves and trains.  Prefill and greedy decode run under
``torch.no_grad()``; the train step differentiates the model's loss
with ``torch.autograd.grad`` and updates the state in place.  The
encoder-decoder family has no ``init_cache``, as in the reference: its
cache comes from ``encdec.init_cache(params, frames, cfg, max_len)``.

``make_train_step(..., mesh=)`` is the reference's sharded train step
(its GSPMD step under ``dist.sharding.param_specs``) on one rank of a
``("data", "model")`` process mesh: the state holds this rank's shards
(``dist.sharding.shard_train_state``), every rank is given the same
global batch and takes its rows, and the loss, the gradients, their
norm and the update are the one-device step's over the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import device as device_mod
from ..dist import parallel, sharding
from ..optim import adamw
from . import blocks, encdec, lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable             # (torch.Generator) -> lm.LM | EncDec
    loss_fn: Callable                 # (params, batch[, remat, par]) ->
    #                                   (loss, aux)
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
            loss_fn=lambda p, b, remat="full", par=None: encdec.loss_fn(
                p, b, cfg, remat, par),
            init_cache=None,
            decode_step=lambda p, c, t, pos: encdec.decode_step(p, c, t, pos,
                                                                cfg))
    return Model(
        cfg=cfg, init_params=init_params,
        loss_fn=lambda p, b, remat="full", par=None: lm.loss_fn(
            p, b, cfg, remat, par),
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
                     opt_cfg: adamw.AdamWConfig, mesh=None) -> TrainState:
    """Random parameters from ``gen`` (which stands for the reference's
    key), with grad on, and zero moments; under ``mesh`` the parameters
    are cut to this rank's shards (``dist.sharding.param_specs`` with
    the config's ``shard_experts``) before the moments are made."""
    params = model.init_params(gen).requires_grad_(True)
    if mesh is not None:
        sharding.shard_params(params, sharding.param_specs(
            params, model.cfg, shard_experts=model.cfg.shard_experts,
            mesh=mesh), mesh)
    return TrainState(
        params=params,
        opt=adamw.init_state(lm.named_leaves(params, model.cfg), opt_cfg),
        step=torch.zeros((), dtype=torch.int32, device=gen.device))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    remat: str = "full", n_micro: int = 1,
                    bf16_weight_gather: bool = False, mesh=None):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr",
    ...})``, and with ``n_micro`` 1 every aux of the loss whose key holds
    "skew" or "drop" (the MoE payload stats), as the reference's.

    ``n_micro`` > 1 accumulates the gradients of sequential microbatches
    (microbatch i is the batch's i-th slice) in float32 and divides them
    by ``n_micro``.  ``bf16_weight_gather`` casts the float32 parameters
    whose reference leaf has two dimensions or more to bf16 before the
    loss (the reference casts them before its FSDP gather); their
    gradients reach the float32 parameters.  The parameters and moments
    are updated in place, and the state is returned.

    ``mesh``: a ``("data", "model")`` ``launch.mesh`` ``ProcessMesh``, for
    the step on one rank of it.  Each microbatch splits over the data
    axes when it divides (each rank's rows), else it stays whole on
    every rank.  The loss each rank differentiates is its part of the
    microbatch's global loss (the global mean from all-reduced sums and
    counts, ``dist.parallel.Parallel.objective``); every gradient is
    summed over the data axes, and those of the parameters a
    tensor-parallel attention uses in slices (``blocks.model_partial``)
    over "model" too.  The global norm counts each replicated leaf once
    and sums the split leaves' squares over "model".  AdamW then updates
    each shard in place.  The encoder-decoder's attention has no
    tensor-parallel form: its split weights are gathered whole for the
    forward.
    """
    cfg = model.cfg
    gather = split = partial = want = None
    if mesh is not None:
        full = sharding.abstract_params(cfg)
        specs = sharding.param_specs(full, cfg,
                                     shard_experts=cfg.shard_experts,
                                     mesh=mesh)
        tp = max(sharding.model_size(mesh), 1)
        gather = cfg.family == "encdec"
        split = {k for k, sp in specs.items() if "model" in sp}
        partial = set() if gather else blocks.model_partial(specs, cfg, tp)
        want = {k: tuple(n // tp if a else n
                         for n, a in zip(p.shape, specs[k]))
                for k, p in full.items()}

    def view(params, nd, par):
        if not (bf16_weight_gather or gather):
            return params

        def fn(k, p):
            if bf16_weight_gather and p.dtype == torch.float32 \
                    and nd[k] >= 2:
                p = p.to(torch.bfloat16)
            if gather and k in split:
                p = par.gather(p, specs[k].index("model"), "own")
            return p
        return lm.param_view(params, fn)

    def reduce(grads, loss, par):
        """Sum the gradients and the loss over the mesh in place ->
        (loss, the gradients' global norm)."""
        for k in grads:
            g = grads[k]
            if k in partial:
                g = mesh.all_reduce(g, axis="model")
            grads[k] = par.sum_data(g)
        whole_sq = split_sq = torch.zeros((), dtype=torch.float32,
                                          device=loss.device)
        for k, g in grads.items():
            sq = torch.sum(torch.square(g.float()))
            if k in split:
                split_sq = split_sq + sq
            else:
                whole_sq = whole_sq + sq
        if par.tp > 1:
            split_sq = mesh.all_reduce(split_sq, axis="model")
        return par.sum_data(loss), torch.sqrt(whole_sq + split_sq)

    def step(state: TrainState, batch):
        named = lm.named_leaves(state.params, cfg)
        for k, p in named.items():
            if want is not None and tuple(p.shape) != want[k]:
                raise ValueError(
                    f"{k} is {tuple(p.shape)} on this rank, not its shard "
                    f"{want[k]}: cut the state with "
                    f"dist.sharding.shard_train_state")
        nd = lm.ref_ndims(named, cfg)
        rows = batch["tokens"].shape[0] // n_micro
        par = None if mesh is None else parallel.Parallel.of(mesh, rows)

        def loss_and_grads(i):
            mb = batch if n_micro == 1 else {
                k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            if par is not None:
                mb = {k: par.rows(v) for k, v in mb.items()}
            loss, aux = model.loss_fn(view(state.params, nd, par), mb,
                                      remat, par)
            grads = torch.autograd.grad(loss, list(named.values()))
            return loss.detach(), dict(zip(named, grads)), aux

        stats = {}
        if n_micro == 1:
            loss, grads, aux = loss_and_grads(0)
            stats = {k: v.detach() for k, v in aux.items()
                     if "skew" in k or "drop" in k}
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(n_micro):
                li, gi, _ = loss_and_grads(i)
                for k, g in gi.items():
                    grads[k] += g.float()
                loss = loss + li
                del gi
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        gnorm = None
        if par is not None:
            loss, gnorm = reduce(grads, loss, par)
        _, opt, om = adamw.update(grads, state.opt, named, opt_cfg, nd,
                                  gnorm=gnorm)
        del grads
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), {"loss": loss, **om,
                                                 **stats}
    return step


def make_prefill_step(model: Model, mesh=None):
    """Inference prefill: no-grad forward, last-position logits.  batch:
    {tokens, [img] (vlm), [frames] (encdec)}.

    ``mesh``: a ``("data", "model")`` ``launch.mesh`` mesh, for the step
    on one rank of it, ``params`` this rank's shards of
    ``dist.sharding.param_specs``.  Every rank is given the global
    batch and takes its rows (``dist.parallel.Parallel``); the forward
    runs as the sharded train step's (the encoder-decoder's split
    weights gathered whole), and the rank returns its block of the (B,
    V) logits: its rows, and its vocabulary columns where the padded
    vocabulary splits over "model" (the reference's prefill cell's
    output sharding)."""
    cfg = model.cfg
    specs = None
    if mesh is not None and cfg.family == "encdec":
        specs = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                     shard_experts=cfg.shard_experts,
                                     mesh=mesh)

    @torch.no_grad()
    def step(params, batch):
        par = None
        if mesh is not None:
            par = parallel.Parallel.of(mesh, batch["tokens"].shape[0])
            batch = {k: par.rows(v) for k, v in batch.items()}
        if cfg.family == "encdec":
            if par is not None:
                params = _gathered(params, specs, par)
            logits, _ = encdec.forward(params, batch["frames"],
                                       batch["tokens"], cfg,
                                       logits_mode="last")
        else:
            logits, _ = lm.forward(params, batch["tokens"], cfg,
                                   img=batch.get("img"), remat="none",
                                   logits_mode="last", par=par)
        logits = logits[:, -1]
        if par is not None and par.tp > 1 \
                and cfg.vocab_padded % par.tp == 0:
            v = cfg.vocab_padded // par.tp
            logits = logits[:, par.tp_rank * v:(par.tp_rank + 1) * v]
        return logits
    return step


def _gathered(params, specs: dict, par):
    """``params`` (this rank's shards of ``specs``) with every split
    weight gathered whole, as a namespace tree (``lm.param_view``)."""
    def fn(k, p):
        if "model" in specs[k]:
            p = par.gather(p, specs[k].index("model"), "own")
        return p
    return lm.param_view(params, fn)


def make_serve_step(model: Model, mesh=None, specs=None):
    """One decode step (greedy): token + cache -> next token + cache.

    ``mesh``: the step on one rank of a ``("data", "model")`` mesh:
    ``params`` this rank's shards, ``cache`` its blocks of ``specs``
    (``launch.cells.cache_specs`` of the whole cache); every rank is
    given the global batch's tokens and returns its rows' next tokens
    (``lm.decode_step``, ``encdec.decode_step``)."""
    cfg = model.cfg
    family = encdec if cfg.family == "encdec" else lm
    if mesh is not None and specs is None:
        raise ValueError("a serve step under a mesh needs its cache's "
                         "specs (launch.cells.cache_specs)")

    @torch.no_grad()
    def step(params, cache, token, pos):
        if mesh is None:
            logits, new_cache = model.decode_step(params, cache, token, pos)
        else:
            par = parallel.Parallel.of(mesh, token.shape[0])
            logits, new_cache = family.decode_step(
                params, cache, par.rows(token), pos, cfg, par, specs)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
    return step
