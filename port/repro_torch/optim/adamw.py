"""AdamW with global-norm clipping and memory-dtype policies (twin of
``repro.optim.adamw``).

Policies (optimizer bytes a parameter, beside the float32 master
weights): ``fp32`` m and v float32 (8 B), the default; ``bf16_m`` m
bf16, v float32 (6 B); ``bf16_mv`` m and v bf16 (4 B).

A tree is a dict of name -> tensor, walked in its own order: the train
step passes the model's parameters in the order of ``jax.tree.leaves``
over the reference's pytree (``models.lm.named_leaves``), so the global
norm sums its leaves in the reference's order.  ``update`` writes the
new parameters and moments into the tensors it is given (the reference
donates them) and returns them.

The reference decays a leaf iff its own array has two dimensions or
more, and it stacks every block parameter over the super-block axis;
``update`` takes each leaf's dimension count in the reference as
``ndims`` (``models.lm.ref_ndims``), and a leaf's own ``dim()`` where
none is given.  The step count, the schedule, the bias corrections and
the learning rate are float32 tensors on the parameters' device, as
the jitted reference computes them; divisors are tensors, since CUDA
divides by a Python scalar as a product with its reciprocal.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_policy: str = "fp32"      # fp32 | bf16_m | bf16_mv
    warmup: int = 100
    total_steps: int = 10000


def _m_dtype(p):
    return torch.bfloat16 if p in ("bf16_m", "bf16_mv") else torch.float32


def _v_dtype(p):
    return torch.bfloat16 if p == "bf16_mv" else torch.float32


@dataclasses.dataclass
class OptState:
    m: dict
    v: dict
    step: torch.Tensor              # int32, 0-d


def init_state(params: dict, cfg: AdamWConfig) -> OptState:
    some = next(iter(params.values()))
    return OptState(
        m={k: torch.zeros_like(p, dtype=_m_dtype(cfg.state_policy),
                               requires_grad=False)
           for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=_v_dtype(cfg.state_policy),
                               requires_grad=False)
           for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=some.device))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to a tenth of it, as a
    float32 tensor (``step`` an int tensor or a Python int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    dev = step.device
    warm = torch.minimum(step / _f32(max(cfg.warmup, 1), dev),
                         _f32(1.0, dev))
    frac = torch.clamp((step - cfg.warmup)
                       / _f32(max(cfg.total_steps - cfg.warmup, 1), dev),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * frac))
    return _f32(cfg.lr, dev) * warm * (0.1 + 0.9 * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the dict's order."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: dict, state: OptState, params: dict, cfg: AdamWConfig,
           ndims: dict | None = None, gnorm: torch.Tensor | None = None):
    """One AdamW step -> (params, state, {"grad_norm", "lr"}); ``params``
    and the state's moments are updated in place.  ``gnorm``: the
    gradients' global norm where ``grads`` are one rank's shards of
    them (``global_norm`` of ``grads`` if None)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev)
                          / torch.maximum(gnorm, _f32(1e-9, dev)))
    step = state.step + 1
    lr = schedule(step, cfg)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, dev), stepf)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, dev), stepf)
    for k, p in params.items():
        nd = p.dim() if ndims is None else ndims[k]
        decay = cfg.weight_decay if nd >= 2 else 0.0
        for p_, g, m, v in _chunks(p, grads[k], state.m[k], state.v[k]):
            g = g.float() * scale
            m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
            v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            p32 = p_.float()
            p_.copy_(p32 - lr * (u + decay * p32))
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(m=state.m, v=state.v, step=step), {
        "grad_norm": gnorm, "lr": lr}


_CHUNK = 1 << 26     # elements an update pass takes at once


def _chunks(*ts):
    """Matching flat blocks of ``_CHUNK`` elements of contiguous tensors
    (the whole tensors otherwise): the update is elementwise, so its
    float32 temporaries need only a block's room (an embedding of 389 M
    parameters would take about 6 GB of them whole)."""
    if ts[0].numel() <= _CHUNK or not all(t.is_contiguous() for t in ts):
        return [ts]
    flat = [t.view(-1) for t in ts]
    return [[f[i:i + _CHUNK] for f in flat]
            for i in range(0, flat[0].numel(), _CHUNK)]
