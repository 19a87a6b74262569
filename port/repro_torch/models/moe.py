"""Top-k routed MoE FFN with sort-based capacity dispatch (twin of
``repro.models.moe``).

A float32 router picks each token's top-k experts and renormalises
their gates; one stable sort of the expert ids gives every (token,
choice) its rank within its expert; ranks below the capacity ``cap``
fill a fixed (E, cap, D) buffer and the rest are dropped (the analogue
of a partition's overflow); batched einsums run all experts; the
inverse permutation gathers the outputs back, weighted by the gates.
Training differentiates it with autograd: the buffer's writes pass the
gradient back to the kept choices only (the trash row is cut before the
experts run), and the gates' gradient reaches the router through
``topk``.

The reference's shard_map form (``set_local_moe``, ``moe_ffn_local``)
dispatches each device's own tokens under a mesh: it waits for the
mesh mode (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

from ..core.fma import fma32
from ..device import not_ported
from . import layers


def init_params(gen: torch.Generator, cfg) -> layers.Params:
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.moe_ff or cfg.d_ff
    return layers.Params({
        "wr": layers.dense_init(gen, (d, e)),
        "w1": layers.dense_init(gen, (e, d, fe)),
        "w3": layers.dense_init(gen, (e, d, fe)),
        "w2": layers.dense_init(gen, (e, fe, d)),
    })


def set_local_moe(spec) -> None:
    if spec is not None:
        raise not_ported("the shard_map MoE dispatch", "Queue 1 item 10")


def moe_ffn_local(x, p, cfg):
    raise not_ported("the shard_map MoE dispatch", "Queue 1 item 10")


def dispatch(eids: torch.Tensor, e: int, cap: int) -> dict:
    """(T, k) expert ids -> the stable-sort dispatch: ``order`` (sorted
    position -> flat choice), each choice's rank within its expert, and
    the capacity slot it takes (``cap`` for a dropped one)."""
    t, k = eids.shape
    flat_e = eids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # a one-hot sum: CUDA's bincount reads the largest id on the host
    counts = (flat_e[:, None] == torch.arange(e, device=eids.device)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=eids.device) - starts[sorted_e]
    keep = rank_sorted < cap
    return dict(flat_e=flat_e, order=order, sorted_e=sorted_e,
                counts=counts, keep=keep,
                slot=torch.where(keep, rank_sorted, cap))


def moe_ffn(x, p, cfg):
    """x: (B, S, D); p: one layer's {wr, w1, w3, w2} -> (y, aux), aux
    the load-balance loss and the expert-payload stats (the reference's
    ``_moe_math``: its ``moe_ffn`` takes it off a mesh)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    xt = x.reshape(t, d)

    logits = layers.up(xt) @ layers.up(p.wr)
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate, eids = torch.topk(probs, k, dim=-1)                 # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- dispatch: stable sort by expert id ----
    dp = dispatch(eids, e, cap)
    tok_sorted = dp["order"] // k
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dp["sorted_e"], dp["slot"]] = xt[tok_sorted]          # cap = trash
    buf = buf[:, :cap]                                        # (E, C, D)

    # ---- expert compute (batched over E) ----
    h = layers.act_fn(cfg.act)(
        torch.einsum("ecd,edf->ecf", buf, p.w1.to(x.dtype))
    ) * torch.einsum("ecd,edf->ecf", buf, p.w3.to(x.dtype))
    y_e = torch.einsum("ecf,efd->ecd", h, p.w2.to(x.dtype))
    y_e = torch.cat([y_e, torch.zeros((e, 1, d), dtype=y_e.dtype,
                                      device=x.device)], dim=1)

    # ---- combine: flat choice -> its slot through the inverse order ----
    inv = torch.argsort(dp["order"], stable=True)
    rank_flat = dp["slot"][inv]
    y_tk = y_e[dp["flat_e"], rank_flat].reshape(t, k, d)
    y = torch.sum(y_tk * gate[..., None].to(y_tk.dtype), dim=1)

    # aux: Switch-style load-balance loss + payload skew (paper metric)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(eids[:, 0], e).to(probs.dtype).mean(
        dim=0)
    lb_loss = e * torch.sum(me * ce)
    payload = dp["counts"].float()
    # the reference runs jitted (its layer scan, its decode step), and
    # XLA multiplies by the float32 reciprocal of the constant t*k and
    # fuses the subtraction: drop_frac is fma(-kept, 1/(t*k), 1); the
    # constants are host scalars (a copy to the card would synchronise)
    one = torch.tensor(1.0)
    recip = one / torch.tensor(float(t * k))
    kept = torch.clamp(payload, max=cap).sum()
    aux = {
        "lb_loss": lb_loss,
        "expert_skew": payload.max() / torch.clamp(payload.mean(), min=1e-9),
        "drop_frac": fma32(-kept, recip, one),
    }
    return y.reshape(b, s, d), aux
