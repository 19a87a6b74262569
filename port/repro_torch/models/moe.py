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

Under a ``("data", "model")`` mesh (``par``, ``dist.parallel.Parallel``)
two forms run, as in the reference:

- ``moe_ffn`` with ``par`` is the answer of the reference's GSPMD step:
  the one-device math over the global batch.  The tokens are gathered
  over the data axes before the dispatch (capacity from the global
  token count) and each data rank keeps its rows of the output.  The
  experts run on this rank's shard: F-split (``shard_experts=False``)
  after ``par.copy``, their outputs summed over "model"; or E-split
  (``shard_experts=True``), each rank its E/tp experts on its rows of
  the (E, cap, D) buffer, the outputs gathered over "model" (the
  E-split router is gathered whole first).  The gated combine then runs
  whole on every model rank, so the gates' and the router's gradients
  are whole there too.
- ``set_local_moe((mesh, dp_axes, "model", "data"))`` turns on the
  reference's ``shard_map`` form, ``moe_ffn_local``: each data rank
  dispatches its own tokens into a local capacity buffer (capacity from
  its local token count), the F-split experts' outputs are summed over
  "model", and the aux terms are ``pmean``'d over "model", then over the
  data axes.  The reference gathers FSDP weight shards over "data"
  first; the port keeps the weights whole over "data"
  (``dist.sharding.param_specs`` splits over "model" only), so there is
  nothing to gather.
"""
from __future__ import annotations

import types

import torch

from ..core.fma import fma32
from ..dist.parallel import Parallel
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


# The reference's switch of the local-dispatch form, set by its launcher:
# (mesh, dp_axes, tp_axis, fsdp_axis) or None.
_LOCAL_SPEC = None


def set_local_moe(spec) -> None:
    global _LOCAL_SPEC
    _LOCAL_SPEC = spec


def moe_ffn_local(x, p, cfg):
    """The reference's ``shard_map`` form on this rank: ``x`` is its
    data rank's tokens (replicated over "model"), ``p`` its F-split
    expert shards and the whole router -> (y, aux), y summed over
    "model", each aux ``pmean``'d over "model", then the data axes."""
    mesh, dp, tp, _ = _LOCAL_SPEC
    par = Parallel(mesh, tp, tuple(dp))
    fe = cfg.moe_ff or cfg.d_ff
    if par.tp > 1 and (p.w1.shape[0] != cfg.n_experts
                       or p.w1.shape[-1] * par.tp != fe):
        raise ValueError("the local MoE form takes F-split expert weights "
                         "(param_specs with shard_experts=False), as the "
                         "reference's launcher sets them")
    y, aux = _moe_math(x, p, cfg, _sharded_experts(par, cfg))
    return y, {k: par.mean(v, (tp,) + tuple(dp)) for k, v in aux.items()}


def experts_ffn(buf, w1, w3, w2, act):
    """(E, C, D) capacity buffer -> (E, C, D): every expert's gated MLP
    on its rows, batched over E, each weight cast to the buffer's type
    where it is used (outside autograd each cast is freed before the
    next: arctic's three bf16 expert copies are 8.9 GB each)."""
    dt = buf.dtype
    h = layers.act_fn(act)(torch.einsum("ecd,edf->ecf", buf, w1.to(dt))) \
        * torch.einsum("ecd,edf->ecf", buf, w3.to(dt))
    return torch.einsum("ecf,efd->ecd", h, w2.to(dt))


def _sharded_experts(par, cfg):
    """The expert step on this model rank's shard -> the whole (E, C, D)
    output on every model rank (module docstring)."""
    e, fe, tp = cfg.n_experts, cfg.moe_ff or cfg.d_ff, par.tp

    def run(buf, w1, w3, w2):
        d = buf.shape[-1]
        shapes = (tuple(w1.shape), tuple(w2.shape))
        if tp > 1 and shapes == ((e, d, fe // tp), (e, fe // tp, d)):
            buf = par.copy(buf)                               # F split
            return par.reduce(experts_ffn(buf, w1, w3, w2, cfg.act))
        if tp > 1 and shapes == ((e // tp, d, fe), (e // tp, fe, d)):
            el = e // tp                                      # E split
            mine = par.copy(buf)[par.tp_rank * el:(par.tp_rank + 1) * el]
            return par.gather(experts_ffn(mine, w1, w3, w2, cfg.act), 0,
                              "own")
        # whole, or split elsewhere (the expert rule on an unstacked
        # ``rest`` layer splits D, as the reference's does): gathered
        # whole, the same work on every rank
        w1, w3 = (_whole(par, w, (e, d, fe)) for w in (w1, w3))
        return experts_ffn(buf, w1, w3, _whole(par, w2, (e, fe, d)),
                           cfg.act)
    return run


def _whole(par, w, shape):
    for dim, n in enumerate(shape):
        if w.shape[dim] != n:
            w = par.gather(w, dim, "own")
    return w


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


def moe_ffn(x, p, cfg, par=None):
    """x: (B, S, D); p: one layer's {wr, w1, w3, w2} -> (y, aux), aux
    the load-balance loss and the expert-payload stats.  The local form
    when ``set_local_moe`` set one; under ``par`` the GSPMD form (module
    docstring); else the one-device math."""
    if _LOCAL_SPEC is not None:
        return moe_ffn_local(x, p, cfg)
    if par is None:
        return _moe_math(x, p, cfg)
    if p.wr.shape[-1] != cfg.n_experts:     # E split: the router whole
        p = types.SimpleNamespace(wr=par.gather(p.wr, -1, "own"), w1=p.w1,
                                  w3=p.w3, w2=p.w2)
    xg = par.gather_batch(x)
    y, aux = _moe_math(xg, p, cfg, _sharded_experts(par, cfg))
    return par.rows(y), aux


def _moe_math(x, p, cfg, experts=None):
    """The reference's ``_moe_math``: the router, the stable-sort
    dispatch, ``experts(buf, w1, w3, w2)`` (all of them on this device
    by default), the gated combine and the aux."""
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
    y_e = (experts_ffn(buf, p.w1, p.w3, p.w2, cfg.act) if experts is None
           else experts(buf, p.w1, p.w3, p.w2))
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
