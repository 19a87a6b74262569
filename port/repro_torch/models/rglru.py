"""RecurrentGemma / Griffin RG-LRU recurrent block (twin of
``repro.models.rglru``; arXiv:2402.19427).

    r_t = σ(W_r x_t);  i_t = σ(W_i x_t);  a_t = a^(c·r_t)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill scans the (a, b) pairs in float32 by Hillis-Steele doubling
(log2 L passes over the sequence, the reference's associative operator
in another order than ``lax.associative_scan``'s tree); decode is the
one-step recurrence.  Training differentiates the doubling scan with
autograd.  The block is Griffin's: (linear → conv1d →
RG-LRU) gated by (linear → gelu), then projected out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.parallel import block_index, spec_axes
from . import layers

_C = 8.0


def init_params(gen: torch.Generator, cfg) -> layers.Params:
    d = cfg.d_model
    w = cfg.rglru_width or d
    return layers.Params({
        "in_x": layers.dense_init(gen, (d, w)),
        "in_gate": layers.dense_init(gen, (d, w)),
        "conv_w": layers.dense_init(gen, (4, w)),
        "w_r": layers.dense_init(gen, (w, w)),
        "w_i": layers.dense_init(gen, (w, w)),
        # Λ init so that a = σ(Λ) ∈ (0.9, 0.999)
        "lam": torch.full((w,), 4.0, device=gen.device),
        "out": layers.dense_init(gen, (w, d)),
    })


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(u, p):
    uf = layers.up(u)
    r = torch.sigmoid(uf @ p.w_r)
    i = torch.sigmoid(uf @ p.w_i)
    # softplus as jax's logaddexp(x, 0): torch's returns x above 20
    log_a = -_C * r * torch.logaddexp(p.lam, torch.zeros_like(p.lam))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, gated


def scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by
    doubling: after the pass of stride d each position holds the
    composition of its last 2d steps, ``(a1, b1) then (a2, b2)`` being
    ``(a1 a2, b1 a2 + b2)``."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def forward(x, p, cfg):
    """x: (B, L, D) -> (B, L, D)."""
    u = x @ p.in_x.to(x.dtype)
    gate = _gelu(x @ p.in_gate.to(x.dtype))
    u = layers.causal_dconv(u, p.conv_w.to(x.dtype))
    a, b = _gates(u, p)
    h = scan(a, b)
    return (h.to(x.dtype) * gate) @ p.out.to(x.dtype)


def init_cache(cfg, batch: int, dtype, device) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def decode_step(x, cache: dict, p, cfg, par=None, spec=None):
    """x: (B, 1, D) -> (y, new cache).  Under a mesh (``par``) whose
    cache ``spec`` splits the channels W over mesh axes
    (``launch.cells.cache_specs``), the conv history is gathered, the
    gates run whole on every rank, each rank keeps its channels of the
    state and of the new history, and the state is gathered for the
    output."""
    mesh = None if par is None else par.mesh
    c_ax = () if mesh is None else spec_axes(spec["conv"][-1])
    h_ax = () if mesh is None else spec_axes(spec["h"][-1])
    conv = cache["conv"]
    for a in reversed(c_ax):
        conv = mesh.all_gather(conv, axis=a, dim=-1)
    u = x @ p.in_x.to(x.dtype)
    gate = _gelu(x @ p.in_gate.to(x.dtype))
    hist = torch.cat([conv, u], dim=1)                        # (B, 4, W)
    # the reference's einsum "bkw,kw->bw" (float32 sums of the exact
    # products, one rounding) as a product and a sum: torch runs the
    # einsum as W batched matrix-vector products, strided, 0.7 of a
    # decode step at full width
    w = p.conv_w.to(x.dtype).float()
    u_c = (hist.float() * w).sum(dim=1).to(x.dtype)[:, None, :]
    a, b = _gates(u_c, p)
    hi, nh = (0, 1) if mesh is None else block_index(mesh, h_ax)
    wl = a.shape[-1] // nh
    own = slice(hi * wl, (hi + 1) * wl)
    h_own = cache["h"] * a[:, 0, own] + b[:, 0, own]
    h = h_own
    for ax in reversed(h_ax):
        h = mesh.all_gather(h, axis=ax, dim=-1)
    y = (h[:, None, :].to(x.dtype) * gate) @ p.out.to(x.dtype)
    if not c_ax:
        return y, {"conv": hist[:, 1:], "h": h_own}
    ci, nc = block_index(mesh, c_ax)
    cl = hist.shape[-1] // nc
    return y, {"conv": hist[:, 1:, ci * cl:(ci + 1) * cl].contiguous(),
               "h": h_own}
