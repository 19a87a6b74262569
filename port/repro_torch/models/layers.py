"""Shared neural layers (twin of ``repro.models.layers``): the weight
init, the RMS norm, RoPE, attention (prefill and decode), the gated MLP
and the causal depthwise conv.

Prefill attention is the reference's KV-chunked online softmax: float32
scores, a float32 running (max, denominator, accumulator) carried over
512-key chunks.  Two departures, neither of which changes a value the
reference gets finite:

- Where a query's running max is still ``-inf`` (every key it has met
  so far lies outside its window), both ``exp``s take 0 in its place,
  so a chunk wholly outside the window adds exactly 0.  The reference
  forms ``-inf - -inf`` there: NaN from its first such chunk on, for
  ``q_pos >= window + chunk - 1`` (ROADMAP Queue 3).
- The queries go in blocks, and a block visits only the chunks that
  hold a key some query of it may attend (causal and window bounds).
  Every chunk it skips is masked for all its queries, and such a chunk
  leaves the carry as it was (``corr`` is 1, ``p`` is 0).

Training differentiates this forward with autograd (the reference has
no attention backward of its own either); the stand-in keeps the
gradient finite where the reference's is NaN.

``FAST_ATTN`` is the reference's launcher switch for the dry-run's
A/B cells (``launch.cells.build_cell(fast_attn=)``): bf16 scores and
probabilities in ``chunked_attention``, the running max, denominator
and accumulator in float32.  The reference's ``UNROLL_INNER_SCANS`` has
no counterpart: the port's loops run eagerly, so its counters see every
iteration.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.parallel import block_index, spec_axes

INIT_STD = 0.02
CHUNK = 512          # keys a step of the online softmax
Q_BLOCK = 2048       # queries a block of ``chunked_attention``

# bf16 score and probability products in ``chunked_attention``; set by
# the dry-run's cell builder, as the reference's launcher sets its own
FAST_ATTN = False


class Params(nn.Module):
    """Named float32 tensors, one parameter each, named after
    ``repro``'s keys (no grad until a train state turns it on)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def dense_init(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Normal with std 0.02, float32, on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * INIT_STD


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, the type of the reference's sums, softmaxes and norms;
    float64 for a float64 run of the model (the yardstick its float32
    gradients are held to)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def up(x: torch.Tensor) -> torch.Tensor:
    """``x`` in ``acc_dtype`` of its type."""
    return x.to(acc_dtype(x.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Scale by ``(1 + scale)`` in float32, cast back to x's type."""
    xf = up(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + up(scale))).to(x.dtype)


def causal_dconv(u, w):
    """u: (B, L, C), w: (K, C) depthwise causal conv, as K multiply-adds
    in u's type (no cuDNN convolution, so no TF32)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + u.shape[1]] * w[i]
    return out


def rope(x, positions, theta):
    """x: (..., S, H, hd), positions: (..., S).  Float32 angles; the
    rotated halves are cast back to x's type, an odd tail passes."""
    hd = x.shape[-1]
    half = hd // 2
    acc = acc_dtype(x.dtype)
    freq = theta ** (-torch.arange(0, half, dtype=acc, device=x.device)
                     / half)
    ang = positions[..., :, None, None].to(acc) * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x[..., 2 * half:]],
                     dim=-1)


def _softcap(x, cap):
    return cap * torch.tanh(x / cap)


def _chunk_range(q0, q1, sk, *, causal, window, chunk, q_offset):
    """The chunks holding a key that some query in ``[q0, q1)`` may
    attend; every other chunk is masked for all of them."""
    lo, hi = 0, sk - 1
    if causal:
        hi = min(hi, q_offset + q1 - 1)
    if window is not None:
        lo = max(lo, q_offset + q0 - window + 1)
    if hi < lo:
        return range(0)
    return range(lo // chunk, hi // chunk + 1)


def chunked_attention(q, k, v, *, causal=True, window=None, softcap=None,
                      chunk=CHUNK, q_offset=0):
    """Online-softmax attention.

    q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd) with H % KV == 0 (GQA: the
    queries are viewed as (B, Sq, KV, rep, hd)).  ``window``: sliding
    window (None: full).  ``q_offset``: absolute position of q[0]
    relative to k[0].  Returns (B, Sq, H, hd) in q's type.  The
    queries go in blocks of ``Q_BLOCK``.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    if FAST_ATTN:
        score_dt = torch.bfloat16
        qf = (q.to(score_dt) * rounded(scale, score_dt)).reshape(
            b, sq, kv, rep, hd)
    else:
        qf = (up(q) * scale).reshape(b, sq, kv, rep, hd)
        score_dt = qf.dtype
    acc_t = dict(dtype=acc_dtype(q.dtype), device=q.device)
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).to(score_dt)
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)).to(score_dt)
    out = torch.empty((b, sq, kv, rep, hd), **acc_t)
    arange = torch.arange(chunk, device=q.device)
    for q0 in range(0, sq, Q_BLOCK):
        q1 = min(sq, q0 + Q_BLOCK)
        qb = qf[:, q0:q1]
        q_pos = q_offset + torch.arange(q0, q1, device=q.device)
        m = torch.full((b, q1 - q0, kv, rep), -torch.inf, **acc_t)
        l_ = torch.zeros((b, q1 - q0, kv, rep), **acc_t)
        acc = torch.zeros((b, q1 - q0, kv, rep, hd), **acc_t)
        for c in _chunk_range(q0, q1, sk, causal=causal, window=window,
                              chunk=chunk, q_offset=q_offset):
            k_blk = kp[:, c * chunk:(c + 1) * chunk]
            v_blk = vp[:, c * chunk:(c + 1) * chunk]
            s = up(torch.einsum("bqgrh,bcgh->bqgrc", qb, k_blk))
            if softcap is not None:
                s = _softcap(s, softcap)
            k_pos = c * chunk + arange
            valid = (k_pos < sk)[None, :]
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(valid[None, :, None, None, :], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row that has met no valid key yet keeps m = -inf; 0 stands
            # in for it in both exps, so p and corr are 0, not NaN
            m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_use[..., None])
            corr = torch.exp(m - m_use)
            l_ = l_ * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + up(torch.einsum(
                "bqgrc,bcgh->bqgrh", p.to(score_dt), v_blk))
            m = m_new
        out[:, q0:q1] = acc / torch.clamp(l_[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, *, softcap=None):
    """One query against a (possibly ring-buffered) cache.

    q: (B, 1, H, hd); k/v_cache: (B, W, KV, hd); slots below
    ``min(length, W)`` are valid.  The query is scaled and rounded to
    the cache's type, the products accumulate in float32 (the cache is
    read as float32), the softmax is float32, and its weights are
    rounded to the cache's type before they meet the values, as the
    reference's ``preferred_element_type`` products do.
    """
    b, w, kv, hd = k_cache.shape
    h = q.shape[2]
    rep = h // kv
    qf = (q.to(k_cache.dtype) * rounded(hd ** -0.5, k_cache.dtype)
          ).reshape(b, kv, rep, hd)
    s = torch.einsum("bgrh,bwgh->bgrw", qf.float(), k_cache.float())
    if softcap is not None:
        s = _softcap(s, softcap)
    valid = torch.arange(w, device=q.device) < min(length, w)
    s = torch.where(valid, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrw,bwgh->bgrh", p.to(k_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def sharded_decode_attention(q, cache: dict, length, mesh, spec: dict, *,
                             new_kv=None, softcap=None):
    """``decode_attention`` over a cache split across ``mesh``: ``cache``
    holds this rank's block of K and V, (B, W/nw, KV/nk, hd/nh), as
    ``spec["k"]`` says (batch rows, then slots, kv heads or head
    dimensions over mesh axes; ``launch.cells.cache_specs``); q (B, 1,
    H, hd) holds every head on every rank.

    ``new_kv``: this token's K and V, (B, KV, hd) each, written at slot
    ``(length - 1) % W`` by the ranks whose block holds it.  Where the
    head dimension is split, each rank's partial dot products are
    summed over its axes.  Where the slots are split (the reference's
    distributed flash-decode), each rank forms its partial (max, sum,
    out) over its slots: one all-reduce of the max and one of the sums
    and outputs combine them, and a rank whose slots are all past
    ``length`` adds exactly 0 (the ``-inf`` stand-in of
    ``chunked_attention``).  The probabilities meet the values before
    they are normalised, so in bf16 their rounding is not the one-device
    form's; in float32 the two agree to rounding.  Every rank makes the
    same collectives, whatever ``length``.  -> (B, 1, H, hd) in q's
    type.
    """
    k_c, v_c = cache["k"], cache["v"]
    b, wl, kvl, hdl = k_c.shape
    h, hd = q.shape[2], q.shape[3]
    _, w_ax, kv_ax, hd_ax = (spec_axes(e) for e in spec["k"])
    wi, nw = block_index(mesh, w_ax)
    ki, nk = block_index(mesh, kv_ax)
    hi, nh = block_index(mesh, hd_ax)
    kv, w = kvl * nk, wl * nw
    kvs, hds = slice(ki * kvl, (ki + 1) * kvl), slice(hi * hdl, (hi + 1) * hdl)
    if new_kv is not None:
        slot = (length - 1) % w - wi * wl
        if 0 <= slot < wl:          # this rank holds the slot
            k_c[:, slot] = new_kv[0][:, kvs, hds].to(k_c.dtype)
            v_c[:, slot] = new_kv[1][:, kvs, hds].to(v_c.dtype)
    rep = h // kv
    qf = (q.to(k_c.dtype) * rounded(hd ** -0.5, k_c.dtype)
          ).reshape(b, kv, rep, hd)[:, kvs, :, hds]
    s = torch.einsum("bgrh,bwgh->bgrw", qf.float(), k_c.float())
    for a in hd_ax:
        s = mesh.all_reduce(s, axis=a)
    if softcap is not None:
        s = _softcap(s, softcap)
    pos = wi * wl + torch.arange(wl, device=q.device)
    s = torch.where(pos < min(length, w), s, -torch.inf)
    m = s.amax(dim=-1)
    for a in w_ax:
        m = mesh.all_reduce(m, "max", axis=a)
    m = torch.where(torch.isneginf(m), 0.0, m)
    e = torch.exp(s - m[..., None])
    acc = torch.einsum("bgrw,bwgh->bgrh", e.to(k_c.dtype).float(),
                       v_c.float())
    both = torch.cat([e.sum(dim=-1)[..., None], acc], dim=-1)
    for a in w_ax:
        both = mesh.all_reduce(both, axis=a)
    out = both[..., 1:] / both[..., :1]
    for a in reversed(hd_ax):
        out = mesh.all_gather(out, axis=a, dim=-1)
    for a in reversed(kv_ax):
        out = mesh.all_gather(out, axis=a, dim=1)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times
    it equals the tensor times ``jnp.asarray(value, dtype)`` (one
    rounding of an exact product), with no host-to-device copy, which
    would synchronise the stream."""
    return float(torch.tensor(value, dtype=dtype))


def act_fn(name):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def gated_mlp(x, w1, w3, w2, act="silu"):
    h = act_fn(act)(x @ w1) * (x @ w3)
    return h @ w2
