"""Plain PyTorch versions of the SSD block (twin of
``repro.kernels.ssd.ref``), and of the kernel's own grouped signature.

``intra_chunk_ref`` keeps the reference's flat ``(I, Q, .)`` contract;
``intra_chunk_grouped`` is the same function in the natural layout the
CUDA kernel takes, the reference's einsum form of the intra-chunk block
(``repro/kernels/ssd/ops.py``, the ``use_kernel=False`` branch);
``ssd_scan_ref`` is the sequential state-space recurrence the chunked
algorithm must reproduce end to end:

    h_t = exp(dt_t A) . h_{t-1} + dt_t . B_t (x) x_t
    y_t = C_t . h_t
"""
from __future__ import annotations

import torch


def _masked(g, cl, dt):
    """``where(i >= j, g * exp(cl_i - cl_j), 0) * dt_j`` over the last
    two axes of ``g``; ``cl``/``dt`` carry the chunk on their last.

    The exponent is masked to -inf above the diagonal before ``exp``:
    there ``cl_i - cl_j`` is positive and overflows float32 once a
    chunk's decay passes 88.7 (128 steps of dt 0.7 at A = -1), and the
    gradient of the masked ``g * inf`` is 0 * inf = NaN (the reference's
    ``intra_chunk_ref`` has that hazard; ROADMAP Queue 3).  On and below
    the diagonal the values are the same."""
    q = g.shape[-1]
    mask = torch.ones(q, q, dtype=torch.bool, device=g.device).tril()
    decay = torch.exp(torch.where(mask, cl[..., :, None] - cl[..., None, :],
                                  -torch.inf))
    return torch.where(mask, g * decay, 0.0) * dt[..., None, :]


def intra_chunk_ref(x, dt, cl, b, c):
    """x: (I, Q, P), dt/cl: (I, Q), b/c: (I, Q, S) -> (I, Q, P)."""
    g = torch.einsum("iqs,iks->iqk", c, b)
    return torch.einsum("iqk,ikp->iqp", _masked(g, cl, dt), x)


def intra_chunk_grouped(x, dt, cl, b, c, chunk):
    """The kernel's signature: x (B, L, H, P), dt/cl (B, L, H), b/c
    (B, L, G, S) with H % G == 0 and L % chunk == 0 -> (B, L, H, P)
    float32.  Head h reads group h // (H / G); ``cl`` is the inclusive
    within-chunk cumsum of dt * A."""
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    nc = l // chunk
    gm = torch.einsum("bnqgs,bnkgs->bngqk",
                      c.reshape(bs, nc, chunk, g, s),
                      b.reshape(bs, nc, chunk, g, s))
    gm = gm.repeat_interleave(h // g, dim=2)             # (B, nc, H, Q, Q)
    clh = cl.reshape(bs, nc, chunk, h).transpose(2, 3)   # (B, nc, H, Q)
    dth = dt.reshape(bs, nc, chunk, h).transpose(2, 3)
    y = torch.einsum("bnhqk,bnkhp->bnqhp", _masked(gm, clh, dth),
                     x.reshape(bs, nc, chunk, h, p))
    return y.reshape(bs, l, h, p)


def ssd_scan_ref(x, dt, a_log, b, c, h0=None):
    """Sequential oracle.  x: (L, P), dt: (L,), a_log: scalar (= A < 0),
    b/c: (L, S) -> y: (L, P), h_final: (S, P)."""
    s, p = b.shape[-1], x.shape[-1]
    h = (torch.zeros(s, p, dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(dt[t] * a_log) * h + dt[t] * torch.outer(b[t], x[t])
        ys.append(c[t] @ h)
    return torch.stack(ys), h
