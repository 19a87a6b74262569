"""Chunked SSD forward (twin of ``repro.kernels.ssd.ops.ssd_forward``):
the intra-chunk block on the CUDA kernel, the inter-chunk carry in plain
PyTorch around it.

The full SSD output decomposes per chunk c as

    Y_c = intra(X_c)  +  C_c . exp(cl) . H_{c-1}

with the chunk-final states H_c computed by an O(L/Q) pass:

    H_c = exp(cl_last) . H_{c-1} + (dt . exp(cl_last - cl) B)^T X_c

B and C stay grouped throughout: heads are viewed as (group, head of
the group), so the reference's per-head repeats of B and C, (B, L, H, S)
each, are never built.

Training differentiates the same function: ``IntraChunk`` is the
counterpart of the reference's ``custom_vjp`` around the Pallas kernel
(kernel forward, a backward derived from the plain formula), and the
inter-chunk pass takes a form autograd can differentiate whenever grad
is on.  Without grad it keeps its in-place form, which holds one
buffer of states fewer.
"""
from __future__ import annotations

import torch

from . import kernel, ref

CHUNK = 128


class IntraChunk(torch.autograd.Function):
    """The intra-chunk block with the CUDA kernel as its forward and the
    gradient of the plain version (``ref.intra_chunk_grouped``) as its
    backward: the backward recomputes the plain graph on the saved
    inputs and differentiates it, as the reference's ``_intra_bwd``
    takes ``jax.vjp`` of ``ref.intra_chunk_ref``.  ``fwd`` replaces the
    kernel in tests that run on the CPU."""

    @staticmethod
    def forward(ctx, x, dt, cl, b, c, chunk, fwd=None):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, cl, b, c)
        return (fwd or kernel.intra_chunk)(x, dt, cl, b, c, chunk)

    @staticmethod
    def backward(ctx, gy):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[:5])]
        wrt = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y = ref.intra_chunk_grouped(*ins, ctx.chunk)
            got = iter(torch.autograd.grad(y, wrt, gy))
        return (*(next(got) if t.requires_grad else None for t in ins),
                None, None)


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int = CHUNK
                ) -> torch.Tensor:
    """Multi-head chunked SSD.

    x: (B, L, H, P), dt: (B, L, H), a_log: (H,) (negative), b, c:
    (B, L, G, S) with H % G == 0, all float32.  Returns (B, L, H, P)
    float32.  The intra-chunk block is the CUDA kernel for CUDA tensors
    (through ``IntraChunk``) and its plain version
    (``ref.intra_chunk_grouped``, the reference's einsum form, which
    autograd differentiates directly) for CPU ones.
    """
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError(f"sequence length {l} must be chunk-padded "
                         f"(chunk {chunk})")
    nc = l // chunk

    # per-step log decay and its inclusive within-chunk cumsum
    ld = dt * a_log[None, None, :]                          # (B, L, H)
    cl = torch.cumsum(ld.reshape(bs, nc, chunk, h), dim=2)  # (B, nc, Q, H)

    # ---- intra-chunk ----
    args = (x, dt, cl.reshape(bs, l, h), b, c, chunk)
    y = (IntraChunk.apply(*args) if x.device.type == "cuda"
         else ref.intra_chunk_grouped(*args)).reshape(bs, nc, chunk, g,
                                                      rep, p)

    # ---- inter-chunk state pass ----
    xc = x.reshape(bs, nc, chunk, g, rep, p)
    bc = b.reshape(bs, nc, chunk, g, s)
    cc = c.reshape(bs, nc, chunk, g, s)
    cl_last = cl[:, :, -1, :]                               # (B, nc, H)
    # contribution of chunk n to its final state:
    #   S_n = sum_t dt_t . exp(cl_last - cl_t) . B_t (x) X_t
    w = dt.reshape(bs, nc, chunk, h) * torch.exp(cl_last[:, :, None, :] - cl)
    wx = w.reshape(bs, nc, chunk, g, rep, 1) * xc
    s_c = torch.einsum("bnqgs,bnqgrp->bngsrp", bc, wx)
    del wx
    # h_prevs[:, n] is the state entering chunk n: a Python loop over the
    # chunks in place of the reference's lax.scan, one launch a chunk.
    # States are kept (S, head of the group, P), so both einsums are
    # plain batched products over (batch, chunk, group)
    decays = torch.exp(cl_last).reshape(bs, nc, g, 1, rep, 1)
    differentiable = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a_log, b, c))
    if differentiable:
        states = [torch.zeros_like(s_c[:, 0])]
        for n in range(nc - 1):
            states.append(torch.addcmul(s_c[:, n], states[-1],
                                        decays[:, n]))
        h_prevs = torch.stack(states, dim=1)
        del states
    else:
        h_prevs = torch.empty_like(s_c)
        h_prevs[:, 0] = 0.0
        for n in range(nc - 1):
            torch.addcmul(s_c[:, n], h_prevs[:, n], decays[:, n],
                          out=h_prevs[:, n + 1])

    # inter-chunk output: y_t += exp(cl_t) . C_t . H_{n-1}
    y_inter = torch.einsum("bnqgs,bngsrp->bnqgrp", cc, h_prevs)
    del s_c, h_prevs
    e_cl = torch.exp(cl).reshape(bs, nc, chunk, g, rep, 1)
    if differentiable:
        return (y + y_inter * e_cl).reshape(bs, l, h, p)
    y_inter *= e_cl
    return y.add_(y_inter).reshape(bs, l, h, p)
