"""Gradient compression for cross-pod reduction, int8 with error
feedback (twin of ``repro.dist.compress``).

``compressed_psum`` quantises each leaf to symmetric int8 before the
collective and carries the quantisation residual forward (error
feedback), so long-run drift stays bounded.  As in the reference, the
collective itself sums the dequantised float32 values.

``quantize`` follows the reference's eager form bit for bit: the scale
is ``max|x|`` divided by 127 as a true float32 division.  Under
``jax.jit`` XLA turns that division by a constant into a product with
its reciprocal, which can differ in the last bit; and CUDA divides a
tensor by a Python scalar the same way, so the divisor here is a
tensor on ``x``'s device.
"""
from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation -> ``(q, scale)`` with
    ``|dequantize(q, scale) - x| <= scale / 2`` elementwise; ``scale``
    is a 0-d float32 tensor, at least float32's ``tiny`` (an all-zero
    ``x`` quantises to zeros).  Rounding is half to even."""
    scale = torch.amax(torch.abs(x)) / torch.full((), 127.0, dtype=x.dtype,
                                                  device=x.device)
    scale = torch.clamp(scale, min=_TINY)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(tree: dict, mesh, err_tree: dict) -> tuple[dict, dict]:
    """Quantised mean over ``mesh``'s ranks with error feedback.

    ``tree`` and ``err_tree``: name -> float32 tensor, on every rank.
    Each leaf is compensated by its carried residual, quantised to int8
    and dequantised; the ranks' values are summed (``all_reduce``) and
    divided by the rank count, the reference's ``lax.pmean`` over its
    axis; the local quantisation error becomes the new residual.
    ``mesh`` is a ``launch.mesh.ProcessMesh``, or None for one rank (the
    mean of one value) -> ``(reduced_tree, new_err_tree)``."""
    red, new_err = {}, {}
    for k, x in tree.items():
        y = x + err_tree[k]
        deq = dequantize(*quantize(y))
        if mesh is not None:
            deq_sum = mesh.all_reduce(deq, "sum")
            red[k] = deq_sum / torch.full((), float(mesh.size),
                                          device=deq.device)
        else:
            red[k] = deq
        new_err[k] = y - deq
    return red, new_err
