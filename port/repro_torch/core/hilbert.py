"""Hilbert space-filling-curve encoding (torch twin of
``repro.core.hilbert``).

Maps 2-D grid coordinates to positions along a Hilbert curve of a
given order: the classic iterative xy->d transform, one bit plane per
step.  Used by the hc partitioner and the ``"hilbert"`` local index,
and the plain version of the ``encode`` kernel
(``kernels/hilbert``).

The reference computes in ``uint32`` and relies on its wraparound in
``s - 1 - x``; torch has no ``uint32`` arithmetic worth using, so this
twin computes in int64 and keeps the low 32 bits.  Keys are int64
holding the uint32 value, so a torch sort orders them as unsigned.
"""
from __future__ import annotations

import torch

DEFAULT_ORDER = 16  # 2^16 x 2^16 grid -> 32-bit curve index
_LOW32 = 0xFFFFFFFF


def xy2d(x: torch.Tensor, y: torch.Tensor, order: int = DEFAULT_ORDER
         ) -> torch.Tensor:
    """Grid coords in ``[0, 2**order)`` -> (N,) int64 curve index, the
    value of the reference's uint32 result."""
    x = x.long() & _LOW32
    y = y.long() & _LOW32
    d = torch.zeros_like(x)
    for i in range(order):
        s = (1 << (order - 1 - i)) & _LOW32
        rx = ((x & s) > 0).long()
        ry = ((y & s) > 0).long()
        d = (d + ((s * s) & _LOW32) * ((3 * rx) ^ ry)) & _LOW32
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = torch.where(flip, (s - 1 - x) & _LOW32, x)
        y_f = torch.where(flip, (s - 1 - y) & _LOW32, y)
        x, y = torch.where(swap, y_f, x_f), torch.where(swap, x_f, y_f)
    return d


def quantize(pts: torch.Tensor, bounds: torch.Tensor,
             order: int = DEFAULT_ORDER) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) float points + (4,) universe box -> int32 grid coords.

    float32 ``(pts - lo) / span`` (a tensor division, as the
    reference), times ``2**order`` (exact), truncated; the conversion
    saturates as XLA's float -> uint32 does (negative and NaN -> 0),
    then clamps to ``[0, 2**order - 1]``."""
    if not 1 <= order <= 31:
        raise ValueError(f"order must be in [1, 31], got {order}")
    n = 1 << order
    span = torch.clamp_min(bounds[2:] - bounds[:2], 1e-30)
    f = (pts - bounds[:2]) / span
    g = f * float(n)
    g = torch.where(g > 0, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device))
    g = torch.clamp_max(g, float(n)).long().clamp_max(n - 1).to(torch.int32)
    return g[:, 0], g[:, 1]


def hilbert_keys(pts: torch.Tensor, bounds: torch.Tensor,
                 order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Float points -> (N,) int64 Hilbert keys (the hc sort key)."""
    gx, gy = quantize(pts, bounds, order)
    return xy2d(gx, gy, order)
