"""Fixed Grid partitioning (FG) -- Algorithm 2.

Space-oriented, non-overlapping: the universe is split into an m x m
grid with ``m = ceil(sqrt(N / b))``.  The grid is computed in O(1);
objects are assigned later by MASJ box intersection.

The edges are ``jnp.linspace``'s, bit for bit, which ``torch.linspace``
is not.  The reference's ``_linspace`` is jitted, and XLA on the CPU
rewrites it before LLVM contracts it (ROADMAP Queue 3): with
``c = 1/m`` and ``sc = stop * c`` rounded once each, edge ``i < m`` is
``fma(i, sc, start * (1 - i*c))`` and the last edge is ``stop``.  Two
code-generation details change the rounding of a few edges, and
``linspace_edges`` follows both: for ``m <= 33`` the loop is unrolled
and edge 1 becomes ``fma(start, 1 - c, sc)``; for ``m >= 352`` the
vectorised body (32 edges per iteration) also contracts ``1 - i*c``
into ``fma(-i, c, 1)``, while the tail past the last full 32 does not.
"""
from __future__ import annotations

import math

import torch

from .. import geometry
from ..fma import fma32
from .api import Partitioning, register

_UNROLLED_MAX = 33     # XLA:CPU unrolls the edge loop up to here
_VECTOR_MIN = 352      # ... and vectorises it from here, 32 at a time
_VECTOR_WIDTH = 32


def linspace_edges(start: torch.Tensor, stop: torch.Tensor, m: int
                   ) -> torch.Tensor:
    """``jnp.linspace(start, stop, m + 1)`` of two float32 scalars, as
    the reference's jitted CPU code rounds it -> (m + 1,) float32."""
    dev, f32 = start.device, torch.float32
    c = (torch.ones((), dtype=f32, device=dev)
         / torch.tensor(m, dtype=f32, device=dev))
    sc = stop * c
    it = torch.arange(m, dtype=f32, device=dev)
    sub = 1.0 - it * c
    if m >= _VECTOR_MIN:
        body = _VECTOR_WIDTH * (m // _VECTOR_WIDTH)
        sub[:body] = fma32(-it[:body], c, torch.ones((), dtype=f32,
                                                     device=dev))
    out = fma32(it, sc, start * sub)
    if 2 <= m <= _UNROLLED_MAX:
        out[1] = fma32(start, sub[1], sc)
    return torch.cat([out, stop.reshape(1)])


def grid_boxes(bounds: torch.Tensor, mx: int, my: int) -> torch.Tensor:
    """Tile ``bounds`` into an (mx*my, 4) grid of boxes (row-major in y)."""
    xs = linspace_edges(bounds[0], bounds[2], mx)
    ys = linspace_edges(bounds[1], bounds[3], my)
    bx0 = xs[:-1].repeat_interleave(my)
    bx1 = xs[1:].repeat_interleave(my)
    by0 = ys[:-1].repeat(mx)
    by1 = ys[1:].repeat(mx)
    return torch.stack([bx0, by0, bx1, by1], dim=-1).to(torch.float32)


@register("fg", overlapping=False, search="na", criterion="space",
          covers_universe=True)
def fg_partition(mbrs: torch.Tensor, payload: int) -> Partitioning:
    n = mbrs.shape[0]
    m = max(1, math.ceil(math.sqrt(n / payload)))
    boxes = grid_boxes(geometry.universe(mbrs), m, m)
    return Partitioning(boxes=boxes, valid=torch.ones(
        m * m, dtype=torch.bool, device=mbrs.device))
