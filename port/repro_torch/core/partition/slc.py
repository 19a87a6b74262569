"""Strip partitioning (SLC) -- Algorithm 4.

Data-oriented, non-overlapping.  Objects are sorted by centroid along
one dimension and sliced into strips of ``b`` objects; each strip spans
the full universe in the other dimension.  The cut between two strips
is the float32 midpoint ``(left + right) * 0.5``
(``repro.core.partition.slc``).
"""
from __future__ import annotations

import math

import torch

from .. import geometry
from .api import Partitioning, register


def strip_cuts(coord_sorted: torch.Tensor, payload: int, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """(k+1,) strip edges, ``edges[0] = lo`` and ``edges[k] = hi``."""
    n = coord_sorted.shape[0]
    k = max(1, math.ceil(n / payload))
    idx = torch.arange(1, k, device=coord_sorted.device) * payload
    right = coord_sorted[idx.clamp(0, n - 1)]
    left = coord_sorted[(idx - 1).clamp(0, n - 1)]
    cuts = (left + right) * 0.5
    return torch.cat([lo.reshape(1), cuts, hi.reshape(1)])


@register("slc", overlapping=False, search="bottom-up", criterion="data",
          covers_universe=True)
def slc_partition(mbrs: torch.Tensor, payload: int, dim: int = 0
                  ) -> Partitioning:
    n = mbrs.shape[0]
    k = max(1, math.ceil(n / payload))
    bounds = geometry.universe(mbrs)
    c_sorted = torch.sort(geometry.centroids(mbrs)[:, dim]).values
    edges = strip_cuts(c_sorted, payload, bounds[dim], bounds[dim + 2])
    other = 1 - dim
    lo = bounds[other].expand(k)
    hi = bounds[other + 2].expand(k)
    cols = ([edges[:-1], lo, edges[1:], hi] if dim == 0
            else [lo, edges[:-1], hi, edges[1:]])
    return Partitioning(
        boxes=torch.stack(cols, dim=-1).to(torch.float32),
        valid=torch.ones(k, dtype=torch.bool, device=mbrs.device))
