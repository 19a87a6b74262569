"""Boundary-Optimized Strip partitioning (BOS) -- Algorithm 5.

Data-oriented, non-overlapping.  Like SLC it slices strips of ``b``
objects off the remaining universe, but at every step it evaluates the
induced cut in *both* dimensions and takes the one crossing fewer
object MBRs (``getCost``; ties go to x), directly minimising boundary
objects.

The reference's ``lax.scan`` over the static strip count ``kmax``
becomes a Python loop of ``kmax`` steps, each O(N) tensor work against
the two per-dimension sort orders.  No step reads a value back to the
host: ``has``, ``last`` and the remaining box stay tensors, and steps
after the data runs out repeat the remaining box with ``valid`` False,
as the scan does.
"""
from __future__ import annotations

import math

import torch

from .. import geometry
from .api import Partitioning, register


def _cut_and_cost(alive, order, coord_sorted, lo_ext, hi_ext, take):
    """b-th remaining order statistic as a cut, its boundary-cross cost,
    and the objects the strip would remove."""
    alive_s = alive[order]
    csum = torch.cumsum(alive_s, 0)
    nn = coord_sorted.shape[0]
    pos = torch.searchsorted(csum, torch.stack([take, take + 1]),
                             side="left").clamp(0, nn - 1)
    v = coord_sorted[pos]
    cut = (v[0] + v[1]) * 0.5
    cost = (alive & (lo_ext < cut) & (cut < hi_ext)).sum()
    removed = torch.zeros_like(alive)
    removed[order] = alive_s & (csum <= take)
    return cut, cost, removed


@register("bos", overlapping=False, search="bottom-up", criterion="data",
          covers_universe=True)
def bos_partition(mbrs: torch.Tensor, payload: int) -> Partitioning:
    n = mbrs.shape[0]
    kmax = max(1, math.ceil(n / payload))
    rem = geometry.universe(mbrs)
    cx, cy = geometry.centroids(mbrs).unbind(dim=1)
    ox = torch.sort(cx, stable=True).indices
    oy = torch.sort(cy, stable=True).indices
    cx_s, cy_s = cx[ox], cy[oy]

    alive = torch.ones(n, dtype=torch.bool, device=mbrs.device)
    boxes, valid = [], []
    for _ in range(kmax):
        n_alive = alive.sum()
        has = n_alive > 0
        take = torch.clamp_max(n_alive, payload)
        last = n_alive <= payload

        cut_x, cost_x, rm_x = _cut_and_cost(alive, ox, cx_s, mbrs[:, 0],
                                            mbrs[:, 2], take)
        cut_y, cost_y, rm_y = _cut_and_cost(alive, oy, cy_s, mbrs[:, 1],
                                            mbrs[:, 3], take)
        cut_x = torch.where(last, rem[2], cut_x)
        cut_y = torch.where(last, rem[3], cut_y)
        use_x = cost_x <= cost_y

        box_x = torch.stack([rem[0], rem[1], cut_x, rem[3]])
        box_y = torch.stack([rem[0], rem[1], rem[2], cut_y])
        rem_x = torch.stack([cut_x, rem[1], rem[2], rem[3]])
        rem_y = torch.stack([rem[0], cut_y, rem[2], rem[3]])
        boxes.append(torch.where(has, torch.where(use_x, box_x, box_y), rem))
        valid.append(has)
        removed = torch.where(use_x, rm_x, rm_y)
        alive = alive & ~(removed & has)
        rem = torch.where(has, torch.where(use_x, rem_x, rem_y), rem)
    return Partitioning(boxes=torch.stack(boxes).to(torch.float32),
                        valid=torch.stack(valid))
