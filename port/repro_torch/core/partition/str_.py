"""Sort-Tile-Recursive partitioning (STR) -- Algorithm 6.

Bottom-up packing, data-oriented, *overlapping* (tight member MBRs).
``m = ceil(sqrt(N/b))`` vertical slabs by x-centroid, each slab sliced
into runs of ``b`` by y-centroid; the partition region is the tight MBR
of the run's members, as in R-tree bulk loading.  Both sorts are
stable, as JAX's ``argsort`` is (``repro.core.partition.str_``).
"""
from __future__ import annotations

import math

import torch

from .. import geometry
from .api import Partitioning, register

_BIG = 3.4e38


def tight_group_boxes(mbrs_grouped: torch.Tensor, mask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., G, 4) member boxes + (..., G) mask -> ((..., 4) tight MBR,
    (...) any member); groups without a member get the zero box."""
    m = mask[..., None]
    lo = torch.where(m, mbrs_grouped[..., :2], _BIG)
    hi = torch.where(m, mbrs_grouped[..., 2:], -_BIG)
    out = torch.cat([lo.amin(dim=-2), hi.amax(dim=-2)], dim=-1)
    any_valid = mask.any(dim=-1)
    return torch.where(any_valid[..., None], out, 0.0), any_valid


@register("str", overlapping=True, search="bottom-up", criterion="data",
          covers_universe=False)
def str_partition(mbrs: torch.Tensor, payload: int) -> Partitioning:
    n = mbrs.shape[0]
    dev = mbrs.device
    m = max(1, math.ceil(math.sqrt(n / payload)))
    slab = math.ceil(n / m)
    kper = max(1, math.ceil(slab / payload))

    c = geometry.centroids(mbrs)
    pad = m * slab - n
    cx = torch.cat([c[:, 0], torch.full((pad,), _BIG, dtype=c.dtype,
                                        device=dev)])
    order_x = torch.sort(cx, stable=True).indices
    real = (order_x < n).reshape(m, slab)
    idx = torch.where(order_x < n, order_x, 0).reshape(m, slab)
    cy = torch.where(real, c[:, 1][idx], _BIG)

    order_y = torch.sort(cy, dim=1, stable=True).indices
    idx = torch.gather(idx, 1, order_y)
    real = torch.gather(real, 1, order_y)

    pad2 = kper * payload - slab
    if pad2:
        idx = torch.nn.functional.pad(idx, (0, pad2))
        real = torch.nn.functional.pad(real, (0, pad2))
    member_boxes = mbrs[idx.reshape(m, kper, payload)]
    mask = real.reshape(m, kper, payload)
    boxes, valid = tight_group_boxes(member_boxes, mask)
    return Partitioning(boxes=boxes.reshape(-1, 4).to(torch.float32),
                        valid=valid.reshape(-1))
