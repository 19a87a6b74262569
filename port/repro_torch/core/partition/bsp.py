"""Binary Split Partitioning (BSP) -- Algorithm 3.

Top-down, data-oriented, non-overlapping.  A node whose payload exceeds
``b`` is split at the member-centroid median; the split dimension is
the one maximising the product of children areas.  Level-synchronous
kd construction, as ``repro.core.partition.bsp``: each level splits all
oversized nodes at once over a (node, coord)-sorted order.

Bit-identity with the reference rests on three rules kept here: both
sorts are stable (JAX's ``argsort`` is), the cut is the float32
midpoint ``(lo + hi) * 0.5``, and the area products keep the
reference's left-to-right float32 order.
"""
from __future__ import annotations

import math

import torch

from .. import geometry
from .api import Partitioning, register


def _per_node_median(coord, node, counts, starts):
    """Per-node median cut + per-object rank in node, along one dim.

    Returns ``(cut[num_nodes], pos_in_node[N])``; ``cut`` is the
    midpoint of the two middle member coords.
    """
    n = coord.shape[0]
    order_c = torch.sort(coord, stable=True).indices
    order = order_c[torch.sort(node[order_c], stable=True).indices]
    sorted_coord = coord[order]
    pos_sorted = torch.arange(n, device=coord.device) - starts[node[order]]
    pos_in_node = torch.empty_like(pos_sorted)
    pos_in_node[order] = pos_sorted
    half = counts // 2
    lo_idx = (starts + (half - 1).clamp_min(0)).clamp(0, n - 1)
    hi_idx = (starts + half).clamp(0, n - 1)
    cut = (sorted_coord[lo_idx] + sorted_coord[hi_idx]) * 0.5
    return cut, pos_in_node


@register("bsp", overlapping=False, search="top-down", criterion="data",
          covers_universe=True)
def bsp_partition(mbrs: torch.Tensor, payload: int) -> Partitioning:
    n = mbrs.shape[0]
    dev = mbrs.device
    depth = max(0, math.ceil(math.log2(max(n / payload, 1.0))))
    kmax = 1 << depth
    bounds = geometry.universe(mbrs)
    cx, cy = geometry.centroids(mbrs).unbind(dim=1)

    node = torch.zeros(n, dtype=torch.int64, device=dev)
    obox = bounds.expand(n, 4)                    # per-object node box

    for level in range(depth):
        num_nodes = 1 << level
        counts = torch.bincount(node, minlength=num_nodes)
        starts = torch.cumsum(counts, 0) - counts
        cut_x, pos_x = _per_node_median(cx, node, counts, starts)
        cut_y, pos_y = _per_node_median(cy, node, counts, starts)

        # area products for the split-dimension criterion (per node);
        # every member of a node carries the same box, so the
        # duplicate writes agree
        nbox = torch.zeros(num_nodes, 4, dtype=obox.dtype, device=dev)
        nbox[node] = obox
        w, h = nbox[:, 2] - nbox[:, 0], nbox[:, 3] - nbox[:, 1]
        px = ((cut_x - nbox[:, 0]).clamp_min(0)
              * (nbox[:, 2] - cut_x).clamp_min(0) * h * h)
        py = ((cut_y - nbox[:, 1]).clamp_min(0)
              * (nbox[:, 3] - cut_y).clamp_min(0) * w * w)
        use_x = px >= py

        split = counts > payload
        half = counts // 2
        o_split = split[node]
        o_use_x = use_x[node]
        o_left = torch.where(o_use_x, pos_x, pos_y) < half[node]
        child = 2 * node + (o_split & ~o_left).long()

        o_cut = torch.where(o_use_x, cut_x[node], cut_y[node])
        xm0, ym0, xm1, ym1 = obox.unbind(dim=1)
        nx1 = torch.where(o_split & o_use_x & o_left, o_cut, xm1)
        nx0 = torch.where(o_split & o_use_x & ~o_left, o_cut, xm0)
        ny1 = torch.where(o_split & ~o_use_x & o_left, o_cut, ym1)
        ny0 = torch.where(o_split & ~o_use_x & ~o_left, o_cut, ym0)
        obox = torch.stack([nx0, ny0, nx1, ny1], dim=-1)
        node = child

    boxes = bounds.to(torch.float32).expand(kmax, 4).clone()
    boxes[node] = obox
    valid = torch.zeros(kmax, dtype=torch.bool, device=dev)
    valid[node] = True
    return Partitioning(boxes=boxes, valid=valid)
