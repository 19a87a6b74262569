"""Hilbert-Curve partitioning (HC).

Bottom-up packing, data-oriented, *overlapping* (tight member MBRs).
Centroids are mapped to Hilbert curve indices (order-16 grid over the
dataset universe), the dataset is stably sorted by curve value, and
every consecutive run of ``b`` objects forms a partition whose region
is the tight union of member extents -- the Hilbert R-tree bulk-load
leaf level (``repro.core.partition.hc``).

The reference injects its kernel's key function into this module; the
port calls ``kernels.hilbert.ops.hilbert_keys`` directly, which runs
the ``encode`` kernel on a CUDA tensor and its plain version on a CPU
one.
"""
from __future__ import annotations

import math

import torch

from .. import geometry, hilbert
from ...kernels.hilbert import ops as hilbert_ops
from .api import Partitioning, register
from .str_ import tight_group_boxes


@register("hc", overlapping=True, search="bottom-up", criterion="data",
          covers_universe=False)
def hc_partition(mbrs: torch.Tensor, payload: int,
                 order: int = hilbert.DEFAULT_ORDER) -> Partitioning:
    n = mbrs.shape[0]
    k = max(1, math.ceil(n / payload))
    bounds = geometry.universe(mbrs)
    keys = hilbert_ops.hilbert_keys(geometry.centroids(mbrs), bounds, order)
    perm = torch.sort(keys, stable=True).indices

    pad = k * payload - n
    idx = torch.nn.functional.pad(perm, (0, pad))
    real = torch.nn.functional.pad(
        torch.ones(n, dtype=torch.bool, device=mbrs.device), (0, pad))
    member_boxes = mbrs[idx.reshape(k, payload)]
    boxes, valid = tight_group_boxes(member_boxes, real.reshape(k, payload))
    return Partitioning(boxes=boxes.to(torch.float32), valid=valid)
