"""MASJ assignment: replicate every object to every partition it touches.

The reference builds its ``(kmax, capacity)`` member table from a
dense ``(N, kmax)`` running-rank matrix (``repro.core.partition.assign``),
which at 8 M objects x 2048 partitions would be 64 GB of int32.  Here
the same table comes from the membership *pairs* in O(nnz) memory:
pairs listed object-major, stably sorted by partition, keep ascending
object order inside each partition, so a pair's rank is its position
within its partition -- the reference's running rank, bit for bit.
"""
from __future__ import annotations

import torch

from .. import geometry
from .api import Partitioning

_HIT_BLOCK_ELEMS = 1 << 27   # (objects x partitions) per membership block


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (capacity lane alignment)."""
    return int(-(-x // m) * m)


def _hit_blocks(mbrs: torch.Tensor, parts: Partitioning):
    """Yield ``(i0, hit)``: the (block, kmax) intersect table of objects
    ``i0 ...`` against every valid partition region."""
    block = max(1, _HIT_BLOCK_ELEMS // max(parts.kmax, 1))
    for i0 in range(0, mbrs.shape[0], block):
        m = mbrs[i0:i0 + block]
        yield i0, (geometry.intersect_matrix(m, parts.boxes)
                   & parts.valid[None, :])


def partition_counts(mbrs: torch.Tensor, parts: Partitioning
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-partition payload counts and per-object copy counts ->
    ``(counts[kmax] int32, copies[N] int32)``; ``counts`` includes MASJ
    replication, so ``sum(counts)/N - 1`` is the paper's lambda."""
    counts = torch.zeros(parts.kmax, dtype=torch.int64, device=mbrs.device)
    copies = []
    for _, hit in _hit_blocks(mbrs, parts):
        counts += hit.sum(0)
        copies.append(hit.sum(1, dtype=torch.int32))
    copies = (torch.cat(copies) if copies else
              torch.zeros(0, dtype=torch.int32, device=mbrs.device))
    return counts.to(torch.int32), copies


def membership(parts: Partitioning, mbrs: torch.Tensor, adopt: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """MASJ membership as (object, partition) pairs in object-major
    order -> ``(obj[nnz], part[nnz])`` int64, the nonzeros of the
    reference's ``(N, kmax)`` table, built blockwise.

    Box intersection against every valid partition region; with
    ``adopt`` (the serving staging's rule) an object that intersects
    none is adopted by the nearest valid region (squared box-to-box
    distance, ties to the lowest index).  The join stages without it,
    as the reference's ``assign_padded`` does.
    """
    b, valid, kmax = parts.boxes, parts.valid, parts.kmax
    objs, tiles = [], []
    for i0, hit in _hit_blocks(mbrs, parts):
        if adopt:
            none = ~hit.any(dim=1)
            if bool(none.any()):         # covering layouts skip it
                m = mbrs[i0:i0 + hit.shape[0]]
                dx = torch.maximum(b[None, :, 0] - m[:, None, 2],
                                   m[:, None, 0] - b[None, :, 2]).clamp_min(0)
                dy = torch.maximum(b[None, :, 1] - m[:, None, 3],
                                   m[:, None, 1] - b[None, :, 3]).clamp_min(0)
                d2 = torch.where(valid[None, :], dx * dx + dy * dy,
                                 torch.inf)
                nearest = d2.argmin(dim=1)
                hit |= none[:, None] & (
                    torch.arange(kmax, device=m.device)[None]
                    == nearest[:, None])
        o, p = hit.nonzero(as_tuple=True)
        objs.append(o + i0)
        tiles.append(p)
    if not objs:
        empty = torch.zeros(0, dtype=torch.int64, device=mbrs.device)
        return empty, empty
    return torch.cat(objs), torch.cat(tiles)


def assign_from_pairs(obj: torch.Tensor, part: torch.Tensor, kmax: int,
                      capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded per-partition member lists from membership pairs.

    obj, part: (nnz,) int64, object ``obj[i]`` is a member of partition
    ``part[i]``, listed in ascending object order (as ``nonzero`` of an
    ``(N, kmax)`` table gives them).  Returns ``(members[kmax, capacity]
    int32, mask[kmax, capacity] bool, overflow[kmax] int32)``: members
    past ``capacity`` are dropped and counted in ``overflow``; padding
    slots hold member 0 and mask False, as in the reference.
    """
    dev = obj.device
    by_part = torch.sort(part, stable=True)
    p, o = by_part.values, obj[by_part.indices]
    counts = torch.bincount(part, minlength=kmax)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(p.shape[0], device=dev) - starts[p]
    ok = rank < capacity
    members = torch.zeros(kmax, capacity, dtype=torch.int32, device=dev)
    mask = torch.zeros(kmax, capacity, dtype=torch.bool, device=dev)
    members[p[ok], rank[ok]] = o[ok].to(torch.int32)
    mask[p[ok], rank[ok]] = True
    overflow = (counts - capacity).clamp_min(0).to(torch.int32)
    return members, mask, overflow


def assign_from_hit(hit: torch.Tensor, capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``assign_from_pairs`` of a dense (N, kmax) bool membership table
    (the reference's signature; fine at test sizes)."""
    obj, part = hit.nonzero(as_tuple=True)
    return assign_from_pairs(obj, part, hit.shape[1], capacity)
