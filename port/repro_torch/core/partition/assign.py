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


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (capacity lane alignment)."""
    return int(-(-x // m) * m)


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
