"""Tile-local spatial join (the paper's query phase D), torch twin of
``repro.query.join``.

Filter step = MBR intersection through the ``mbr_join`` kernels; the
objects *are* MBRs, so the refine step degenerates to the filter
predicate.  Reference-point deduplication: a duplicate (r, s) hit
appears in every tile both replicas share, and exactly one tile of a
non-overlapping layout contains the reference point ``(max(r.xmin,
s.xmin), max(r.ymin, s.ymin))``, so counting only rp-owned hits gives
the exact global count with no dedup pass.  Ownership is half-open on
the high edge (closed at the universe boundary).

Hit tables larger than ``TABLE_BYTES`` are built in blocks of R rows,
and ``rp_own_mask`` and the ``&`` run on the same block, so no tile's
table is ever whole in memory.  Blocks keep row-major order, so pair
lists come out in the reference's ``nonzero`` order.

These per-tile functions keep the reference's API.  The engine joins a
plan's tiles all at once instead (``mbr_join.ops.tile_rp_counts`` and
``tile_pair_list``), with the same answers.
"""
from __future__ import annotations

import torch

from ..kernels.mbr_join import ops as mops
from ..kernels.mbr_join.ref import rp_own_mask

TABLE_BYTES = 1 << 29        # one (rows, M) bool hit-table block


def _row_blocks(n: int, m: int):
    rows = max(1, TABLE_BYTES // max(m, 1))
    for i0 in range(0, n, rows):
        yield slice(i0, min(n, i0 + rows))


def _hits(r, s, tile_box, uni, rp: bool):
    """Per row block: ``(rows, hit table)``, rp-owned hits only if
    ``rp``."""
    for rows in _row_blocks(r.shape[0], s.shape[0]):
        hits = mops.join_mask(r[rows], s)
        if rp:
            hits &= rp_own_mask(r[rows], s, tile_box, uni)
        yield rows, hits


def tile_join_count(r: torch.Tensor, s: torch.Tensor,
                    tile_box: torch.Tensor, uni: torch.Tensor,
                    dedup: str = "rp") -> torch.Tensor:
    """Intersecting pairs in one tile -> 0-d int64.

    dedup="rp"   -- reference-point-owned count (globally exact for
                    non-overlapping layouts),
    dedup="none" -- raw MASJ count (duplicates included), through the
                    ``count`` kernel.
    """
    if dedup == "none":
        return mops.join_count(r, s)
    total = torch.zeros((), dtype=torch.int64, device=r.device)
    for _, hits in _hits(r, s, tile_box, uni, rp=True):
        total += hits.sum()
    return total


def tile_pairs(r: torch.Tensor, s: torch.Tensor, r_ids: torch.Tensor,
               s_ids: torch.Tensor, tile_box: torch.Tensor,
               uni: torch.Tensor, max_pairs: int, dedup: str = "none"
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tile's intersecting (r_id, s_id) pairs in row-major order,
    the first ``max_pairs`` of them -> ``(pr, ps, n)``, unpadded; ``n``
    counts every hit, those past ``max_pairs`` included.  Slots with
    id -1 never pair."""
    prs, pss = [], []
    n = torch.zeros((), dtype=torch.int64, device=r.device)
    room = max_pairs
    for rows, hits in _hits(r, s, tile_box, uni, rp=dedup == "rp"):
        hits &= (r_ids[rows, None] >= 0) & (s_ids[None, :] >= 0)
        if room <= 0:
            n += hits.sum()
            continue
        ri, si = hits.nonzero(as_tuple=True)
        n += ri.shape[0]
        ri, si = ri[:room], si[:room]
        room -= ri.shape[0]
        prs.append(r_ids[rows][ri])
        pss.append(s_ids[si])
    empty = torch.zeros(0, dtype=r_ids.dtype, device=r.device)
    return (torch.cat(prs) if prs else empty,
            torch.cat(pss) if pss else empty, n)


def tile_join_pairs(r: torch.Tensor, s: torch.Tensor, r_ids: torch.Tensor,
                    s_ids: torch.Tensor, tile_box: torch.Tensor,
                    uni: torch.Tensor, max_pairs: int, dedup: str = "none"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``tile_pairs`` padded to ``max_pairs`` with (-1, -1), as the
    reference's ``nonzero(size=max_pairs, fill_value=-1)`` gives them."""
    pr, ps, n = tile_pairs(r, s, r_ids, s_ids, tile_box, uni, max_pairs,
                           dedup)
    out = torch.full((2, max_pairs), -1, dtype=r_ids.dtype, device=r.device)
    out[0, :pr.shape[0]] = pr
    out[1, :ps.shape[0]] = ps
    return out[0], out[1], n
