"""Batched range queries over staged layouts (the canonical-copy paths
of ``repro.query.range``).

A range query is a box; its answer is the set of dataset objects whose
MBR intersects it (closed boxes).  Staging marks exactly one copy of
every object canonical, so probing only canonical copies yields exact
unique counts and id sets with no dedup work.  Two executors:

- dense (``range_counts``, ``range_ids``): every tile, O(Q·T·cap), the
  oracle;
- pruned (``pruned_range_counts``, ``pruned_range_ids``): each query's
  routed ``(Q, F)`` candidate tiles only, O(Q·F·cap).

The reference-point research paths (``range_counts_rp``,
``routed_range_counts``) count exact unique hits on the full MASJ tiles
of a non-overlapping covering layout (fg, bsp, slc, bos) with no
canonical mark: a hit counts in the tile that holds the low corner of
the query's and the object's intersection.

Both id executors keep only the hits, as ``(query, tile, slot)``
triples in the reference's flat order (``dense_hits``,
``gathered_hits``); ``query.knn`` refines from the same triples.  They
take the dense and routed hit lists, which on the card count, scan and
emit the hits with no table (the plain versions build it in
``ops.dense_blocks`` and ``ops.hit_table_blocks``).  Every executor
takes ``extent``, the ``live_extent`` of ``alive``: the card's kernels
stop each tile's walk there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..kernels.range_probe import ops as rops

_BIG_ID = 2**30


def range_query_ref(mbrs: np.ndarray, qboxes: np.ndarray) -> list[np.ndarray]:
    """Per-query sorted hit-id arrays, numpy brute force (oracle)."""
    out = []
    for q in qboxes:
        hit = ((q[0] <= mbrs[:, 2]) & (mbrs[:, 0] <= q[2])
               & (q[1] <= mbrs[:, 3]) & (mbrs[:, 1] <= q[3]))
        out.append(np.flatnonzero(hit).astype(np.int32))
    return out


def range_counts(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                 alive: torch.Tensor | None = None, *,
                 extent: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-query unique hit counts over every tile.

    qboxes: (Q, 4); canon_tiles: (T, cap, 4) canonical member boxes
    -> (Q,) int32.  ``alive``: (T, cap) tombstone mask; ``extent``: its
    ``live_extent``, where the kernel may stop.
    """
    return rops.probe_counts(qboxes, canon_tiles, alive=alive,
                             extent=extent).sum(1, dtype=torch.int32)


def dense_hits(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
               alive: torch.Tensor | None = None, *,
               extent: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (query, tile, slot) hit of the dense probe -> int64
    ``(query, tile, slot)``, in (query, tile, slot) order: the order of
    the reference's flattened ``(Q, T·cap)`` hit table.
    ``ops.dense_hit_list``: on the card no table is built and
    ``extent`` lets the kernels stop at each tile's last alive slot."""
    return rops.dense_hit_list(qboxes, canon_tiles, alive=alive,
                               extent=extent)


def gathered_hits(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                  cand: torch.Tensor,
                  chunk_boxes: torch.Tensor | None = None,
                  alive: torch.Tensor | None = None, *,
                  extent: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every hit of the routed probe -> int64 ``(query, tile, slot)``, in
    (query, candidate, slot) order: the order of the reference's
    flattened ``(Q, F·cap)`` gathered hit table (a ``-1`` candidate
    holds no hits).  ``ops.gathered_hit_list{,_skip}``: on the card no
    table is built and ``extent``, the ``live_extent`` of ``alive``,
    lets the kernels stop at each tile's last alive slot."""
    if chunk_boxes is None:
        return rops.gathered_hit_list(qboxes, canon_tiles, cand, alive=alive,
                                      extent=extent)
    return rops.gathered_hit_list_skip(qboxes, canon_tiles, chunk_boxes,
                                       cand, alive=alive, extent=extent)


def ids_answer(qi: torch.Tensor, hid: torch.Tensor, q: int, max_hits: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The id executors' shared tail: hits as (query, member id) pairs,
    ``-1`` ids (padding slots) dropped -> ``(hit_ids[Q, max_hits] int32,
    counts[Q] int32, overflow[Q])``, ids ascending and ``-1`` padded,
    a query with more than ``max_hits`` hits keeping its smallest.

    The reference sorts each query's keyed full row (misses keyed
    ``_BIG_ID``); sorting only the hits by ``(query, id)`` gives the
    same ids in the same order, so the same bits.
    """
    keep = hid >= 0
    qi, hid = qi[keep], hid[keep].long()
    counts = torch.bincount(qi, minlength=q).to(torch.int32)
    key = torch.sort(qi * _BIG_ID + hid).values
    qs, hs = key // _BIG_ID, key % _BIG_ID
    rank = torch.arange(key.shape[0], device=key.device) - (
        torch.cumsum(counts, 0) - counts)[qs]
    top = rank < max_hits
    hit_ids = torch.full((q, max_hits), -1, dtype=torch.int32,
                         device=hid.device)
    hit_ids[qs[top], rank[top]] = hs[top].to(torch.int32)
    return hit_ids, counts, counts > max_hits


def range_ids(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
              ids: torch.Tensor, max_hits: int,
              alive: torch.Tensor | None = None, *,
              extent: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-query unique hit-id sets over every tile.

    ids: (T, cap) int32 member ids (-1 padding) -> ``(hit_ids[Q,
    max_hits] int32, counts[Q] int32, overflow[Q])`` as
    ``ids_answer``.  The hits come from ``dense_hits`` (``extent`` as
    there): on the card without the reference's (Q, T, cap) table (277
    MB a query at T = 2048, cap = 135,296).
    """
    qi, ti, si = dense_hits(qboxes, canon_tiles, alive, extent=extent)
    return ids_answer(qi, ids[ti, si], qboxes.shape[0], max_hits)


def pruned_range_counts(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                        cand: torch.Tensor,
                        chunk_boxes: torch.Tensor | None = None,
                        alive: torch.Tensor | None = None, *,
                        extent: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-query unique hit counts, probing candidate tiles only.

    qboxes: (Q, 4); canon_tiles: (T, cap, 4) canonical member boxes;
    cand: (Q, F) int32 from ``serve.router.candidate_range`` (-1 =
    padding) -> (Q,) int32.  ``chunk_boxes`` (T, C, 4), when given,
    selects the chunk-skipping kernel (same bits).  ``alive``: (T, cap)
    tombstone mask; ``extent``: its ``live_extent``, where the kernel
    may stop.
    """
    if chunk_boxes is None:
        per = rops.gathered_counts(qboxes, canon_tiles, cand, alive=alive,
                                   extent=extent)
    else:
        per = rops.gathered_counts_skip(qboxes, canon_tiles, chunk_boxes,
                                        cand, alive=alive, extent=extent)
    return per.sum(1, dtype=torch.int32)


def pruned_range_ids(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                     ids: torch.Tensor, cand: torch.Tensor, max_hits: int,
                     chunk_boxes: torch.Tensor | None = None,
                     alive: torch.Tensor | None = None, *,
                     extent: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-query unique hit-id sets from candidate tiles only.

    ids: (T, cap) int32 (-1 padding); cand: (Q, F) int32 (-1 padding)
    -> ``(hit_ids[Q, max_hits] int32, counts[Q] int32, overflow[Q])``:
    as ``ids_answer``.  The hits come from ``gathered_hits`` (``extent``
    as there): on the card without the reference's (Q, F, cap) table.
    """
    qi, ti, si = gathered_hits(qboxes, canon_tiles, cand, chunk_boxes, alive,
                               extent=extent)
    return ids_answer(qi, ids[ti, si], qboxes.shape[0], max_hits)


# --------------------------------------------------------------------------
# owner-partial merges (the sharded executor's home-side reduce)
# --------------------------------------------------------------------------

def _home_index(slots: torch.Tensor, qpd: int) -> torch.Tensor:
    """Each message's home query slot, dead messages (``-1``) sent to a
    trash slot ``qpd`` that the merges slice off -> int64, as ``slots``."""
    return torch.where(slots >= 0, slots, qpd).long()


def merge_owner_counts(partials: torch.Tensor, slots: torch.Tensor,
                       qpd: int) -> torch.Tensor:
    """Sum per-owner partial counts back onto home query slots.

    partials: (..., D, M) int32, entry (o, m) owner ``o``'s count for
    this home's ``m``-th message to it; slots: (..., D, M) int32 home
    query slot of each message (-1 = padding) -> (..., qpd) int32.
    Leading dims are homes merged at once.  Exact: canonical copies
    partition the ids across tiles and the placement the tiles across
    owners, so every hit is counted by exactly one owner and the merge
    is an integer sum.
    """
    lead = partials.shape[:-2]
    idx = _home_index(slots, qpd).flatten(-2)
    vals = torch.where(slots >= 0, partials, 0).flatten(-2).to(torch.int32)
    out = torch.zeros(lead + (qpd + 1,), dtype=torch.int32,
                      device=partials.device)
    return out.scatter_add_(-1, idx, vals)[..., :qpd]


def _owner_table(vals: torch.Tensor, slots: torch.Tensor, qpd: int,
                 fill) -> torch.Tensor:
    """(..., D, M, w) per-message rows -> (..., qpd, D·w): row ``s``
    holds owner ``o``'s row of the message carrying slot ``s`` in
    columns ``o·w .. o·w + w``, ``fill`` where no message carries it
    (a query reaches each owner at most once, so no cell is written
    twice outside the trash slot)."""
    lead = vals.shape[:-3]
    d, m, w = vals.shape[-3:]
    b = int(np.prod(lead))
    tbl = torch.full((b, qpd + 1, d, w), fill, dtype=vals.dtype,
                     device=vals.device)
    dev = vals.device
    tbl[torch.arange(b, device=dev)[:, None, None],
        _home_index(slots, qpd).reshape(b, d, m),
        torch.arange(d, device=dev)[None, :, None]] = vals.reshape(b, d, m, w)
    return tbl[:, :qpd].reshape(lead + (qpd, d * w))


def merge_owner_ids(pids: torch.Tensor, pcounts: torch.Tensor,
                    slots: torch.Tensor, qpd: int, max_hits: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union per-owner ascending id partials into the ``range_ids``
    contract.

    pids: (..., D, M, mh) ascending local hit ids (-1 padded) of each
    owner; pcounts: (..., D, M) true (untruncated) local counts; slots:
    (..., D, M) home query slots (-1 padding) -> ``(hit_ids[..., qpd,
    max_hits] int32, counts[..., qpd] int32, overflow[..., qpd])``.
    Each query reaches each owner at most once and each canonical id
    lives on exactly one owner, so the union has no duplicate and one
    ascending sort of each query's row gives the dense path's ids.  An
    owner that truncated (more than ``mh`` hits) makes ``counts >
    max_hits`` when ``mh == max_hits``, so it is flagged, never silent.
    """
    keyed = torch.where((slots >= 0)[..., None] & (pids >= 0), pids,
                        _BIG_ID).to(torch.int32)
    flat = _owner_table(keyed, slots, qpd, _BIG_ID)
    if flat.shape[-1] < max_hits:
        flat = torch.nn.functional.pad(flat, (0, max_hits - flat.shape[-1]),
                                       value=_BIG_ID)
    top = torch.sort(flat, dim=-1).values[..., :max_hits]
    hit_ids = torch.where(top < _BIG_ID, top, -1)
    counts = merge_owner_counts(pcounts, slots, qpd)
    return hit_ids, counts, counts > max_hits


# --------------------------------------------------------------------------
# reference-point path (non-overlapping covering layouts)
# --------------------------------------------------------------------------

def _rp_owned(q: torch.Tensor, boxes: torch.Tensor, tile_box: torch.Tensor,
              uni: torch.Tensor) -> torch.Tensor:
    """Reference-point ownership, broadcast over the leading dimensions:
    the low corner of ``q`` ∩ ``boxes`` lies in ``tile_box``, half-open
    on its high edges but where they reach the universe's."""
    rpx = torch.maximum(q[..., 0], boxes[..., 0])
    rpy = torch.maximum(q[..., 1], boxes[..., 1])
    hi_x = torch.where(tile_box[..., 2] >= uni[2], rpx <= tile_box[..., 2],
                       rpx < tile_box[..., 2])
    hi_y = torch.where(tile_box[..., 3] >= uni[3], rpy <= tile_box[..., 3],
                       rpy < tile_box[..., 3])
    return (rpx >= tile_box[..., 0]) & hi_x & (rpy >= tile_box[..., 1]) \
        & hi_y


# reprolint: disable=kernel-twin-parity -- reference-point research path
# over full MASJ tiles of a static layout; not part of the tombstone
# serving surface (serving goes through range_counts/pruned_*)
def range_counts_rp(qboxes: torch.Tensor, tiles: torch.Tensor,
                    tile_boxes: torch.Tensor, uni: torch.Tensor
                    ) -> torch.Tensor:
    """Exact unique counts by reference-point ownership (fg, bsp, slc,
    bos) over the full MASJ ``tiles`` (T, cap, 4) -> (Q,) int32: the
    full hit table, each hit counted in the tile that owns it."""
    hits = rops.probe_mask(qboxes, tiles)                 # (Q, T, cap)
    own = _rp_owned(qboxes[:, None, None], tiles[None],
                    tile_boxes[None, :, None], uni)
    return torch.sum(hits & own, dim=(1, 2), dtype=torch.int32)


# reprolint: disable=kernel-twin-parity -- reference-point research path
# (see range_counts_rp): static layouts only, outside the tombstone
# serving surface
def routed_range_counts(qboxes: torch.Tensor, tiles: torch.Tensor,
                        tile_boxes: torch.Tensor, uni: torch.Tensor,
                        route_mask: torch.Tensor, max_fanout: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pruned reference-point probe: each query gathers its routed
    tiles only (``route_mask`` (Q, T) bool, routed first in tile order,
    the first ``max_fanout``) -> ``(counts[Q] int32, overflow[Q])``;
    a query routed to more than ``max_fanout`` tiles undercounts and is
    flagged."""
    fanout = torch.sum(route_mask, dim=1, dtype=torch.int32)
    order = torch.argsort((~route_mask).to(torch.uint8), dim=1, stable=True)
    routed = order[:, :max_fanout]                          # (Q, F)
    live = torch.take_along_dim(route_mask, routed, dim=1)  # (Q, F)
    tb = tile_boxes[routed][:, :, None]                     # (Q, F, 1, 4)
    mb = tiles[routed]                                      # (Q, F, cap, 4)
    q = qboxes[:, None, None]
    hits = _rp_owned(q, mb, tb, uni) & geometry.intersects(q, mb)
    counts = torch.sum(hits & live[..., None], dim=(1, 2), dtype=torch.int32)
    return counts, fanout > max_fanout
