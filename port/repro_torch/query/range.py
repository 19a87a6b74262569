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
