"""Batched range queries over staged layouts (the pruned canonical path
of ``repro.query.range``).

A range query is a box; its answer is the set of dataset objects whose
MBR intersects it (closed boxes).  Staging marks exactly one copy of
every object canonical, so probing only canonical copies of each
query's routed ``(Q, F)`` candidate tiles yields exact unique counts
and id sets with no dedup work, at O(Q·F·cap) instead of O(Q·T·cap).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.range_probe import ops as rops

_BIG_ID = 2**30
_HIT_TABLE_BYTES = 1 << 31   # bytes of (query, candidate, slot) hit table


def range_query_ref(mbrs: np.ndarray, qboxes: np.ndarray) -> list[np.ndarray]:
    """Per-query sorted hit-id arrays, numpy brute force (oracle)."""
    out = []
    for q in qboxes:
        hit = ((q[0] <= mbrs[:, 2]) & (mbrs[:, 0] <= q[2])
               & (q[1] <= mbrs[:, 3]) & (mbrs[:, 1] <= q[3]))
        out.append(np.flatnonzero(hit).astype(np.int32))
    return out


def pruned_range_counts(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                        cand: torch.Tensor,
                        chunk_boxes: torch.Tensor | None = None,
                        alive: torch.Tensor | None = None) -> torch.Tensor:
    """Exact per-query unique hit counts, probing candidate tiles only.

    qboxes: (Q, 4); canon_tiles: (T, cap, 4) canonical member boxes;
    cand: (Q, F) int32 from ``serve.router.candidate_range`` (-1 =
    padding) -> (Q,) int32.  ``chunk_boxes`` (T, C, 4), when given,
    selects the chunk-skipping kernel (same bits).  ``alive``: (T, cap)
    tombstone mask.
    """
    if chunk_boxes is None:
        per = rops.gathered_counts(qboxes, canon_tiles, cand, alive=alive)
    else:
        per = rops.gathered_counts_skip(qboxes, canon_tiles, chunk_boxes,
                                        cand, alive=alive)
    return per.sum(1, dtype=torch.int32)


def hit_table_blocks(cand: torch.Tensor, cap: int
                     ) -> list[tuple[slice, int]]:
    """How ``pruned_range_ids`` cuts one batch into launches of the
    hit-table kernel -> ``[(query rows, width), ...]``.

    The full (Q, F, cap) table can exceed the card (1024 x 448 x 135k
    is 62 GB); ``F`` is the batch's widest fan-out, ratcheted, so most
    columns are -1 padding, which has no hits.  Each block of
    consecutive queries keeps only the candidate columns up to its last
    live one, and holds at most ``_HIT_TABLE_BYTES`` of table (at least
    one query).  Blocks whose queries have no live candidate are left
    out: they hit nothing.
    """
    q, f = cand.shape
    col = torch.arange(1, f + 1, device=cand.device)
    width = ((cand >= 0) * col).amax(1).tolist() if f else [0] * q
    blocks, i = [], 0
    while i < q:
        j, w = i, 0
        while j < q and (j == i or max(w, width[j]) * cap * (j + 1 - i)
                         <= _HIT_TABLE_BYTES):
            w = max(w, width[j])
            j += 1
        if w:
            blocks.append((slice(i, j), w))
        i = j
    return blocks


def pruned_range_ids(qboxes: torch.Tensor, canon_tiles: torch.Tensor,
                     ids: torch.Tensor, cand: torch.Tensor, max_hits: int,
                     chunk_boxes: torch.Tensor | None = None,
                     alive: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-query unique hit-id sets from candidate tiles only.

    ids: (T, cap) int32 (-1 padding); cand: (Q, F) int32 (-1 padding)
    -> ``(hit_ids[Q, max_hits] int32, counts[Q] int32, overflow[Q])``:
    ids ascending, padded with -1; a query with more than ``max_hits``
    hits keeps its ``max_hits`` smallest ids and is flagged.

    The reference builds the whole (Q, F, cap) hit table and sorts each
    query's keyed row.  Here the table is built in the blocks of
    ``hit_table_blocks`` and only the hits are sorted, by the key
    ``(query, id)``.  The hits and their order are the same, so the
    answer is the same bits.
    """
    q, cap = qboxes.shape[0], canon_tiles.shape[1]
    qi, hid = [], []
    for rows, w in hit_table_blocks(cand, cap):
        cd = cand[rows, :w]
        if chunk_boxes is None:
            mask = rops.gathered_mask(qboxes[rows], canon_tiles, cd,
                                      alive=alive)
        else:
            mask = rops.gathered_mask_skip(qboxes[rows], canon_tiles,
                                           chunk_boxes, cd, alive=alive)
        bq, bf, bs = mask.nonzero(as_tuple=True)   # -1 columns are empty
        qi.append(bq + rows.start)
        hid.append(ids[cd[bq, bf].long(), bs])
    qi = torch.cat(qi) if qi else cand.new_zeros(0, dtype=torch.int64)
    hid = torch.cat(hid) if hid else ids.new_zeros(0)
    keep = hid >= 0
    qi, hid = qi[keep], hid[keep].long()
    counts = torch.bincount(qi, minlength=q).to(torch.int32)
    key = torch.sort(qi * _BIG_ID + hid).values
    qs, hs = key // _BIG_ID, key % _BIG_ID
    rank = torch.arange(key.shape[0], device=key.device) - (
        torch.cumsum(counts, 0) - counts)[qs]
    top = rank < max_hits
    hit_ids = torch.full((q, max_hits), -1, dtype=torch.int32,
                         device=ids.device)
    hit_ids[qs[top], rank[top]] = hs[top].to(torch.int32)
    return hit_ids, counts, counts > max_hits
