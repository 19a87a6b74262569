"""Batched exact k-nearest-neighbour queries over staged layouts (twin
of ``repro.query.knn``, single-device executors).

kNN is iterative-deepening range probing: each query point grows an
L∞ box ``[pt ± r]`` (doubling ``r``) until the box holds at least
``k`` unique canonical objects, then one refinement pass extracts the
hits of the √2-inflated box (d∞ ≤ r ⇒ d₂ ≤ r·√2, so it holds every
true neighbour) and takes an exact top-k by ``(distance, id)``.

- ``batched_knn``: the dense oracle, probing every tile.
- ``pruned_knn``: probes each query's MINDIST frontier of candidate
  tiles only (``serve.router.candidate_knn``) and flags a query whose
  refinement radius reaches the nearest excluded tile.

Bit-identity with the reference rests on three things kept here: the
deepening arithmetic is float32 in the reference's order of operations
(``initial_radius``, ``r_cover``, ``r * 2``, ``r * sqrt(float32(2))``);
``d2`` rounds as the reference's does where it is computed (below);
and the kept candidates are the reference's
``jnp.nonzero(size=max_cand)`` choice, the first ``max_cand`` hits in
flat table order.

``d2 = dx*dx + dy*dy`` rounds two ways in the reference.  Called
eagerly (``knn_fanout`` from the server), it is two multiplies and an
add.  Compiled under ``jax.jit`` on the CPU (the executors,
``router.route_knn``), XLA contracts it to ``fma(dx, dx, dy*dy)``:
``dy*dy`` rounded, ``dx*dx`` not.  ``mindist2`` is the first,
``mindist2_fused`` the second, each bit for bit.

The reference's deepening ``while_loop`` is a host loop here, checking
``any((counts < k) & (r < r_cover))`` once per round; a round re-counts
only the queries whose radius moved (the others' counts cannot change).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.fma import fma32, sqrt32
from ..kernels.range_probe import ops as rops
from . import range as range_mod

_BIG_ID = 2**30
_SQRT2_F32 = float(np.sqrt(np.float32(2.0)))   # float32 sqrt(2), exact
_INF_BITS = 0x7F800000                         # float32 +inf as int32 bits


def mindist2(pts: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean MINDIST, point to closed box, rounded as two
    multiplies and an add.

    pts: (..., 2), boxes: (K, 4) -> (..., K); 0 inside the box.
    """
    dx, dy = _deltas(pts[..., None, 0], pts[..., None, 1], boxes)
    return dx * dx + dy * dy          # separate ops: no FMA contraction


def mindist2_fused(pts: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """``mindist2`` rounded as ``fma(dx, dx, dy*dy)``, the reference's
    bits wherever it runs under ``jax.jit``."""
    return _fma_sq(*_deltas(pts[..., None, 0], pts[..., None, 1], boxes))


def _deltas(x, y, boxes):
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    dx = torch.maximum(torch.maximum(boxes[..., 0] - x, x - boxes[..., 2]),
                       zero)
    dy = torch.maximum(torch.maximum(boxes[..., 1] - y, y - boxes[..., 3]),
                       zero)
    return dx, dy


def _fma_sq(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(dx, dx, dy*dy)``, correctly rounded."""
    return fma32(dx, dx, dy * dy)


def knn_ref(mbrs: np.ndarray, pts: np.ndarray, k: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy brute-force oracle: (Q, k) ids and squared distances,
    ordered by (distance, id)."""
    px, py = pts[:, None, 0], pts[:, None, 1]
    dx = np.maximum(np.maximum(mbrs[None, :, 0] - px, px - mbrs[None, :, 2]),
                    0.0)
    dy = np.maximum(np.maximum(mbrs[None, :, 1] - py, py - mbrs[None, :, 3]),
                    0.0)
    d2 = dx * dx + dy * dy
    ids = np.broadcast_to(np.arange(mbrs.shape[0]), d2.shape)
    order = np.lexsort((ids, d2), axis=1)[:, :k]
    return order.astype(np.int32), np.take_along_axis(d2, order, axis=1)


def _qboxes(pts: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    rr = r[:, None]
    return torch.cat([pts - rr, pts + rr], dim=-1)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def initial_radius(diag: torch.Tensor, k: int, n_slots) -> torch.Tensor:
    """Density-based first deepening radius, float32: the L∞ half-width
    at which a box is expected to hold ~k of ``n_slots`` uniformly
    spread objects, floored at diag·1e-6.  ``n_slots`` is the live
    canonical member count (the dataset size), not ``T·cap``.

    ``k / n`` is a float32 division of two tensors: torch computes a
    Python scalar over a tensor as a reciprocal times the scalar, which
    is not the same bits.  The root is ``sqrt32``: torch's float32
    ``sqrt`` on the CPU is not correctly rounded on every host.
    """
    n = torch.clamp_min(_f32(n_slots, diag.device), 1.0)
    r = diag * 0.5 * sqrt32(_f32(k, diag.device) / n)
    return torch.maximum(r, diag * 1e-6)


def _deepening_start(pts, k, canon_tiles, uni, r0, n_live):
    """-> ``(r_init, r_cover[Q])``, as the reference's executors."""
    diag = sqrt32(torch.sum((uni[2:] - uni[:2]) ** 2))
    if r0 is None:
        n_slots = (n_live if n_live is not None
                   else canon_tiles.shape[0] * canon_tiles.shape[1])
        r_init = initial_radius(diag, k, n_slots)
    else:
        r_init = torch.maximum(_f32(r0, pts.device), diag * 1e-6)
    # per-query L∞ radius at which the box covers the universe, so
    # deepening ends with >= min(k, n) unique hits
    r_cover = torch.maximum(
        torch.maximum(pts[:, 0] - uni[0], uni[2] - pts[:, 0]),
        torch.maximum(pts[:, 1] - uni[1], uni[3] - pts[:, 1]))
    r_cover = torch.maximum(r_cover, diag * 1e-6)
    return r_init, r_cover


def _deepen(counts_at, r: torch.Tensor, r_cover: torch.Tensor, k: int,
            max_rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's deepening ``while_loop`` on the host.

    ``counts_at(r, rows)`` -> unique hit counts of queries ``rows``
    (int64 index) at radii ``r`` -> ``(r[Q], rounds[Q] int32)``.
    """
    q = r.shape[0]
    counts = counts_at(r, torch.arange(q, device=r.device))
    rounds = torch.zeros(q, dtype=torch.int32, device=r.device)
    for _ in range(max_rounds):
        short = counts < k
        grow = short & (r < r_cover)
        if not bool(grow.any()):
            break
        r_new = torch.where(short, torch.minimum(r * 2.0, r_cover), r)
        moved = (r_new != r).nonzero().squeeze(1)
        r = r_new
        counts[moved] = counts_at(r[moved], moved)
        rounds += grow.to(torch.int32)
    return r, rounds


def _refine_topk(k: int, pts: torch.Tensor, qi: torch.Tensor,
                 ti: torch.Tensor, si: torch.Tensor,
                 canon_tiles: torch.Tensor, ids: torch.Tensor, max_cand: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every query's exact top-k by ``(distance, id)`` from its hits.

    ``(qi, ti, si)``: int64 (query, tile, slot) of each hit, ascending
    in query, each query's hits in the reference's flat table order.
    Hits on ``-1`` id slots are not candidates (the reference's
    ``& (ids >= 0)``).  At most ``max_cand`` candidates of a query are
    kept, its first ones, as the reference's
    ``jnp.nonzero(size=max_cand)`` keeps them -> ``(ids[Q, k'] int32,
    d2[Q, k'] f32, n_cand[Q] int32)`` with ``k' = min(k, max_cand)``,
    missing entries -1 / +inf.

    The reference orders a query's kept candidates by a stable argsort
    of ``d2`` after one of ``cid``, i.e. by the pair ``(d2, cid)``.
    ``d2 >= 0``, so its float32 bits order as its values do, and the
    int64 key ``bits(d2) << 32 | cid`` orders exactly as the pair; ids
    are distinct, so the order is total and any sort gives its bits.
    """
    cid = ids[ti, si]
    live = cid >= 0
    qi, ti, si, cid = qi[live], ti[live], si[live], cid[live]
    q = pts.shape[0]
    n_cand = torch.bincount(qi, minlength=q).to(torch.int32)
    rank = torch.arange(qi.shape[0], device=qi.device) - (
        torch.cumsum(n_cand, 0) - n_cand)[qi]
    keep = rank < max_cand
    qi, rank, cid = qi[keep], rank[keep], cid[keep]
    p = pts[qi]
    d2 = _fma_sq(*_deltas(p[:, 0], p[:, 1], canon_tiles[ti[keep], si[keep]]))
    key = (d2.view(torch.int32).long() << 32) | cid.long()
    pad = (_INF_BITS << 32) | _BIG_ID
    table = torch.full((q, max_cand), pad, dtype=torch.int64,
                       device=pts.device)
    table[qi, rank] = key
    top = torch.sort(table, dim=1).values[:, :k]
    nn_d2 = (top >> 32).to(torch.int32).view(torch.float32)
    nn_ids = torch.where(nn_d2 < math.inf, (top & 0xFFFFFFFF).to(torch.int32),
                         -1)
    return nn_ids, nn_d2, n_cand


def batched_knn(pts: torch.Tensor, k: int, canon_tiles: torch.Tensor,
                ids: torch.Tensor, uni: torch.Tensor,
                r0: float | None = None, max_rounds: int = 32,
                max_cand: int = 1024, n_live=None,
                alive: torch.Tensor | None = None, *,
                extent: torch.Tensor | None = None):
    """Exact batched kNN against a staged layout, probing every tile.

    pts: (Q, 2); canon_tiles/ids: the staging's canonical tiles and
    ids; uni: (4,) universe; ``n_live``: live canonical member count
    the initial radius is sized from (None: ``T·cap``); ``alive``:
    (T, cap) tombstone mask; ``extent``: its ``live_extent``, where the
    deepening's count kernels and the refinement's hit-list kernels may
    stop.  Returns ``(nn_ids[Q, k] int32, nn_d2[Q, k] f32, radius[Q]
    f32, overflow[Q] bool, rounds[Q] int32)``; overflow marks queries
    whose refinement box held more than ``max_cand`` candidates.  The
    refinement's hits come from ``range.dense_hits``: on the card
    without the (Q, T, cap) table.
    """
    r_init, r_cover = _deepening_start(pts, k, canon_tiles, uni, r0, n_live)

    def counts_at(r, rows):
        return range_mod.range_counts(_qboxes(pts[rows], r), canon_tiles,
                                      alive, extent=extent)

    r = r_init.expand(pts.shape[0]).clone()
    r, rounds = _deepen(counts_at, r, r_cover, k, max_rounds)
    re = r * _SQRT2_F32
    qi, ti, si = range_mod.dense_hits(_qboxes(pts, re), canon_tiles, alive,
                                      extent=extent)
    nn_ids, nn_d2, n_cand = _refine_topk(k, pts, qi, ti, si, canon_tiles,
                                         ids, max_cand)
    return nn_ids, nn_d2, r, n_cand > max_cand, rounds


def pruned_knn(pts: torch.Tensor, k: int, canon_tiles: torch.Tensor,
               ids: torch.Tensor, uni: torch.Tensor, cand: torch.Tensor,
               excluded: torch.Tensor, r0: float | None = None,
               max_rounds: int = 32, max_cand: int = 1024, n_live=None,
               chunk_boxes: torch.Tensor | None = None,
               alive: torch.Tensor | None = None, *,
               extent: torch.Tensor | None = None):
    """Exact batched kNN probing only each query's candidate tiles.

    Same contract as ``batched_knn`` plus ``cand`` (Q, F) int32 frontier
    tiles (-1 padding) and ``excluded`` (Q,) f32, the L∞ distance of
    the nearest tile not in the frontier, from
    ``serve.router.candidate_knn``.  ``chunk_boxes`` selects the
    chunk-skipping kernels (same bits); ``extent``, the ``live_extent``
    of ``alive``, lets the deepening's count kernels and the
    refinement's hit-list kernels stop at each tile's last alive slot.
    ``overflow`` flags a query
    whose refinement box held more than ``max_cand`` candidates or
    whose refinement radius reached ``excluded``.  Rows whose
    candidates are all ``-1`` start at the covering radius.
    """
    dead = (cand < 0).all(1)
    r_init, r_cover = _deepening_start(pts, k, canon_tiles, uni, r0, n_live)

    def counts_at(r, rows):
        qb, cd = _qboxes(pts[rows], r), cand[rows]
        if chunk_boxes is None:
            per = rops.gathered_counts(qb, canon_tiles, cd, alive=alive,
                                       extent=extent)
        else:
            per = rops.gathered_counts_skip(qb, canon_tiles, chunk_boxes, cd,
                                            alive=alive, extent=extent)
        return per.sum(1, dtype=torch.int32)

    r = torch.where(dead, r_cover, r_init)
    r, rounds = _deepen(counts_at, r, r_cover, k, max_rounds)
    re = r * _SQRT2_F32
    nn_ids, nn_d2, n_cand = knn_partial(pts, canon_tiles, ids, cand, re, k,
                                        max_cand=max_cand,
                                        chunk_boxes=chunk_boxes, alive=alive,
                                        extent=extent)
    overflow = (n_cand > max_cand) | (excluded <= re)
    return nn_ids, nn_d2, r, overflow, rounds


def knn_partial(pts: torch.Tensor, canon_tiles: torch.Tensor,
                ids: torch.Tensor, cand: torch.Tensor, re: torch.Tensor,
                k: int, max_cand: int = 1024,
                chunk_boxes: torch.Tensor | None = None,
                alive: torch.Tensor | None = None, *,
                extent: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refinement over candidate tiles: top-k within ``[pt ± re]``.

    re: (Q,) L∞ refinement radii (already √2-inflated) ->
    ``(nn_ids[Q, k], nn_d2[Q, k], n_cand[Q])``, ``n_cand`` the hits
    with an id ``>= 0``.  The reference gathers ``(Q, F·cap, 4)``
    member boxes (17.7 GB at Q = 1024, F = 8, cap = 135,296); here the
    hits come from ``range.gathered_hits`` (on the card without the
    gathered mask; ``extent`` as there) and boxes and ids are gathered
    for the hit slots only.
    """
    qi, ti, si = range_mod.gathered_hits(_qboxes(pts, re), canon_tiles, cand,
                                         chunk_boxes, alive, extent=extent)
    return _refine_topk(k, pts, qi, ti, si, canon_tiles, ids, max_cand)


def knn_fanout(pts: torch.Tensor, kth_d2: torch.Tensor,
               part_boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-query MINDIST fan-out: partitions a best-first search must
    visit, i.e. valid partitions with MINDIST² ≤ kth distance²."""
    d2 = mindist2(pts, part_boxes)
    return ((d2 <= kth_d2[:, None]) & valid[None, :]).sum(1, dtype=torch.int32)
