"""Staging and the replicated single-device tile layout (the parts of
``repro.serve.layout`` the routed range path needs).

``stage_tiles`` MASJ-stages a dataset under a ``Partitioning`` into
``(T, cap, 4)`` member tiles: every object is copied to every tile
whose region it touches, exactly one copy is marked canonical, each
tile gets a *probe box* (tight MBR over its canonical members) for
routing, and with a local index (``local_index="x"``: canonical xmin;
``"hilbert"``: the Hilbert key of the canonical centre) each tile's
slots are sorted and summarised by one chunk box per 128 slots for the
chunk-skipping kernels.  ``ReplicatedTiles`` serves range and kNN
batches against one such staging on one device, routed (pruned) or
over every tile (the dense oracle).

Membership is built blockwise over objects as (object, tile) pairs
(``core.partition.assign.membership``): the reference's dense
``(N, kmax)`` bool table would be 16 GB at 8 M objects and 2048 tiles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry
from ..core.partition import api
from ..core.partition.assign import assign_from_pairs, membership, round_up
from ..device import not_ported
from ..kernels.hilbert import ops as hilbert_ops
from ..kernels.range_probe import ops as rops
from ..query import knn as knn_mod
from ..query import range as range_mod
from . import router
from .config import ServeConfig

_KEY_BLOCK_SLOTS = 1 << 25   # slots per block of Hilbert sort keys

@dataclasses.dataclass(frozen=True)
class StagedLayout:
    """Device-resident staging of one partitioned dataset.

    tiles       : (T, cap, 4) member MBRs, sentinel-padded (all copies;
                  None once installed for serving, which reads
                  canonical data only)
    ids         : (T, cap) int32 member ids, -1 in padding slots
    canon_tiles : (T, cap, 4) canonical copies only (others sentineled)
    tile_boxes  : (T, 4) partition regions (sentinel for invalid rows)
    probe_boxes : (T, 4) tight MBR over each tile's canonical members
                  (sentinel where a tile holds none)
    chunk_boxes : (T, C, 4) local index, chunk c bounding the canonical
                  members of slots [c*128, (c+1)*128); None when staged
                  with ``local_index="off"``
    alive       : (T, cap) bool, slot holds a live canonical member
    uni         : (4,) dataset universe
    """

    tiles: torch.Tensor | None
    ids: torch.Tensor
    canon_tiles: torch.Tensor
    tile_boxes: torch.Tensor
    probe_boxes: torch.Tensor
    chunk_boxes: torch.Tensor | None
    alive: torch.Tensor
    uni: torch.Tensor


def staged_from_numpy(src, device: torch.device | str) -> StagedLayout:
    """Carry a staging across from arrays: ``src`` has the
    ``StagedLayout`` fields as attributes (e.g. ``repro``'s staging,
    whose arrays convert with ``np.asarray``); None fields stay None."""
    def put(name):
        a = getattr(src, name)
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=device)
    return StagedLayout(**{f.name: put(f.name)
                           for f in dataclasses.fields(StagedLayout)})


def _chunk_summary(canon_tiles: torch.Tensor, chunk: int) -> torch.Tensor:
    """(T, cap, 4) canonical tiles -> (T, ceil(cap/128), 4) chunk boxes
    at ``chunk``-slot granularity, broadcast down to the kernels'
    128-slot grid (sentinel slots are min/max-neutral; an all-sentinel
    group collapses to the sentinel box)."""
    t, cap, _ = canon_tiles.shape
    g = -(-cap // chunk)
    pad = g * chunk - cap
    if pad:
        canon_tiles = torch.cat(
            [canon_tiles,
             geometry.sentinel(canon_tiles.device).expand(t, pad, 4)], dim=1)
    grp = canon_tiles.reshape(t, g, chunk, 4)
    boxes = torch.cat([grp[..., :2].amin(dim=2), grp[..., 2:].amax(dim=2)],
                      dim=-1)
    c128 = -(-cap // rops.CHUNK)
    return boxes.repeat_interleave(chunk // rops.CHUNK, dim=1)[:, :c128]


def _local_sort_order(canon_tiles: torch.Tensor, ids: torch.Tensor,
                      mode: str, uni: torch.Tensor) -> torch.Tensor:
    """Per-tile slot permutation for the local index.

    ``"x"``: stable sort on canonical xmin; non-canonical copies and
    padding carry the sentinel 9e9 and sink to the tail in their
    original order.  ``"hilbert"``: canonical slots lead in ascending
    Hilbert key of their MBR centre (``kernels.hilbert`` over the
    dataset universe), under a three-tier primary key (canonical <
    non-canonical live < padding) so live slots stay a prefix.  The
    reference's two stable sorts (key, then tier) are one stable sort
    of ``tier << 32 | key`` here; non-canonical and padding slots all
    carry the sentinel centre (0, 0), so their keys tie and they keep
    their order.  Keys are built ``_KEY_BLOCK_SLOTS`` slots at a time.
    """
    if mode == "x":
        return torch.sort(canon_tiles[..., 0], dim=1, stable=True).indices
    t, cap, _ = canon_tiles.shape
    rows = max(1, _KEY_BLOCK_SLOTS // max(cap, 1))
    out = []
    for i0 in range(0, t, rows):
        ct = canon_tiles[i0:i0 + rows]
        centers = (ct[..., :2] + ct[..., 2:]) * 0.5
        keys = hilbert_ops.hilbert_keys(centers.reshape(-1, 2), uni)
        tier = torch.where(ct[..., 0] < 1e9, 0,
                           torch.where(ids[i0:i0 + rows] >= 0, 1, 2))
        key = (tier.long() << 32) | keys.reshape(tier.shape)
        out.append(torch.sort(key, dim=1, stable=True).indices)
    return torch.cat(out)


def stage_tiles(parts: api.Partitioning, mbrs: torch.Tensor,
                config: ServeConfig | None = None
                ) -> tuple[StagedLayout, dict]:
    """MASJ-stage ``mbrs`` under ``parts`` per ``config``.

    mbrs: (N, 4) f32 on the staging device -> ``(StagedLayout,
    stats)``; raises on capacity overflow.  ``config.capacity=None``
    sizes capacity from the max tile count plus ``config.slack``,
    128-aligned.  ``stats['replication']`` is the paper's lambda.
    """
    config = config or ServeConfig()
    dev = mbrs.device
    n, kmax = mbrs.shape[0], parts.kmax
    obj, part = membership(parts, mbrs)
    counts = torch.bincount(part, minlength=kmax)
    if config.capacity is None:
        capacity = round_up(max(int(counts.max()) + config.slack, 1), 128)
    else:
        capacity = config.capacity
    members, mask, overflow = assign_from_pairs(obj, part, kmax, capacity)
    if int(overflow.sum()) > 0:
        over = counts - capacity
        raise ValueError(
            f"staging overflow: capacity {capacity} < max tile count "
            f"{int(counts.max())} ({int((over > 0).sum())} of "
            f"{parts.k()} tiles overflow, worst by "
            f"{int(over.max())} members -- raise capacity or payload)")

    sentinel = geometry.sentinel(dev)
    tiles = torch.where(mask[..., None], mbrs[members.long()], sentinel)
    ids = torch.where(mask, members, -1)

    # canonical mark: first copy of each id in tile-major order wins,
    # so every object has exactly one canonical slot
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    s = flat[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       s[1:] != s[:-1]])
    canon = torch.empty_like(flat, dtype=torch.bool)
    canon[order] = first & (s >= 0)
    canon = canon.reshape(ids.shape)
    canon_tiles = torch.where(canon[..., None], tiles, sentinel)

    uni = geometry.universe(mbrs)
    chunk_boxes = None
    if config.indexed:
        slot_order = _local_sort_order(canon_tiles, ids,
                                       config.local_index, uni)
        idx4 = slot_order[..., None].expand(-1, -1, 4)
        tiles = torch.gather(tiles, 1, idx4)
        canon_tiles = torch.gather(canon_tiles, 1, idx4)
        ids = torch.gather(ids, 1, slot_order)
        chunk_boxes = _chunk_summary(canon_tiles, config.chunk)

    probe_boxes = torch.cat([canon_tiles[..., :2].amin(dim=1),
                             canon_tiles[..., 2:].amax(dim=1)], dim=-1)
    tile_boxes = torch.where(parts.valid[:, None], parts.boxes, sentinel)
    alive = canon_tiles[..., 0] < 1e9
    layout = StagedLayout(tiles=tiles, ids=ids, canon_tiles=canon_tiles,
                          tile_boxes=tile_boxes, probe_boxes=probe_boxes,
                          chunk_boxes=chunk_boxes, alive=alive, uni=uni)
    stats = dict(
        n=n, t=parts.k(), cap=capacity,
        t_live=int((probe_boxes[:, 0] <= probe_boxes[:, 2]).sum()),
        chunks=0 if chunk_boxes is None else int(chunk_boxes.shape[1]),
        replication=float(counts.sum()) / n - 1.0,
        local_index=config.local_index, chunk=config.chunk,
        slack=config.slack,
    )
    return layout, stats


class ReplicatedTiles:
    """The full staging on one device.  Each routed batch probes its
    candidate tiles with the gathered kernels (chunk-skipping when the
    staging carries a local index); the dense oracle probes every tile
    with the dense kernels.  Every probe passes the alive mask and its
    live extent.  Stats
    dicts equal the reference's with ``mesh=None``."""

    mode = "pruned"

    def __init__(self, parts: api.Partitioning, layout: StagedLayout,
                 stats: dict, config: ServeConfig):
        self.parts = parts
        self.config = config
        # the executors read canonical data only: drop the all-copies
        # member tiles instead of keeping (T, cap, 4) bytes resident
        self.staged = dataclasses.replace(layout, tiles=None)
        # (T,) int32 live extent of the alive mask: the routed and dense
        # count and hit-list kernels stop each tile's walk there (ingest
        # must keep it in step with ``alive``)
        self.extent = rops.live_extent(layout.alive)
        self.stats = dict(stats, placement=config.placement,
                          probe=config.probe, restages=0, compactions=0,
                          n_total=stats["n"])

    @property
    def probe_boxes(self) -> torch.Tensor:
        return self.staged.probe_boxes

    @property
    def chunk_boxes(self) -> torch.Tensor | None:
        return self.staged.chunk_boxes

    def resident_tile_bytes(self) -> int:
        lay = self.staged
        return (lay.canon_tiles.numel() * lay.canon_tiles.element_size()
                + lay.ids.numel() * lay.ids.element_size())

    def range_counts(self, qboxes, cand, costs):
        lay = self.staged
        counts = range_mod.pruned_range_counts(
            qboxes, lay.canon_tiles, cand, chunk_boxes=lay.chunk_boxes,
            alive=lay.alive, extent=self.extent)
        return counts, dict(skew=1.0)

    def range_ids(self, qboxes, cand, costs, max_hits: int):
        lay = self.staged
        hit_ids, counts, overflow = range_mod.pruned_range_ids(
            qboxes, lay.canon_tiles, lay.ids, cand, max_hits,
            chunk_boxes=lay.chunk_boxes, alive=lay.alive, extent=self.extent)
        return hit_ids, counts, overflow, dict(skew=1.0)

    def knn_attempt(self, pts, k: int, max_cand: int, f: int):
        """One pruned kNN pass at frontier width ``f`` -> ``(nn_ids,
        nn_d2, radius, overflow, excluded, stats)``."""
        lay = self.staged
        cand, _, excl = router.candidate_knn(lay.probe_boxes, pts, f)
        nn_ids, nn_d2, radius, overflow, rounds = knn_mod.pruned_knn(
            pts, k, lay.canon_tiles, lay.ids, lay.uni, cand, excl,
            max_cand=max_cand, n_live=self.stats["n"],
            chunk_boxes=lay.chunk_boxes, alive=lay.alive, extent=self.extent)
        return nn_ids, nn_d2, radius, overflow, excl, dict(
            skew=1.0, rounds=_max_rounds(rounds))

    # -- dense oracle ----------------------------------------------------

    def dense_range_counts(self, qboxes):
        lay = self.staged
        counts = range_mod.range_counts(qboxes, lay.canon_tiles, lay.alive,
                                        extent=self.extent)
        return counts, dict(skew=1.0)

    def dense_range_ids(self, qboxes, max_hits: int):
        lay = self.staged
        hit_ids, counts, overflow = range_mod.range_ids(
            qboxes, lay.canon_tiles, lay.ids, max_hits, lay.alive,
            extent=self.extent)
        return hit_ids, counts, overflow, dict(skew=1.0)

    def dense_knn(self, pts, k: int, max_cand: int):
        lay = self.staged
        nn_ids, nn_d2, _, overflow, rounds = knn_mod.batched_knn(
            pts, k, lay.canon_tiles, lay.ids, lay.uni, max_cand=max_cand,
            n_live=self.stats["n"], alive=lay.alive, extent=self.extent)
        return nn_ids, nn_d2, overflow, dict(rounds=_max_rounds(rounds),
                                             skew=1.0)


def _max_rounds(rounds: torch.Tensor) -> int:
    return int(rounds.max()) if rounds.numel() else 0


def build_tiles(parts: api.Partitioning, mbrs: torch.Tensor,
                config: ServeConfig) -> ReplicatedTiles:
    """Stage ``mbrs`` and construct the placement ``config`` names."""
    if config.placement != "replicated":
        raise not_ported(f"placement={config.placement!r}",
                         "Queue 1 items 10-11")
    layout, stats = stage_tiles(parts, mbrs, config)
    return ReplicatedTiles(parts, layout, stats, config)
