"""Staging, the ``TileLayout`` protocol, its replicated and sharded
placements, and the streaming ingest lifecycle (twin of
``repro.serve.layout``).

``stage_tiles`` MASJ-stages a dataset under a ``Partitioning`` into
``(T, cap, 4)`` member tiles: every object is copied to every tile
whose region it touches, exactly one copy is marked canonical, each
tile gets a *probe box* (tight MBR over its canonical members) for
routing, and with a local index (``local_index="x"``: canonical xmin;
``"hilbert"``: the Hilbert key of the canonical centre) each tile's
slots are sorted and summarised by one chunk box per 128 slots for the
chunk-skipping kernels.  Two placements serve range and kNN batches
against a staging, routed (pruned) or over every tile (the dense
oracle):

- ``ReplicatedTiles``: the whole staging on the one device;
- ``ShardedTiles``: tiles placed on ``D`` owners by capped LPT
  (``shard_staged``, at most ``ceil(T/D)`` tiles an owner), each batch
  run through the owner-routed exchange (``serve.exchange``).  Without
  a mesh the ``D`` owners are simulated on the one device, their
  shards one contiguous ``(D, T_rows, ...)`` array, so each move of the
  exchange is one launch over every owner; under a process mesh
  (``launch.mesh``) each rank is one owner and holds only its own
  ``(1, T_rows, ...)`` shard;
- ``HeatSharded``: the sharded placement re-planned on observed query
  heat (``rebalance``): co-located primaries and bit-exact replicas of
  the hottest tiles in ``replicate_top`` extra rows an owner.

Both stream ``append``, ``delete``, ``update`` and ``compact`` into the
staging as O(M) scatters, with an overflow re-stage of the live set
(``_TilesBase``, the lifecycle written once).

Under a mesh every rank runs the same program on the same inputs: the
same staging (taken in turns, ``launch.mesh.in_turns``, so one whole
staging is resident on a card at a time), the same host plans and the
same ingest commands on the same host mirrors; each rank keeps and
writes only its own rows.  The replicated placement keeps the whole
staging on every rank and query-shards each batch: the LPT packing's
rows go one a rank and an ``all_gather`` brings the answers back.

Membership is built blockwise over objects as (object, tile) pairs
(``core.partition.assign.membership``): the reference's dense
``(N, kmax)`` bool table would be 16 GB at 8 M objects and 2048 tiles,
and appends and updates take the same pairs.  The reference pads each
scatter to a power of two to bound JAX's recompiles; eager
``index_put_`` compiles nothing, so the port scatters unpadded.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..core import geometry, placement
from ..core.partition import api
from ..core.partition.assign import assign_from_pairs, membership, round_up
from ..kernels.hilbert import ops as hilbert_ops
from ..kernels.range_probe import ops as rops
from ..launch import mesh as mesh_lib
from ..query import knn as knn_mod
from ..query import range as range_mod
from . import exchange, router
from .config import ServeConfig

_KEY_BLOCK_SLOTS = 1 << 25   # slots per block of Hilbert sort keys

log = logging.getLogger(__name__)

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
                config: ServeConfig | None = None,
                ids: torch.Tensor | None = None
                ) -> tuple[StagedLayout, dict]:
    """MASJ-stage ``mbrs`` under ``parts`` per ``config``.

    mbrs: (N, 4) f32 on the staging device -> ``(StagedLayout,
    stats)``; raises on capacity overflow.  ``config.capacity=None``
    sizes capacity from the max tile count plus ``config.slack``,
    128-aligned.  ``stats['replication']`` is the paper's lambda.
    ``ids`` ((N,) int32, optional) numbers the objects in place of
    ``0..N-1``: a re-stage passes the surviving ids, so the running
    numbering (and every answer) survives deletes.
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
    obj_ids = members if ids is None else ids.to(torch.int32)[members.long()]
    ids = torch.where(mask, obj_ids, -1)

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


_SENTINEL = np.array(geometry.SENTINEL_BOX, np.float32)
_MIRRORS = ("_canon_np", "_ids_np", "_probe_np", "_chunk_np", "_alive_np",
            "_uni_np", "_fill", "_dead", "_free", "_n_free", "_canon_slot",
            "_live_np", "_eff_slack")


def _fmt_ids(arr) -> str:
    """Name the offending ids in an ingest error (first few + count)."""
    vals = ", ".join(str(int(i)) for i in arr[:8])
    if arr.size > 8:
        vals += f", ... ({int(arr.size)} total)"
    return vals


def _merge_plans(a: dict, b: dict) -> dict:
    """Concatenate two scatter plans key-wise.  Entries are ``(index,
    values)`` pairs except ``"uni"`` (replace: the later plan wins) and
    ``"rows"`` (whole-row rewrites; at most one producer a batch)."""
    out = dict(a)
    for key, val in b.items():
        if key in out and key not in ("uni", "rows"):
            val = tuple(np.concatenate(pair) for pair in zip(out[key], val))
        out[key] = val
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of ``t`` (never a view of a CPU staging, so
    the device staging changes only through ``_scatter``)."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def _host_np(x) -> np.ndarray:
    """A caller's array-like or tensor (on any device) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# sharded staging: tiles placed on owners, shards built on the device
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedLayout:
    """Owner-sharded staging: every owner's tile shard + the routing maps.

    canon_shards : (D, T_rows, cap, 4) canonical member MBRs, one shard
                   an owner (sentinel rows past an owner's tile count)
    id_shards    : (D, T_rows, cap) int32 member ids (-1 padding)
    alive_shards : (D, T_rows, cap) bool (False in padding rows)
    chunk_shards : (D, T_rows, C, 4) owner-local chunk boxes (None when
                   staged with ``local_index="off"``)
    probe_boxes  : (T, 4) *global* probe boxes: routing scans them
    chunk_boxes  : (T, C, 4) *global* chunk boxes, or None
    uni          : (4,) dataset universe
    owner, local : (T,) int32 host maps, global tile -> (owner, row)
    rep_owner, rep_local : (T,) int32 host maps of the hot tiles' second
                   copies (owner, row past ``t_local``), -1 where a tile
                   has none; None without replicas (``replicate_top``
                   of 0)

    The four shard arrays are contiguous, so ``(D·T_rows, ...)`` is a
    free view of each (``exchange.Shards``).
    """

    canon_shards: torch.Tensor
    id_shards: torch.Tensor
    alive_shards: torch.Tensor
    chunk_shards: torch.Tensor | None
    probe_boxes: torch.Tensor
    chunk_boxes: torch.Tensor | None
    uni: torch.Tensor
    owner: np.ndarray
    local: np.ndarray
    rep_owner: np.ndarray | None = None
    rep_local: np.ndarray | None = None


def _scatter_shards(canon: torch.Tensor, ids: torch.Tensor,
                    alive: torch.Tensor, chunk: torch.Tensor | None,
                    owner: np.ndarray, local: np.ndarray, tiles: np.ndarray,
                    t_rows: int, d: int, rank: int | None = None):
    """The global staging's rows gathered into ``(D, t_rows, ...)``
    shards on its own device: shard row ``owner[i]·t_rows + local[i]``
    reads global tile ``tiles[i]`` (a hot tile twice: its primary and
    its replica row); padding rows get the sentinel box, id -1 and
    ``alive`` False (and sentinel chunk boxes).  With ``rank`` only
    that owner's ``(1, t_rows, ...)`` shard is built.  No host round
    trip: at 8 M objects that would move about 5.8 GB each way."""
    dev = ids.device
    if rank is not None:
        mine = owner == rank
        local, tiles, d = local[mine], tiles[mine], 1
        owner = np.zeros(local.shape[0], np.int64)
    src = np.full(d * t_rows, -1, np.int64)
    src[owner.astype(np.int64) * t_rows + local] = tiles
    src_t = torch.from_numpy(src).to(dev)
    pad = src_t < 0
    take = src_t.clamp_min(0)

    def gather(a, fill):
        out = a.index_select(0, take)
        out[pad] = torch.as_tensor(fill, dtype=a.dtype, device=dev)
        return out.view((d, t_rows) + tuple(a.shape[1:]))

    sentinel = geometry.sentinel(dev)
    return (gather(canon, sentinel), gather(ids, -1), gather(alive, False),
            None if chunk is None else gather(chunk, sentinel))


def _plan_replicas(owner: np.ndarray, score: np.ndarray, t_local: int,
                   d: int, replicate_top: int,
                   cooc: np.ndarray | None = None):
    """Place one replica of each of the ``replicate_top`` hottest tiles
    on a second owner (the reference's host planner, copied as it is).
    Replica rows occupy shard rows past ``t_local``; each owner hosts at
    most ``replicate_top`` replicas, so its row budget is exactly
    ``t_local + replicate_top``.  Targets go greedily by descending tile
    score.  With ``cooc``, the target is the non-primary owner holding
    the most co-occurring traffic (primary tiles plus replicas already
    placed); without it (or when no co-occurrence reaches another
    owner), the least score-loaded owner, loads adjusted as if the
    replica takes half the tile's traffic.  Deterministic.
    -> ``(rep_owner[T], rep_local[T])`` int32, -1 where no replica."""
    t = owner.shape[0]
    rep_owner = np.full(t, -1, np.int32)
    rep_local = np.full(t, -1, np.int32)
    hot = np.argsort(-score, kind="stable")[:min(replicate_top, t)]
    dev_load = np.zeros(d, np.float64)
    np.add.at(dev_load, owner, score)
    rep_count = np.zeros(d, np.int64)
    aff = None
    if cooc is not None:
        w = np.asarray(cooc, np.float64)
        w = w + w.T
        np.fill_diagonal(w, 0.0)
        onehot = np.zeros((t, d), np.float64)
        onehot[np.arange(t), owner] = 1.0
        aff = w @ onehot            # (t, d) co-traffic per owner
    for tt in hot.tolist():
        open_ = [dv for dv in range(d)
                 if dv != owner[tt] and rep_count[dv] < replicate_top]
        if not open_:
            continue
        if aff is not None and max(aff[tt, dv] for dv in open_) > 0:
            dv = max(open_, key=lambda x: (aff[tt, x], -dev_load[x], -x))
        else:
            dv = min(open_, key=lambda x: (dev_load[x], x))
        rep_owner[tt] = dv
        rep_local[tt] = t_local + rep_count[dv]
        rep_count[dv] += 1
        dev_load[dv] += 0.5 * score[tt]
        dev_load[owner[tt]] -= 0.5 * score[tt]
        if aff is not None:
            aff[:, dv] += w[:, tt]  # the replica is now resident on dv
    return rep_owner, rep_local


@dataclasses.dataclass(frozen=True)
class _ShardPlan:
    """The host placement of one sharding: primaries (``owner``,
    ``local``, ``t_local`` rows an owner), the replicas (``rep_owner``,
    ``rep_local`` or None), every resident row (``owner_all``,
    ``local_all`` reading global tile ``tiles_all``), ``t_rows`` rows an
    owner and the planner's stats."""

    owner: np.ndarray
    local: np.ndarray
    t_local: int
    rep_owner: np.ndarray | None
    rep_local: np.ndarray | None
    owner_all: np.ndarray
    local_all: np.ndarray
    tiles_all: np.ndarray
    t_rows: int
    n_rep: int
    pstats: dict


def _plan_shards(member_counts: np.ndarray, d: int, prev_owner, cooc, heat,
                 replicate_top: int) -> _ShardPlan:
    """Capped LPT on the member counts (co-locating on ``cooc``), then
    the replicas of the hottest tiles: host work, the same on every
    rank of a mesh."""
    if d == 1:
        replicate_top = 0      # a second owner needs a second device
    owner, local, t_local, pstats = placement.shard_tiles(
        member_counts, d, prev_owner=prev_owner, cooc=cooc)
    t = owner.shape[0]
    rep_owner = rep_local = None
    t_rows, n_rep = t_local, 0
    owner_all, local_all, tiles_all = owner, local, np.arange(t)
    if replicate_top > 0:
        score = member_counts
        if heat is not None and np.any(np.asarray(heat) > 0):
            score = np.asarray(heat, np.float64)
        rep_owner, rep_local = _plan_replicas(owner, score, t_local, d,
                                              int(replicate_top), cooc=cooc)
        t_rows = t_local + int(replicate_top)
        reps = np.flatnonzero(rep_owner >= 0)
        n_rep = int(reps.size)
        owner_all = np.concatenate([owner, rep_owner[reps]])
        local_all = np.concatenate([local, rep_local[reps]])
        tiles_all = np.concatenate([tiles_all, reps])
    return _ShardPlan(owner, local, t_local, rep_owner, rep_local, owner_all,
                      local_all, tiles_all, t_rows, n_rep, pstats)


def _sharded_result(plan: _ShardPlan, stats: dict, d: int, shards: tuple,
                    probe_boxes, chunk_boxes, uni
                    ) -> tuple["ShardedLayout", dict]:
    """The ``ShardedLayout`` of ``plan`` over the built ``shards``
    (canon, ids, alive, chunk) and its stats (``shard_bytes`` is one
    owner's, whether ``shards`` hold every owner or one)."""
    canon_sh, id_sh, alive_sh, chunk_sh = shards
    slayout = ShardedLayout(canon_shards=canon_sh, id_shards=id_sh,
                            alive_shards=alive_sh, chunk_shards=chunk_sh,
                            probe_boxes=probe_boxes, chunk_boxes=chunk_boxes,
                            uni=uni, owner=plan.owner, local=plan.local,
                            rep_owner=plan.rep_owner,
                            rep_local=plan.rep_local)
    pstats = plan.pstats
    stats = dict(stats, shards=d, t_local=plan.t_local,
                 shard_bytes=sum(_nbytes(a) for a in (canon_sh, id_sh,
                                                      alive_sh))
                 // canon_sh.shape[0],
                 placement_skew=pstats["skew"], replicated_tiles=plan.n_rep)
    for key in ("cut_before", "cut_after"):
        if key in pstats:
            stats[key] = pstats[key]
    if "moved" in pstats:
        stats["moved_tiles"] = pstats["moved"]
    return slayout, stats


def shard_staged(layout: StagedLayout, stats: dict, n_shards: int,
                 mesh=None, prev_owner: np.ndarray | None = None,
                 cooc: np.ndarray | None = None,
                 heat: np.ndarray | None = None, replicate_top: int = 0,
                 timings: dict | None = None
                 ) -> tuple[ShardedLayout, dict]:
    """Shard a staged layout's tiles across ``n_shards`` owners.

    Placement is capped LPT on per-tile member counts
    (``core.placement.shard_tiles``): no owner holds more than
    ``ceil(T/D)`` tiles, so each owner's shard is at most one tile over
    an even split.  ``prev_owner`` (a re-stage or a rebalance) adds the
    moved-tile count to the stats; ``cooc`` switches to the co-locating
    planner (``placement.colocate_tiles``, seeded from ``prev_owner``).
    ``replicate_top > 0`` adds one bit-exact replica of each of the
    hottest tiles (ranked by ``heat`` when any value is above 0, by
    member counts otherwise) in the shard rows past ``t_local``: every
    owner has exactly ``t_local + replicate_top`` rows however many
    replicas place (``d == 1`` places none).  The replica rows are
    gathered from the staging on the device like the primaries.
    Under a ``mesh`` (``launch.mesh.ProcessMesh``) only the rank's own
    shard is built, ``(1, T_rows, ...)``: its primaries and the replicas
    placed on it.  ``timings``, when given, receives the host planning
    and the device gather seconds (``plan_s``, ``scatter_s``).
    -> ``(ShardedLayout, stats)``.  The reference also returns a host
    copy of the unsharded staging for its dense oracle; the port
    rebuilds that oracle on the device from the shards
    (``ShardedTiles._oracle``).
    """
    t0 = time.perf_counter()
    d = max(1, int(n_shards))
    member_counts = ((layout.ids >= 0).sum(1).cpu().numpy()
                     .astype(np.float64))
    plan = _plan_shards(member_counts, d, prev_owner, cooc, heat,
                        replicate_top)
    t1 = time.perf_counter()
    shards = _scatter_shards(
        layout.canon_tiles, layout.ids, layout.alive, layout.chunk_boxes,
        plan.owner_all, plan.local_all, plan.tiles_all, plan.t_rows, d,
        None if mesh is None else mesh.rank)
    if timings is not None:
        _sync(shards[1].device)
        timings.update(plan_s=t1 - t0, scatter_s=time.perf_counter() - t1)
    return _sharded_result(plan, stats, d, shards, layout.probe_boxes,
                           layout.chunk_boxes, layout.uni)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# query packing (host): fan-out-weighted LPT onto home devices
# --------------------------------------------------------------------------

def pack_queries(costs: np.ndarray, n_devices: int
                 ) -> tuple[np.ndarray, dict]:
    """LPT-pack queries onto devices by per-query cost.

    costs: (Q,) (routed fan-out on the pruned path) -> ``(slots[D, Qpd]
    int32 query indices, stats)``, -1 slots padding; Qpd is the largest
    group.  An all-zero cost vector falls back to uniform costs, so
    queries still spread instead of piling onto device 0.
    """
    d = max(1, n_devices)
    costs = np.asarray(costs).astype(np.float64)
    if costs.size and not np.any(costs > 0):
        costs = np.ones_like(costs)
    dev, makespan, mean_load = placement.lpt_pack(costs, d)
    groups = [np.flatnonzero(dev == i) for i in range(d)]
    qpd = max(1, max(len(g) for g in groups))
    slots = np.full((d, qpd), -1, np.int32)
    for i, g in enumerate(groups):
        slots[i, :len(g)] = g
    stats = dict(makespan=makespan, mean_load=mean_load,
                 skew=makespan / max(mean_load, 1e-9), qpd=qpd)
    return slots, stats


def _pack_rows(arr, slots: np.ndarray, pad):
    """Scatter per-query rows into the packed (D, Qpd, ...) slot grid,
    ``pad`` in the -1 slots.  A tensor stays on its device (numpy in,
    numpy out, as the reference)."""
    if isinstance(arr, torch.Tensor):
        s = torch.from_numpy(np.asarray(slots, np.int64)).to(arr.device)
        pad_t = torch.as_tensor(pad, dtype=arr.dtype, device=arr.device)
        out = pad_t.expand(tuple(s.shape) + tuple(pad_t.shape)).clone()
        live = s >= 0
        out[live] = arr[s[live]]
        return out
    a = np.asarray(arr)
    pad = np.asarray(pad, a.dtype)
    out = np.broadcast_to(pad, slots.shape + pad.shape).copy()
    live = slots >= 0
    out[live] = a[slots[live]]
    return out


def _unpack_rows(x, slots: np.ndarray, n_queries: int):
    """Invert ``_pack_rows``: (D, Qpd, ...) -> per-query rows in the
    batch's order (a tensor stays on its device)."""
    if isinstance(x, torch.Tensor):
        s = torch.from_numpy(np.asarray(slots, np.int64).ravel()).to(x.device)
        x = x.reshape((slots.size,) + tuple(x.shape[2:]))
        live = s >= 0
        res = torch.zeros((n_queries,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        res[s[live]] = x[live]
        return res
    x = np.asarray(x)
    x = x.reshape((slots.size,) + x.shape[2:])
    live = slots >= 0
    res = np.zeros((n_queries,) + x.shape[1:], x.dtype)
    res[slots[live]] = x[live.ravel()]
    return res


def _knn_cost_proxy(uni_np: np.ndarray, n: int, dist, k: int) -> np.ndarray:
    """LPT packing weight for a kNN batch: the tiles the first deepening
    box would touch, at the radius the executor starts from.  The
    diagonal is the reference's float64 ``np.linalg.norm`` cast to
    float32; the packing decides the exchange tables, so a one-ulp
    radius would change them."""
    diag = float(np.linalg.norm(uni_np[2:] - uni_np[:2]))
    r0 = float(knn_mod.initial_radius(
        torch.tensor(diag, dtype=torch.float32), k, n))
    return (1.0 + np.sum(_host_np(dist) <= r0, axis=1)).astype(np.float64)


# --------------------------------------------------------------------------
# the protocol
# --------------------------------------------------------------------------

@runtime_checkable
class TileLayout(Protocol):
    """What ``SpatialServer`` serves against: one contract, three
    placements (``ReplicatedTiles``, ``ShardedTiles``, ``HeatSharded``).

    ``mode`` names the routed executor in answer stats (``"pruned"``
    replicated, ``"sharded"`` and ``"heat"`` owner-routed).  The routed executors take
    the server's ``(Q, F)`` candidate lists and LPT cost vector;
    ``knn_attempt`` routes its own MINDIST frontier at width ``f`` and
    returns the excluded distance the exactness check needs; the
    ``dense_*`` trio is the all-tile oracle; ``append`` / ``delete`` /
    ``update`` / ``compact`` are the ingest lifecycle, mutating
    ``stats`` in place (the server shares the dict).
    """

    parts: api.Partitioning
    config: ServeConfig
    stats: dict
    mode: str
    shards: int

    @property
    def probe_boxes(self) -> torch.Tensor: ...

    @property
    def chunk_boxes(self) -> torch.Tensor | None: ...

    @property
    def uni(self) -> torch.Tensor: ...

    def resident_tile_bytes(self) -> int: ...

    def append(self, mbrs) -> dict: ...

    def delete(self, ids) -> dict: ...

    def update(self, ids, mbrs) -> dict: ...

    def compact(self) -> dict: ...

    def rebalance(self, heat=None, cooc=None) -> dict: ...

    def range_counts(self, qboxes, cand, costs): ...

    def range_ids(self, qboxes, cand, costs, max_hits: int): ...

    def knn_attempt(self, pts, k: int, max_cand: int, f: int): ...

    def dense_range_counts(self, qboxes): ...

    def dense_range_ids(self, qboxes, max_hits: int): ...

    def dense_knn(self, pts, k: int, max_cand: int): ...


class _Upload:
    """Host plan arrays -> device tensors, each array uploaded once (it
    is held meanwhile, so its ``id`` cannot be reused); ``nbytes``
    counts what went up."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.sent: dict[int, tuple[np.ndarray, torch.Tensor]] = {}

    def __call__(self, x: np.ndarray) -> torch.Tensor:
        if id(x) not in self.sent:
            self.sent[id(x)] = (x, torch.from_numpy(
                np.ascontiguousarray(x)).to(self.dev))
        return self.sent[id(x)][1]

    @property
    def nbytes(self) -> int:
        return int(sum(_nbytes(t) for _, t in self.sent.values()))


class _TilesBase:
    """The staging mirrors and the streaming ingest lifecycle, shared by
    both placements.

    Subclasses implement ``_install(layout)`` (build the resident
    arrays from a fresh ``StagedLayout``), ``_release()`` (drop them
    before a re-stage), ``_scatter(plan)`` (the O(M)
    device refresh of the cells and rows a plan names, returning the
    bytes uploaded), ``_device_arrays()`` (the resident staging as the
    unsharded ``(canon, ids, probe, chunk, alive, uni)`` tensors),
    ``_device_ids()`` (every resident row's ids) and ``device``.

    Ingest (``append``, ``delete``, ``update``, ``compact``) is the
    reference's lifecycle: host numpy mirrors of the staging are the
    source of truth, each mutation emits a *scatter plan* of the cells
    and rows it touched, and ``_scatter`` writes exactly those into the
    resident arrays with ``index_put_``.  The mirrors are built from
    the device at the first mutation (about 6 GB of host memory at 8 M
    objects, which a server that never ingests never pays) and dropped
    on re-stage.  Each placement keeps a live extent a resident row in
    step with ``alive``: it rises to cover every slot a plan writes
    alive, stays on tombstones (a larger extent is still exact), and is
    recomputed for compacted rows and on every install.

    A scatter plan is a dict of optional entries, all host numpy:

    - ``"boxes"`` / ``"ids"`` / ``"alive"``: ``((K, 2) [tile, slot]
      cells, (K, ...) values)`` into canon_tiles / ids / alive;
    - ``"probe"``: ``((P,) rows, (P, 4) boxes)``;
    - ``"chunk"``: ``((C, 2) [tile, chunk] cells, (C, 4) boxes)``;
    - ``"uni"``: ``(4,)`` replacement universe;
    - ``"rows"``: compaction's full-row rewrites, ``dict(rows, boxes,
      ids, alive, probe, chunk)`` with leading dim R.
    """

    mode = "base"
    shards = 1

    def __init__(self, parts: api.Partitioning, layout: StagedLayout,
                 stats: dict, config: ServeConfig, mesh=None):
        self.parts = parts
        self.config = config
        self.mesh = mesh            # a launch.mesh.ProcessMesh, or None
        self.n_devices = 1 if mesh is None else mesh.size
        self.stats = dict(stats, placement=config.placement,
                          probe=config.probe, restages=0, compactions=0,
                          n_total=stats["n"])
        # the running id numbering: never decremented (deleted ids stay
        # burned, appends continue past them)
        self._n_total = stats["n"]
        self._canon_np = None        # no host mirrors until a mutation
        self._install(layout)

    # -- host mirrors (the ingest path's source of truth) ---------------

    def _ensure_mirror(self) -> None:
        """Build the host mirrors and their bookkeeping from the device
        staging (the reference's ``_mirror``), unless they exist.  They
        are missing only while the staging is fresh (constructed or
        re-staged, untouched since), so canonical equals alive and the
        ids absent from the staging are exactly the deleted ones."""
        if self._canon_np is not None:
            return
        canon, ids, probe, chunk, alive, uni = self._device_arrays()
        self._canon_np = _to_host(canon)
        self._ids_np = _to_host(ids)
        self._probe_np = _to_host(probe)
        self._chunk_np = None if chunk is None else _to_host(chunk)
        self._alive_np = _to_host(alive)
        self._uni_np = _to_host(uni)
        t = self._ids_np.shape[0]
        self._fill = (self._ids_np >= 0).sum(axis=1).astype(np.int64)
        # per-tile dead canonical slots (the compaction trigger) and
        # their free lists, which inserts refill before fresh slack
        self._dead = np.zeros(t, np.int64)
        self._free: dict[int, list[int]] = {}
        self._n_free = np.zeros(t, np.int64)
        # id -> canonical (tile, slot), and which ids are live
        tt, ss = np.nonzero(self._canon_np[..., 0] < 1e9)
        idv = self._ids_np[tt, ss]
        self._canon_slot = np.full((self._n_total, 2), -1, np.int64)
        self._canon_slot[idv, 0] = tt
        self._canon_slot[idv, 1] = ss
        self._live_np = np.zeros(self._n_total, bool)
        self._live_np[idv] = True
        # the slack a re-stage re-reserves: the configured value, or the
        # headroom an explicit capacity carried over the hottest tile
        self._eff_slack = max(self.config.slack,
                              int(self.stats["cap"] - self._fill.max()))

    def _drop_mirror(self) -> None:
        for name in _MIRRORS:
            self.__dict__.pop(name, None)
        self._canon_np = None

    def _t_live(self) -> int:
        return int((self._probe_np[:, 0] <= self._probe_np[:, 2]).sum())

    def _free_slots_min(self) -> int:
        """The tightest tile's remaining slack (read off the device
        staging when a re-stage has just dropped the mirrors)."""
        if self._canon_np is None:
            fill = self._device_fill_max()
        else:
            fill = int(self._fill.max())
        return int(self.stats["cap"] - fill)

    def _device_fill_max(self) -> int:
        return int((self._device_ids() >= 0).sum(1).max())

    def _membership(self, new: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """MASJ membership with nearest-tile adoption of ``new`` on the
        staging device, as host (object, tile) pairs in object-major
        order: the nonzeros of the reference's (M, kmax) table."""
        dev = self.device
        obj, part = membership(self.parts, torch.from_numpy(new).to(dev))
        return obj.cpu().numpy(), part.cpu().numpy()

    # -- streaming lifecycle --------------------------------------------

    def append(self, mbrs) -> dict:
        """Insert new objects into the staged layout.

        mbrs: (M, 4) f32 MBRs (array-like or a tensor on any device);
        ids continue the running numbering.  Returns the reference's
        report: ``appended``, ``restaged`` (a tile overflowed and the
        layout was rebuilt at a grown capacity), ``n``, ``n_total``,
        ``cap``, ``bytes_transferred`` (the index and value tensors the
        scatter uploaded, or the live dataset a re-stage uploaded) and
        ``free_slots_min``.  Mutates ``stats`` in place.
        """
        new = _host_np(mbrs).astype(np.float32).reshape(-1, 4)
        m = new.shape[0]
        if m == 0:
            return dict(appended=0, restaged=False, n=self.stats["n"],
                        n_total=self._n_total, cap=self.stats["cap"],
                        bytes_transferred=0,
                        free_slots_min=self._free_slots_min())
        self._ensure_mirror()
        n_before = self.stats["n"]
        new_ids = np.arange(self._n_total, self._n_total + m, dtype=np.int32)
        self._n_total += m
        self._live_np = np.concatenate([self._live_np, np.ones(m, bool)])
        self._canon_slot = np.concatenate(
            [self._canon_slot, np.full((m, 2), -1, np.int64)])
        obj, part = self._membership(new)
        hits = np.bincount(part, minlength=self._fill.shape[0])
        need = self._fill + np.maximum(hits - self._n_free, 0)
        restaged = bool(need.max() > self.stats["cap"])
        if restaged:
            log.info("append overflow: %d tile(s) past capacity %d -- "
                     "re-staging %d objects",
                     int((need > self.stats["cap"]).sum()),
                     self.stats["cap"], n_before + m)
            # the re-stage sets n, t_live and replication from the new
            # staging (the reference's recount gives the same values)
            nbytes = self._restage(new, new_ids)
        else:
            nbytes = self._scatter(self._insert(new, obj, part, new_ids))
            self.stats["t_live"] = self._t_live()
            self.stats["replication"] = (float(self._fill.sum())
                                         / (n_before + m) - 1.0)
        self.stats["n"] = n_before + m
        self.stats["n_total"] = self._n_total
        return dict(appended=m, restaged=restaged, n=self.stats["n"],
                    n_total=self._n_total, cap=self.stats["cap"],
                    bytes_transferred=nbytes,
                    free_slots_min=self._free_slots_min())

    def delete(self, ids) -> dict:
        """Tombstone-delete objects by id: flip their canonical slots'
        alive bits (box data stays, so probe and chunk boxes remain
        exact supersets).  Raises ``ValueError`` naming the offending
        ids on an unknown id, an id repeated in the batch, or an
        already-deleted id.  Returns a report (``deleted``,
        ``compacted_tiles``, ``restaged``, ``dead_frac``,
        ``bytes_transferred``, ``n``, ``n_total``) and mutates
        ``stats`` in place."""
        req = _host_np(ids).reshape(-1).astype(np.int64)
        m = int(req.size)
        report = dict(deleted=m, restaged=False, compacted_tiles=0)
        self._ensure_mirror()
        if m == 0:
            return self._maintain({}, report)
        self._check_ids(req, "delete")
        ts = self._canon_slot[req]
        self._alive_np[ts[:, 0], ts[:, 1]] = False
        self._live_np[req] = False
        np.add.at(self._dead, ts[:, 0], 1)
        self._add_free(ts)
        self.stats["n"] -= m
        return self._maintain({"alive": (ts.copy(), np.zeros(m, bool))},
                              report)

    def update(self, ids, mbrs) -> dict:
        """Move objects: tombstone each id's canonical slot, then
        slack-insert its new MBR under the same id.  The id contract of
        ``delete`` applies; a tile overflow re-stages as ``append``
        does.  Returns a report and mutates ``stats`` in place."""
        req = _host_np(ids).reshape(-1).astype(np.int64)
        new = _host_np(mbrs).astype(np.float32).reshape(-1, 4)
        if int(req.size) != new.shape[0]:
            raise ValueError("update ids/mbrs length mismatch: "
                             f"{int(req.size)} ids, {new.shape[0]} MBRs")
        m = int(req.size)
        report = dict(updated=m, restaged=False, compacted_tiles=0)
        self._ensure_mirror()
        if m == 0:
            return self._maintain({}, report)
        self._check_ids(req, "update")
        ts = self._canon_slot[req]
        self._alive_np[ts[:, 0], ts[:, 1]] = False
        np.add.at(self._dead, ts[:, 0], 1)
        plan = {"alive": (ts.copy(), np.zeros(m, bool))}
        obj, part = self._membership(new)
        hits = np.bincount(part, minlength=self._fill.shape[0])
        need = self._fill + np.maximum(hits - self._n_free, 0)
        if bool(need.max() > self.stats["cap"]):
            log.info("update overflow: re-staging %d objects",
                     self.stats["n"])
            nbytes = self._restage(new, req.astype(np.int32))
            report.update(restaged=True, dead_frac=0.0, n=self.stats["n"],
                          n_total=self._n_total, bytes_transferred=nbytes)
            return report
        plan = _merge_plans(plan, self._insert(new, obj, part,
                                               req.astype(np.int32)))
        # slots tombstoned by this call open for reuse only now: the
        # insert above must not target them, or its cells would collide
        # with the tombstone writes in one scatter
        self._add_free(ts)
        return self._maintain(plan, report)

    def compact(self) -> dict:
        """Compact every tile holding dead slots, whatever
        ``config.compact_dead_frac`` says (the threshold-triggered path
        runs inside ``delete`` and ``update``)."""
        self._ensure_mirror()
        report = dict(restaged=False, compacted_tiles=0)
        tl = np.flatnonzero(self._dead > 0)
        plan: dict = {}
        if tl.size:
            plan = self._compact_tiles(tl, plan)
            report["compacted_tiles"] = int(tl.size)
            self.stats["compactions"] += int(tl.size)
        nbytes = self._scatter(plan)
        self.stats["t_live"] = self._t_live()
        report.update(n=self.stats["n"], n_total=self._n_total,
                      dead_frac=0.0, bytes_transferred=nbytes)
        return report

    def rebalance(self, heat=None, cooc=None) -> dict:
        """Replicated tiles have no owners to move: a no-op report (the
        sharded placement overrides it)."""
        return dict(placement=self.config.placement, moved_tiles=0,
                    replicated_tiles=0, bytes_transferred=0)

    def _add_free(self, ts: np.ndarray) -> None:
        """Open tombstoned canonical (tile, slot) cells for reuse by
        inserts (``_insert`` drains each list ascending,
        ``_compact_tiles`` voids it)."""
        order = np.argsort(ts[:, 0], kind="stable")
        tiles, first = np.unique(ts[order, 0], return_index=True)
        for t, slots in zip(tiles.tolist(),
                            np.split(ts[order, 1], first[1:])):
            self._free.setdefault(t, []).extend(slots.tolist())
        np.add.at(self._n_free, ts[:, 0], 1)

    def _check_ids(self, req: np.ndarray, verb: str) -> None:
        bad = np.unique(req[(req < 0) | (req >= self._n_total)])
        if bad.size:
            raise ValueError(
                f"{verb} of unknown id(s): {_fmt_ids(bad)} — known ids "
                f"are 0..{self._n_total - 1}")
        uniq, cnt = np.unique(req, return_counts=True)
        dup = uniq[cnt > 1]
        if dup.size:
            raise ValueError(
                f"{verb} batch repeats id(s): {_fmt_ids(dup)}")
        dead = np.unique(req[~self._live_np[req]])
        if dead.size:
            raise ValueError(
                f"{verb} of already-deleted id(s): {_fmt_ids(dead)}")

    def _maintain(self, plan: dict, report: dict) -> dict:
        """Apply the compaction policy to a finished mutation, then
        push its plan: a global dead fraction at
        ``config.restage_dead_frac`` re-stages the live set; otherwise
        tiles whose dead fraction reaches ``config.compact_dead_frac``
        are compacted and ride along as full-row rewrites."""
        cfg = self.config
        total_dead = int(self._dead.sum())
        dead_frac = total_dead / max(total_dead + self.stats["n"], 1)
        if (cfg.restage_dead_frac is not None and total_dead
                and self.stats["n"] > 0
                and dead_frac >= cfg.restage_dead_frac):
            nbytes = self._restage(None, None)
            report.update(restaged=True, dead_frac=0.0,
                          n=self.stats["n"], n_total=self._n_total,
                          bytes_transferred=nbytes)
            return report
        if cfg.compact_dead_frac is not None and total_dead:
            frac = self._dead / np.maximum(self._fill, 1)
            tl = np.flatnonzero((self._dead > 0)
                                & (frac >= cfg.compact_dead_frac))
            if tl.size:
                plan = self._compact_tiles(tl, plan)
                report["compacted_tiles"] = int(tl.size)
                self.stats["compactions"] += int(tl.size)
        nbytes = self._scatter(plan)
        self.stats["t_live"] = self._t_live()
        total_dead = int(self._dead.sum())
        report.update(
            n=self.stats["n"], n_total=self._n_total,
            dead_frac=total_dead / max(total_dead + self.stats["n"], 1),
            bytes_transferred=nbytes)
        return report

    def _insert(self, new: np.ndarray, oi: np.ndarray, ti: np.ndarray,
                new_ids: np.ndarray) -> dict:
        """Slack insert into the host mirrors: each new object lands in
        every member tile's next free slot, its canonical copy in its
        lowest member tile (``stage_tiles``' first-copy rule), and the
        probe and chunk boxes union the new canonical MBRs.  A tile's
        first ``n_free`` insertions refill its tombstoned slots in
        ascending slot order; the rest extend its fill prefix.

        ``(oi, ti)`` are the membership pairs in object-major order.  A
        pair's rank within its tile (the reference's running cumsum over
        its (M, T) table) is its position after a stable sort by tile.
        Returns the scatter plan of the touched cells."""
        n_tiles = self._fill.shape[0]
        hits = np.bincount(ti, minlength=n_tiles)
        by_tile = np.argsort(ti, kind="stable")
        start = np.cumsum(hits) - hits
        r = np.empty(ti.shape[0], np.int64)
        r[by_tile] = np.arange(ti.shape[0]) - start[ti[by_tile]]
        nf0 = self._n_free[ti]
        reuse = r < nf0
        s = self._fill[ti] + (r - nf0)
        used = np.zeros(n_tiles, np.int64)
        if reuse.any():
            # reusing pairs by tile, ranks 0..k-1 in order: ascending
            # rank takes ascending free slot
            rb = by_tile[reuse[by_tile]]
            tiles, first, k = np.unique(ti[rb], return_index=True,
                                        return_counts=True)
            for t, a, kt in zip(tiles.tolist(), first.tolist(), k.tolist()):
                free = sorted(self._free[t])
                s[rb[a:a + kt]] = free[:kt]
                self._free[t] = free[kt:]
            used = np.bincount(ti[rb], minlength=n_tiles)
            self._n_free -= used
            self._dead -= used
        ids_v = new_ids[oi].astype(np.int32)
        self._ids_np[ti, s] = ids_v
        first = np.r_[True, oi[1:] != oi[:-1]]     # lowest member tile
        boxes_v = np.where(first[:, None], new[oi],
                           _SENTINEL[None, :]).astype(np.float32)
        self._canon_np[ti, s] = boxes_v
        self._alive_np[ti, s] = first
        tc, sc, boxes = ti[first], s[first], new[oi[first]]
        self._canon_slot[ids_v[first], 0] = tc
        self._canon_slot[ids_v[first], 1] = sc
        self._live_np[ids_v[first]] = True
        for c, ufunc in enumerate((np.minimum, np.minimum,
                                   np.maximum, np.maximum)):
            ufunc.at(self._probe_np[:, c], tc, boxes[:, c])
            if self._chunk_np is not None:
                ufunc.at(self._chunk_np[:, :, c], (tc, sc // rops.CHUNK),
                         boxes[:, c])
        self._fill += hits - used          # reused slots were filled
        self._uni_np = np.concatenate(
            [np.minimum(self._uni_np[:2], new[:, :2].min(axis=0)),
             np.maximum(self._uni_np[2:], new[:, 2:].max(axis=0))]
        ).astype(np.float32)
        cells = np.stack([ti, s], axis=1)
        prows = np.unique(tc)
        plan = {
            "boxes": (cells, boxes_v),
            "ids": (cells, ids_v),
            "alive": (cells, first.copy()),
            "probe": (prows, self._probe_np[prows].copy()),
            "uni": self._uni_np,
        }
        if self._chunk_np is not None:
            ccells = np.unique(np.stack([tc, sc // rops.CHUNK], axis=1),
                               axis=0)
            plan["chunk"] = (ccells, self._chunk_np[ccells[:, 0],
                                                    ccells[:, 1]].copy())
        return plan

    def _hilbert_order(self, rows: list[tuple[int, np.ndarray]]
                       ) -> list[np.ndarray]:
        """Each (tile, canonical slots) pair's slots in stable ascending
        Hilbert key of their MBR centre over the current universe: one
        encode over every tile's centres, on the staging device."""
        sizes = [c.size for _, c in rows]
        if not sum(sizes):
            return [c for _, c in rows]
        b = np.concatenate([self._canon_np[t, c] for t, c in rows])
        dev = self.device
        keys = hilbert_ops.hilbert_keys(
            torch.from_numpy((b[:, :2] + b[:, 2:]) * 0.5).to(dev),
            torch.from_numpy(self._uni_np).to(dev)).cpu().numpy()
        parts = np.split(keys, np.cumsum(sizes)[:-1])
        return [c[np.argsort(k, kind="stable")]
                for (_, c), k in zip(rows, parts)]

    def _compact_tiles(self, tl: np.ndarray, plan: dict) -> dict:
        """Tile-local slot reclamation: rebuild each tile from its live
        members, the alive canonical slots first in local sort order,
        then the non-canonical copies of still-live ids; dead slots and
        copies of dead ids go.  Probe rows and chunk boxes tighten to
        the surviving canonical members.  Mutates the mirrors and adds
        one full-row rewrite a tile to ``plan``."""
        cap = self._ids_np.shape[1]
        mode = self.config.local_index
        keep = []
        for t in tl.tolist():
            ids_row = self._ids_np[t]
            occ = ids_row >= 0
            cmask = self._canon_np[t, :, 0] < 1e9
            live_id = np.zeros(cap, bool)
            live_id[occ] = self._live_np[ids_row[occ]]
            cidx = np.flatnonzero(self._alive_np[t])
            if cidx.size and mode == "x":
                cidx = cidx[np.argsort(self._canon_np[t, cidx, 0],
                                       kind="stable")]
            keep.append((t, cidx, np.flatnonzero(occ & ~cmask & live_id)))
        if mode == "hilbert":
            order = self._hilbert_order([(t, c) for t, c, _ in keep])
            keep = [(t, c, nc) for (t, _, nc), c in zip(keep, order)]
        for t, cidx, ncidx in keep:
            ids_row = self._ids_np[t]
            nk, nc = cidx.size, ncidx.size
            new_ids = np.full(cap, -1, np.int32)
            new_canon = np.broadcast_to(_SENTINEL, (cap, 4)).copy()
            new_ids[:nk] = ids_row[cidx]
            new_ids[nk:nk + nc] = ids_row[ncidx]
            new_canon[:nk] = self._canon_np[t, cidx]
            self._ids_np[t] = new_ids
            self._canon_np[t] = new_canon
            self._alive_np[t] = np.arange(cap) < nk
            self._canon_slot[new_ids[:nk], 0] = t
            self._canon_slot[new_ids[:nk], 1] = np.arange(nk)
            self._fill[t] = nk + nc
            self._dead[t] = 0
            self._free.pop(t, None)     # slots re-packed: stale offsets
            self._n_free[t] = 0
            self._probe_np[t] = (np.concatenate(
                [new_canon[:nk, :2].min(axis=0),
                 new_canon[:nk, 2:].max(axis=0)]) if nk else _SENTINEL)
        rows = np.asarray(tl, np.int64)
        boxes = self._canon_np[rows]
        if self._chunk_np is not None:
            self._chunk_np[rows] = self._chunk_rows(boxes)
        plan = dict(plan)
        plan["rows"] = dict(
            rows=rows, boxes=boxes, ids=self._ids_np[rows],
            alive=self._alive_np[rows], probe=self._probe_np[rows],
            chunk=None if self._chunk_np is None else self._chunk_np[rows])
        return plan

    def _chunk_rows(self, canon: np.ndarray) -> np.ndarray:
        """(R, cap, 4) canonical rows -> their (R, C, 4) chunk boxes (the
        numpy mirror of ``_chunk_summary``; min and max are exact, so
        reducing along the contiguous slot axis gives the same bits)."""
        chunk = self.config.chunk
        r, cap, _ = canon.shape
        g = -(-cap // chunk)
        ct = np.empty((4, r, g * chunk), np.float32)
        ct[:, :, cap:] = _SENTINEL[:, None, None]
        ct[:, :, :cap] = canon.transpose(2, 0, 1)
        ct = ct.reshape(4, r, g, chunk)
        boxes = np.concatenate([ct[:2].min(axis=3), ct[2:].max(axis=3)])
        c128 = -(-cap // rops.CHUNK)
        return np.repeat(boxes.transpose(1, 2, 0), chunk // rops.CHUNK,
                         axis=1)[:, :c128]

    def _dataset_np(self) -> tuple[np.ndarray, np.ndarray]:
        """The live dataset ``(boxes, ids)`` off the alive slots (every
        live object has exactly one alive canonical slot)."""
        live = self._alive_np
        return (self._canon_np[live].astype(np.float32),
                self._ids_np[live].astype(np.int32))

    def _restage(self, extra: np.ndarray | None,
                 extra_ids: np.ndarray | None = None) -> int:
        """Re-stage the live dataset plus the not-yet-inserted ``extra``
        batch on the device at a fresh capacity (the max tile count
        plus the effective slack), install it and drop the mirrors.
        Reclaims every tombstoned slot, canonical and copies.  The
        resident arrays are released first (the mirrors hold the data):
        staging at a grown capacity takes several times the staging in
        temporaries, and the card then holds one staging at a time.
        Under a mesh the ranks stage in turns (``launch.mesh.in_turns``),
        each keeping its own rows.  Returns the bytes of the dataset
        uploaded."""
        boxes, ids = self._dataset_np()
        if extra is not None and len(extra):
            boxes = np.concatenate([boxes, extra], axis=0)
            ids = np.concatenate([ids, np.asarray(extra_ids, np.int32)])
        dev = self.device
        cfg = self.config.replace(capacity=None, slack=self._eff_slack)
        self._release()
        self._drop_mirror()

        def stage():
            layout, stats = stage_tiles(
                self.parts, torch.from_numpy(boxes).to(dev), cfg,
                ids=torch.from_numpy(ids).to(dev))
            for key in ("n", "t", "cap", "t_live", "chunks", "replication"):
                self.stats[key] = stats[key]
            self._install(layout)

        mesh_lib.in_turns(self.mesh, stage)
        self.stats["restages"] += 1
        return int(boxes.nbytes + ids.nbytes)

    @property
    def uni(self) -> torch.Tensor:
        return self._device_arrays()[5]


class ReplicatedTiles(_TilesBase):
    """The full staging on the device (on every rank of a mesh); only
    queries vary.

    Each routed batch probes its candidate tiles with the gathered
    kernels (chunk-skipping when the staging carries a local index);
    the dense oracle probes every tile with the dense kernels.  Every
    probe passes the alive mask and its live extent (``extent``, one a
    tile).  Stats dicts equal the reference's with ``mesh=None``; under
    a mesh each batch is query-sharded (``_per_rank``) and the stats
    are the reference's LPT packing stats, as its mesh step's.
    """

    mode = "pruned"

    def _install(self, layout: StagedLayout) -> None:
        # the executors read canonical data only: drop the all-copies
        # member tiles instead of keeping (T, cap, 4) bytes resident
        self.staged = dataclasses.replace(layout, tiles=None)
        # (T,) int32 live extent of the alive mask: the routed and dense
        # count and hit-list kernels stop each tile's walk there
        self.extent = rops.live_extent(layout.alive)

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

    @property
    def device(self) -> torch.device:
        return self.staged.ids.device

    @property
    def uni(self) -> torch.Tensor:
        return self.staged.uni

    def _device_arrays(self):
        lay = self.staged
        return (lay.canon_tiles, lay.ids, lay.probe_boxes, lay.chunk_boxes,
                lay.alive, lay.uni)

    def _device_ids(self) -> torch.Tensor:
        return self.staged.ids

    def _release(self) -> None:
        self.staged = self.extent = None

    def _scatter(self, plan: dict) -> int:
        """O(M) device refresh: ``index_put_`` the plan's cells and rows
        into the resident staging, and keep the live extent in step with
        ``alive``.  Returns the bytes of the index and value tensors
        uploaded (each array once)."""
        if not plan:
            return 0
        lay = self.staged
        put = _Upload(lay.ids.device)

        def cells(key):
            idx, vals = plan[key]
            c = put(idx)
            return (c[:, 0], c[:, 1]), put(vals)

        if "boxes" in plan:
            lay.canon_tiles.index_put_(*cells("boxes"))
        if "ids" in plan:
            lay.ids.index_put_(*cells("ids"))
        if "alive" in plan:
            (t, s), v = cells("alive")
            lay.alive.index_put_((t, s), v)
            # the extent rises to cover each slot written alive; a
            # tombstone leaves it (a larger extent is still exact)
            self.extent.scatter_reduce_(0, t[v], (s[v] + 1).int(), "amax")
        if "probe" in plan:
            rows, vals = plan["probe"]
            lay.probe_boxes[put(rows)] = put(vals)
        if "chunk" in plan and lay.chunk_boxes is not None:
            lay.chunk_boxes.index_put_(*cells("chunk"))
        if "uni" in plan:
            lay.uni.copy_(put(plan["uni"]))
        if "rows" in plan:
            e = plan["rows"]
            rows = put(e["rows"])
            lay.canon_tiles[rows] = put(e["boxes"])
            lay.ids[rows] = put(e["ids"])
            lay.alive[rows] = put(e["alive"])
            lay.probe_boxes[rows] = put(e["probe"])
            if e["chunk"] is not None and lay.chunk_boxes is not None:
                lay.chunk_boxes[rows] = put(e["chunk"])
            # compaction re-packed these rows: recompute their extent
            self.extent[rows] = rops.live_extent(lay.alive[rows])
        return put.nbytes

    # -- query sharding ----------------------------------------------------

    def _per_rank(self, fn, qarrays: tuple, pads: tuple, costs):
        """Run ``fn(*per_query_arrays)`` -> tensor or tuple of tensors.

        Without a mesh: on the whole batch, stats ``skew=1.0``.  Under a
        mesh (the reference's query-sharded ``shard_map`` step): the
        batch is LPT-packed onto the ranks by ``costs``, each rank runs
        its row of the packing (``pads`` fill its empty slots), and an
        ``all_gather`` and ``_unpack_rows`` give every rank the whole
        answer; stats are the packing's."""
        if self.mesh is None:
            return fn(*qarrays), dict(skew=1.0)
        slots, pstats = pack_queries(costs, self.mesh.size)
        mine = slots[self.mesh.rank:self.mesh.rank + 1]
        out = fn(*(_pack_rows(a, mine, p)[0] for a, p in zip(qarrays, pads)))
        n_q = qarrays[0].shape[0]

        def back(x):
            return _unpack_rows(self.mesh.all_gather(x), slots, n_q)
        out = back(out) if isinstance(out, torch.Tensor) else tuple(
            back(x) for x in out)
        return out, pstats

    def _cand_pad(self, cand: torch.Tensor) -> torch.Tensor:
        return torch.full(cand.shape[1:], -1, dtype=cand.dtype,
                          device=cand.device)

    def _pad_pt(self) -> torch.Tensor:
        uni = self.staged.uni
        return (uni[:2] + uni[2:]) * 0.5

    # -- routed executors ------------------------------------------------

    def range_counts(self, qboxes, cand, costs):
        lay = self.staged
        return self._per_rank(
            lambda qb, cd: range_mod.pruned_range_counts(
                qb, lay.canon_tiles, cd, chunk_boxes=lay.chunk_boxes,
                alive=lay.alive, extent=self.extent),
            (qboxes, cand), (geometry.sentinel(qboxes.device),
                             self._cand_pad(cand)), costs)

    def range_ids(self, qboxes, cand, costs, max_hits: int):
        lay = self.staged
        (hit_ids, counts, overflow), stats = self._per_rank(
            lambda qb, cd: range_mod.pruned_range_ids(
                qb, lay.canon_tiles, lay.ids, cd, max_hits,
                chunk_boxes=lay.chunk_boxes, alive=lay.alive,
                extent=self.extent),
            (qboxes, cand), (geometry.sentinel(qboxes.device),
                             self._cand_pad(cand)), costs)
        return hit_ids, counts, overflow, stats

    def knn_attempt(self, pts, k: int, max_cand: int, f: int):
        """One pruned kNN pass at frontier width ``f`` -> ``(nn_ids,
        nn_d2, radius, overflow, excluded, stats)``."""
        lay = self.staged
        n_live = self.stats["n"]
        cand, dist, excl = router.candidate_knn(lay.probe_boxes, pts, f)
        costs = (None if self.mesh is None else
                 _knn_cost_proxy(_host_np(lay.uni), n_live, dist, k))
        (nn_ids, nn_d2, radius, overflow, rounds), stats = self._per_rank(
            lambda p, cd, ex: knn_mod.pruned_knn(
                p, k, lay.canon_tiles, lay.ids, lay.uni, cd, ex,
                max_cand=max_cand, n_live=n_live,
                chunk_boxes=lay.chunk_boxes, alive=lay.alive,
                extent=self.extent),
            (pts, cand, excl),
            (self._pad_pt(), self._cand_pad(cand),
             torch.tensor(np.inf, dtype=excl.dtype, device=excl.device)),
            costs)
        return nn_ids, nn_d2, radius, overflow, excl, dict(
            stats, rounds=_max_rounds(rounds))

    # -- dense oracle ----------------------------------------------------

    def dense_range_counts(self, qboxes):
        lay = self.staged
        return self._per_rank(
            lambda qb: range_mod.range_counts(qb, lay.canon_tiles, lay.alive,
                                              extent=self.extent),
            (qboxes,), (geometry.sentinel(qboxes.device),),
            np.ones(qboxes.shape[0], np.float64))

    def dense_range_ids(self, qboxes, max_hits: int):
        lay = self.staged
        (hit_ids, counts, overflow), stats = self._per_rank(
            lambda qb: range_mod.range_ids(qb, lay.canon_tiles, lay.ids,
                                           max_hits, lay.alive,
                                           extent=self.extent),
            (qboxes,), (geometry.sentinel(qboxes.device),),
            np.ones(qboxes.shape[0], np.float64))
        return hit_ids, counts, overflow, stats

    def dense_knn(self, pts, k: int, max_cand: int):
        lay = self.staged
        (nn_ids, nn_d2, _, overflow, rounds), stats = self._per_rank(
            lambda p: knn_mod.batched_knn(
                p, k, lay.canon_tiles, lay.ids, lay.uni, max_cand=max_cand,
                n_live=self.stats["n"], alive=lay.alive, extent=self.extent),
            (pts,), (self._pad_pt(),), np.ones(pts.shape[0], np.float64))
        return nn_ids, nn_d2, overflow, dict(rounds=_max_rounds(rounds),
                                             **stats)


class ShardedTiles(_TilesBase):
    """Tiles shard across ``config.shards`` owners; queries travel to
    them through the owner-routed exchange: the owners simulated on the
    one device (``mesh=None``), or one a rank of a process mesh.

    Staging shards by capped-LPT placement (``shard_staged``), built on
    the device from the staging, which is then dropped.  Each routed
    batch packs its queries onto home devices (``pack_queries``),
    translates their candidate lists into per-owner tables on the host
    (``router.owner_split``, timed into ``split_ms``) and runs one
    ``serve.exchange`` orchestration.  The live extent is kept a shard
    row (``extent``, ``(D, T_rows)``; ``(1, T_rows)`` on a rank).  The
    dense oracle probes an unsharded staging rebuilt on the device from
    the shards at its first call and dropped on every refresh; under a
    mesh each rank probes its own primary rows and the answers merge
    as the exchange's do (sum, union, top-k).  A streaming re-stage
    re-balances owners on the fresh member counts
    (``stats['moved_tiles']``) under the same ``ceil(T/D)`` bound;
    ``rebalance`` re-plans them on observed heat (co-locating tiles
    that share queries), moving rows between ranks under a mesh.
    Stats dicts equal the reference's with ``mesh=None``.
    """

    mode = "sharded"

    def __init__(self, parts: api.Partitioning, layout: StagedLayout,
                 stats: dict, config: ServeConfig, mesh=None):
        self.shards = 0        # set by the first _install
        self._owner = None     # the map a re-stage re-balances from
        self._heat = None      # last observed heat and co-occurrence
        self._cooc = None      # (rebalance feeds them; re-stages re-plan)
        self._comm = exchange._Comm(mesh)
        self.split_ms = 0.0    # owner_split's host ms, the last batch
        self.rebalance_s: dict = {}   # the last rebalance's split seconds
        super().__init__(parts, layout, stats, config, mesh)

    @property
    def _replicate_top(self) -> int:
        return 0               # HeatSharded budgets replica rows

    def _install(self, layout: StagedLayout,
                 timings: dict | None = None) -> None:
        cfg = self.config
        if not self.shards:
            self.shards = int(cfg.shards) if cfg.shards else self.n_devices
            if self.mesh is not None and self.shards != self.n_devices:
                raise ValueError(
                    "sharded serving places exactly one tile shard per "
                    f"mesh rank ({self.n_devices}), got shards="
                    f"{self.shards}")
        self._adopt(*shard_staged(
            layout, self.stats, self.shards, mesh=self.mesh,
            prev_owner=self._owner, cooc=self._cooc, heat=self._heat,
            replicate_top=self._replicate_top, timings=timings))

    def _adopt(self, slayout: ShardedLayout, stats: dict) -> None:
        """Take ``slayout`` as the resident shards: the stats, the row
        maps and the live extent."""
        self.slayout = slayout
        self._owner = slayout.owner
        for key in ("shards", "t_local", "shard_bytes", "placement_skew",
                    "moved_tiles", "replicated_tiles", "cut_before",
                    "cut_after"):
            if key in stats:
                self.stats[key] = stats[key]
        d, t_rows, cap = slayout.id_shards.shape
        dev = slayout.id_shards.device
        # global tile -> its primary flat shard row owner * T_rows + local
        # (under a mesh: its local row on this rank, -1 on another; the
        # dense oracle and a rebalance read the primaries)
        self._rows = torch.from_numpy(
            self._flat_rows(slayout.owner, slayout.local, t_rows)).to(dev)
        # global tile -> its replica's flat row, -1 where it has none
        self._rep_rows = None
        if slayout.rep_owner is not None:
            self._rep_rows = torch.from_numpy(self._flat_rows(
                slayout.rep_owner, slayout.rep_local, t_rows)).to(dev)
        # (D, T_rows) int32 live extent a shard row (0 in padding rows)
        self.extent = rops.live_extent(
            slayout.alive_shards.view(-1, cap)).view(d, t_rows)
        self._oracle_t = None

    def _flat_rows(self, owner: np.ndarray, local: np.ndarray,
                   t_rows: int) -> np.ndarray:
        """Tiles' resident rows in the flat shard view: ``owner·T_rows
        + local`` (``-1`` where owner is -1), or under a mesh ``local``
        where the owner is this rank and -1 elsewhere."""
        owner = owner.astype(np.int64)
        if self.mesh is None:
            return np.where(owner >= 0, owner * t_rows + local, -1)
        return np.where(owner == self.mesh.rank, local, -1).astype(np.int64)

    def rebalance(self, heat=None, cooc=None) -> dict:
        """Re-plan the owners on observed heat under traffic.

        ``heat``/``cooc`` (a ``HeatTracker.snapshot()``) replace the
        stored signals; the tile -> owner map is re-planned, co-locating
        on the co-occurrence graph and seeded from the current owners
        (only tiles whose move pays travel), the heat placement's
        replicas re-chosen, and the shards re-gathered.  Tile contents,
        ids, slots, probe and chunk boxes stay, so answers are the same
        bits before and after, and the shard shapes stay.  In-process
        the unsharded staging is rebuilt on the device from the primary
        rows (as the dense oracle's is) and the old shards released
        before the new ones are gathered: one staging and one set of
        shards at a time.  Under a mesh the rows move between ranks
        (``_move_rows``); no rank holds the whole staging.  Returns the
        reference's report; ``rebalance_s`` keeps the split seconds
        (``stage_s``, ``plan_s``, ``scatter_s``)."""
        if heat is not None:
            self._heat = np.asarray(heat, np.float64)
        if cooc is not None:
            self._cooc = np.asarray(cooc, np.float64)
        if self.mesh is not None:
            self._move_rows()
        else:
            t0 = time.perf_counter()
            s = self.slayout
            canon, ids, alive, _, _ = self._oracle()
            layout = StagedLayout(
                tiles=None, ids=ids, canon_tiles=canon, tile_boxes=None,
                probe_boxes=s.probe_boxes, chunk_boxes=s.chunk_boxes,
                alive=alive, uni=s.uni)
            del s, canon, ids, alive
            _sync(self.device)
            timings = dict(stage_s=time.perf_counter() - t0)
            self._release()
            self._install(layout, timings)
            del layout
            self.rebalance_s = timings
        s = self.slayout
        nbytes = _nbytes(s.canon_shards) + _nbytes(s.id_shards) \
            + _nbytes(s.alive_shards)
        if s.chunk_shards is not None:
            nbytes += _nbytes(s.chunk_shards)
        nbytes *= self.shards // s.id_shards.shape[0]    # every owner's
        return dict(placement=self.config.placement,
                    moved_tiles=self.stats.get("moved_tiles", 0),
                    replicated_tiles=self.stats.get("replicated_tiles", 0),
                    cut_before=self.stats.get("cut_before"),
                    cut_after=self.stats.get("cut_after"),
                    bytes_transferred=int(nbytes))

    def _move_rows(self) -> None:
        """The mesh form of a rebalance: the member counts are summed
        over the ranks' primaries, every rank makes the same plan, and
        each new resident row (primary or replica) is sent by the rank
        holding the tile's old primary, in one ``all_to_all_single``
        of packed rows (boxes, ids, alive and chunk boxes as bytes)."""
        mesh, s, d = self.mesh, self.slayout, self.shards
        t0 = time.perf_counter()
        canon, ids, alive, chunk = self._flat()
        dev = ids.device
        t = s.owner.shape[0]
        mine = torch.nonzero(self._rows >= 0).squeeze(1)
        counts = torch.zeros(t, dtype=torch.int64, device=dev)
        counts[mine] = (ids[self._rows[mine]] >= 0).sum(1)
        counts = mesh.all_reduce(counts, "sum").cpu().numpy()
        timings = dict(stage_s=time.perf_counter() - t0)
        t1 = time.perf_counter()
        plan = _plan_shards(counts.astype(np.float64), d, self._owner,
                            self._cooc, self._heat, self._replicate_top)
        t2 = time.perf_counter()
        # entry e: new row (owner_all[e], local_all[e]) of tile tiles_all[e],
        # read from the tile's old primary (s.owner, s.local)
        src = s.owner[plan.tiles_all].astype(np.int64)
        dst = plan.owner_all.astype(np.int64)
        out = np.flatnonzero(src == mesh.rank)
        out = out[np.argsort(dst[out], kind="stable")]
        inc = np.flatnonzero(dst == mesh.rank)
        inc = inc[np.argsort(src[inc], kind="stable")]
        parts = [canon, ids, alive] + ([] if chunk is None else [chunk])
        rows = torch.from_numpy(s.local[plan.tiles_all[out]].astype(
            np.int64)).to(dev)
        send = torch.cat([a[rows].reshape(rows.shape[0], -1)
                          .view(torch.uint8) for a in parts], dim=1)
        widths = [a[:1].reshape(1, -1).view(torch.uint8).shape[1]
                  for a in parts]
        shapes = [(a.dtype, tuple(a.shape[1:])) for a in parts]
        del canon, ids, alive, chunk, parts
        self._release()
        recv = mesh.all_to_all_v(
            send, np.bincount(dst[out], minlength=d).tolist(),
            np.bincount(src[inc], minlength=d).tolist())
        del send
        sentinel = geometry.sentinel(dev)
        fills = [sentinel, -1, False, sentinel]
        new = []
        at = torch.from_numpy(plan.local_all[inc].astype(np.int64)).to(dev)
        col = 0
        for w, (dtype, shape), fill in zip(widths, shapes, fills):
            a = torch.empty((plan.t_rows,) + shape, dtype=dtype, device=dev)
            a[:] = torch.as_tensor(fill, dtype=dtype, device=dev)
            a[at] = recv[:, col:col + w].contiguous().view(dtype).view(
                (-1,) + shape)
            new.append(a.view((1, plan.t_rows) + shape))
            col += w
        del recv
        if len(new) == 3:
            new.append(None)
        _sync(dev)
        timings.update(plan_s=t2 - t1, scatter_s=time.perf_counter() - t2)
        self._adopt(*_sharded_result(plan, self.stats, d, tuple(new),
                                     s.probe_boxes, s.chunk_boxes, s.uni))
        self.rebalance_s = timings

    def _release(self) -> None:
        self.slayout = self.extent = self._rows = self._rep_rows = None
        self._oracle_t = None

    def _placements(self, t: torch.Tensor):
        """Every resident copy on this device of global tiles ``t``
        (int64 on the device) -> ``(rows, take)``: the primary flat
        shard rows, then one replica row for each tile that has one;
        ``take`` indexes each row's entry in ``t`` (None when the rows
        are ``t``'s, one each), so each write fans out to all copies and
        replicas stay bit-exact.  Under a mesh only the rank's own rows
        are kept."""
        rows = self._rows[t]
        take = None
        if self.mesh is not None:
            take = torch.nonzero(rows >= 0).squeeze(1)
            rows = rows[take]
        if self._rep_rows is None:
            return rows, take
        rr = self._rep_rows[t]
        sel = torch.nonzero(rr >= 0).squeeze(1)
        if not sel.numel():
            return rows, take
        if take is None:
            take = torch.arange(t.shape[0], device=t.device)
        return torch.cat([rows, rr[sel]]), torch.cat([take, sel])

    def _flat(self):
        """The shard arrays as ``(D·T_rows, ...)`` views."""
        s = self.slayout
        cap = s.id_shards.shape[-1]
        chunk = (None if s.chunk_shards is None
                 else s.chunk_shards.view((-1,) + s.chunk_shards.shape[2:]))
        return (s.canon_shards.view(-1, cap, 4), s.id_shards.view(-1, cap),
                s.alive_shards.view(-1, cap), chunk)

    def _scatter(self, plan: dict) -> int:
        """O(M) device refresh of the shards: each plan cell and row is
        written through every flat shard row holding its tile
        (``owner·T_rows + local``, and the replica's row where there is
        one: ``_placements``; a rank writes its own rows only) with
        ``index_put_``, the global probe and chunk boxes and the
        universe beside.  The extent a shard row rises to cover each
        slot written alive, stays on tombstones, and is recomputed for
        rewritten rows, on replica rows as on their primaries.  Drops
        the dense oracle's staging.  Returns the bytes uploaded."""
        if not plan:
            return 0
        s = self.slayout
        canon, ids, alive, chunk = self._flat()
        extent = self.extent.view(-1)
        put = _Upload(self.device)

        def cells(key):
            idx, vals = plan[key]
            c = put(idx)
            r, take = self._placements(c[:, 0])
            return (r, _fan(c[:, 1], take)), _fan(put(vals), take)

        if "boxes" in plan:
            canon.index_put_(*cells("boxes"))
        if "ids" in plan:
            ids.index_put_(*cells("ids"))
        if "alive" in plan:
            (r, sl), v = cells("alive")
            alive.index_put_((r, sl), v)
            extent.scatter_reduce_(0, r[v], (sl[v] + 1).int(), "amax")
        if "probe" in plan:
            rows, vals = plan["probe"]
            s.probe_boxes[put(rows)] = put(vals)
        if "chunk" in plan:
            (r, c), v = cells("chunk")
            if chunk is not None:
                chunk.index_put_((r, c), v)
            if s.chunk_boxes is not None:
                tc = put(plan["chunk"][0])
                s.chunk_boxes.index_put_((tc[:, 0], tc[:, 1]),
                                         put(plan["chunk"][1]))
        if "uni" in plan:
            s.uni.copy_(put(plan["uni"]))
        if "rows" in plan:
            e = plan["rows"]
            rows = put(e["rows"])
            fr, take = self._placements(rows)
            canon[fr] = _fan(put(e["boxes"]), take)
            ids[fr] = _fan(put(e["ids"]), take)
            alive[fr] = _fan(put(e["alive"]), take)
            s.probe_boxes[rows] = put(e["probe"])
            if e["chunk"] is not None:
                if chunk is not None:
                    chunk[fr] = _fan(put(e["chunk"]), take)
                if s.chunk_boxes is not None:
                    s.chunk_boxes[rows] = put(e["chunk"])
            extent[fr] = rops.live_extent(alive[fr])
        self._oracle_t = None
        return put.nbytes

    # -- accessors -------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.slayout.id_shards.device

    @property
    def probe_boxes(self) -> torch.Tensor:
        return self.slayout.probe_boxes

    @property
    def chunk_boxes(self) -> torch.Tensor | None:
        return self.slayout.chunk_boxes

    @property
    def uni(self) -> torch.Tensor:
        return self.slayout.uni

    @property
    def oracle_np(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of the unsharded canonical staging (the ingest
        mirrors, built if missing)."""
        self._ensure_mirror()
        return self._canon_np, self._ids_np

    def resident_tile_bytes(self) -> int:
        s = self.slayout
        return (_nbytes(s.canon_shards) + _nbytes(s.id_shards)) \
            // s.id_shards.shape[0]

    def _device_arrays(self):
        """The unsharded staging.  Under a mesh the ranks' primary rows
        are gathered (every rank's first ``t_local`` rows, one
        ``all_gather`` an array) onto the host: the ingest mirrors'
        source, which every rank keeps whole."""
        canon, ids, alive, _ = self._flat()
        s, r = self.slayout, self._rows
        if self.mesh is None:
            return (canon[r], ids[r], s.probe_boxes, s.chunk_boxes, alive[r],
                    s.uni)
        tl = self.stats["t_local"]
        at = torch.from_numpy(s.owner.astype(np.int64) * tl + s.local)

        def gather(a):
            g = self.mesh.all_gather(a[:tl], host=True)
            return g.reshape((-1,) + tuple(a.shape[1:]))[at]
        return (gather(canon), gather(ids), s.probe_boxes, s.chunk_boxes,
                gather(alive), s.uni)

    def _device_ids(self) -> torch.Tensor:
        return self._flat()[1]

    def _device_fill_max(self) -> int:
        """Under a mesh each rank reads its own rows; the maximum is
        global."""
        fill = (self._device_ids() >= 0).sum(1).max().view(1)
        if self.mesh is not None:
            fill = self.mesh.all_reduce(fill, "max")
        return int(fill)

    def _oracle(self):
        """The unsharded ``(canon, ids, alive, extent, tiles)`` staging
        of the dense oracle, gathered from the shards on the device at
        first use (the sharded executors never need it); under a mesh
        the rank's own primary rows, in global tile order, and their
        global tiles ``tiles`` (None in-process)."""
        if self._oracle_t is None:
            canon, ids, alive, _ = self._flat()
            r, tiles = self._rows, None
            if self.mesh is not None:
                tiles = torch.nonzero(r >= 0).squeeze(1)
                r = r[tiles]
            self._oracle_t = (canon[r], ids[r], alive[r],
                              self.extent.view(-1)[r], tiles)
        return self._oracle_t

    # -- exchange plumbing -----------------------------------------------

    def _host_plan(self, cand, costs: np.ndarray):
        """Host plan of one batch: LPT query packing and the owner-local
        candidate tables (``router.owner_split``, one query at a time;
        its host ms land in ``split_ms``) -> ``(slots, send_slot,
        send_cand, stats)``, all host numpy and the same on every rank
        of a mesh."""
        s = self.slayout
        slots, pstats = pack_queries(costs, self.shards)
        cand = _host_np(cand)
        t0 = time.perf_counter()
        send_slot, send_cand, xstats = router.owner_split(
            cand, slots, s.owner, s.local, alt_owner=s.rep_owner,
            alt_local=s.rep_local)
        self.split_ms = (time.perf_counter() - t0) * 1e3
        return slots, send_slot, send_cand, {**pstats, **xstats}

    def _exchange_plan(self, cand, costs: np.ndarray):
        """``_host_plan`` with every home's tables on the device."""
        slots, ss, sc, stats = self._host_plan(cand, costs)
        dev = self.device
        return (slots, torch.from_numpy(ss).to(dev),
                torch.from_numpy(sc).to(dev), stats)

    def _home(self, x):
        """The homes this device runs: every row in-process, the rank's
        own (a leading axis of 1) under a mesh; host arrays go up."""
        if self.mesh is not None:
            x = x[self.mesh.rank:self.mesh.rank + 1]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return x

    def _homes_back(self, x: torch.Tensor, slots: np.ndarray, n_q: int):
        """Per-home answers -> per-query rows: under a mesh every rank's
        ``(1, Qpd, ...)`` home is gathered first."""
        if self.mesh is not None:
            x = self.mesh.all_gather(x[0])
        return _unpack_rows(x, slots, n_q)

    def _shards(self) -> exchange.Shards:
        canon, ids, alive, chunk = self._flat()
        return exchange.Shards(canon, ids, alive, chunk, self.extent.view(-1),
                               self.slayout.id_shards.shape[1])

    # -- routed executors ------------------------------------------------

    def range_counts(self, qboxes, cand, costs):
        slots, ss, sc, xstats = self._host_plan(cand, costs)
        qp = self._home(_pack_rows(qboxes, slots, _SENTINEL))
        out = exchange.serve_range_counts(self._comm, qp, self._home(ss),
                                          self._home(sc), self._shards())
        return (self._homes_back(out, slots, qboxes.shape[0]),
                dict(shards=self.shards, **xstats))

    def range_ids(self, qboxes, cand, costs, max_hits: int):
        slots, ss, sc, xstats = self._host_plan(cand, costs)
        qp = self._home(_pack_rows(qboxes, slots, _SENTINEL))
        cap = self.slayout.id_shards.shape[-1]
        mh_local = min(max_hits, sc.shape[3] * cap)
        out = exchange.serve_range_ids(self._comm, qp, self._home(ss),
                                       self._home(sc), self._shards(),
                                       max_hits=max_hits, mh_local=mh_local)
        n_q = qboxes.shape[0]
        hit_ids, counts, overflow = (self._homes_back(x, slots, n_q)
                                     for x in out)
        return hit_ids, counts, overflow, dict(shards=self.shards, **xstats)

    def knn_attempt(self, pts, k: int, max_cand: int, f: int):
        """One sharded kNN pass at frontier width ``f`` -> ``(nn_ids,
        nn_d2, radius, overflow, excluded, stats)``."""
        n_live = self.stats["n"]
        uni = self.slayout.uni
        cand, dist, excl = router.candidate_knn(self.slayout.probe_boxes,
                                                pts, f)
        slots, ss, sc, xstats = self._host_plan(
            cand, _knn_cost_proxy(_host_np(uni), n_live, dist, k))
        pp = self._home(_pack_rows(pts, slots, (uni[:2] + uni[2:]) * 0.5))
        out = exchange.serve_knn(self._comm, pp, self._home(ss),
                                 self._home(sc), self._home(slots < 0),
                                 self._shards(), uni, n_live, k=k,
                                 max_cand=max_cand)
        nn_ids, nn_d2, radius, overflow, rounds = (
            self._homes_back(x, slots, pts.shape[0]) for x in out)
        return nn_ids, nn_d2, radius, overflow, excl, dict(
            xstats, shards=self.shards, rounds=_max_rounds(rounds))

    # -- dense oracle ----------------------------------------------------

    def dense_range_counts(self, qboxes):
        canon, _, alive, extent, _ = self._oracle()
        counts = range_mod.range_counts(qboxes, canon, alive, extent=extent)
        if self.mesh is not None:
            counts = self.mesh.all_reduce(counts, "sum")
        return counts, {}

    def dense_range_ids(self, qboxes, max_hits: int):
        canon, ids, alive, extent, _ = self._oracle()
        hit_ids, counts, overflow = range_mod.range_ids(
            qboxes, canon, ids, max_hits, alive, extent=extent)
        if self.mesh is not None:
            # each rank's ascending ids (its smallest max_hits) and true
            # counts merge as the exchange's partials: one message a
            # query to every owner
            q = qboxes.shape[0]
            sl = torch.arange(q, dtype=torch.int32, device=qboxes.device)
            sl = sl.expand(1, self.shards, q)
            hit_ids, counts, overflow = (x[0] for x in range_mod.merge_owner_ids(
                self.mesh.all_gather(hit_ids)[None],
                self.mesh.all_gather(counts)[None], sl, q, max_hits))
        return hit_ids, counts, overflow, {}

    def dense_knn(self, pts, k: int, max_cand: int):
        canon, ids, alive, extent, tiles = self._oracle()
        if self.mesh is None:
            nn_ids, nn_d2, _, overflow, rounds = knn_mod.batched_knn(
                pts, k, canon, ids, self.slayout.uni, max_cand=max_cand,
                n_live=self.stats["n"], alive=alive, extent=extent)
        else:
            nn_ids, nn_d2, _, overflow, rounds = knn_mod.batched_knn_ranks(
                self.mesh, pts, k, canon, ids, tiles, self.stats["t"],
                self.slayout.uni, max_cand=max_cand, n_live=self.stats["n"],
                alive=alive, extent=extent)
        return nn_ids, nn_d2, overflow, dict(rounds=_max_rounds(rounds))


class HeatSharded(ShardedTiles):
    """Sharded placement that follows the query log: co-located
    primaries and hot-tile replicas, planned on the host from the
    ``HeatTracker`` signals the server feeds through ``rebalance``.

    - primaries co-locate on the candidate co-occurrence graph
      (``placement.colocate_tiles``), cutting the cross-owner pairs
      that make a query message two owners;
    - the ``config.policy.replicate_top`` hottest tiles keep a
      bit-exact second copy on another owner, in the shard rows past
      ``t_local`` (every owner has exactly ``ceil(T/D) +
      replicate_top`` rows, the hybrid's memory cost), and
      ``router.owner_split`` routes each candidate to whichever copy
      saves a message or carries less probe load.

    Every ingest write fans out to all copies (``_placements``), so
    answers stay the dense oracle's bits through appends, deletes,
    updates and compaction.  Cold (before any heat) it replicates by
    member counts and places primaries as ``ShardedTiles`` does.
    """

    mode = "heat"

    @property
    def _replicate_top(self) -> int:
        return self.config.policy.replicate_top


def _fan(x: torch.Tensor, take: torch.Tensor | None) -> torch.Tensor:
    """Per-entry values ``x`` of a write, one a resident row that
    ``_placements`` returned (``take`` indexes them into ``x``)."""
    return x if take is None else x[take]


def _max_rounds(rounds: torch.Tensor) -> int:
    return int(rounds.max()) if rounds.numel() else 0


_PLACEMENT_CLS = {"replicated": ReplicatedTiles, "sharded": ShardedTiles,
                  "heat": HeatSharded}


def build_tiles(parts: api.Partitioning, mbrs: torch.Tensor,
                config: ServeConfig, mesh=None) -> _TilesBase:
    """Stage ``mbrs`` and construct the placement ``config`` names (the
    one place the placement string is dispatched).  Under a mesh the
    ranks stage in turns, each keeping what its placement holds."""
    def build():
        layout, stats = stage_tiles(parts, mbrs, config)
        return _PLACEMENT_CLS[config.placement](parts, layout, stats, config,
                                                mesh)
    return mesh_lib.in_turns(mesh, build)
