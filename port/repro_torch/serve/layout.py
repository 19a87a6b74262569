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
  run through the owner-routed exchange (``serve.exchange``).  There
  is no mesh: the ``D`` owners are simulated on the one device, their
  shards one contiguous ``(D, T_rows, ...)`` array, so each move of the
  exchange is one launch over every owner;
- ``HeatSharded``: the sharded placement re-planned on observed query
  heat (``rebalance``): co-located primaries and bit-exact replicas of
  the hottest tiles in ``replicate_top`` extra rows an owner.

Both stream ``append``, ``delete``, ``update`` and ``compact`` into the
staging as O(M) scatters, with an overflow re-stage of the live set
(``_TilesBase``, the lifecycle written once).

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
from ..device import not_ported
from ..kernels.hilbert import ops as hilbert_ops
from ..kernels.range_probe import ops as rops
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
                    t_rows: int, d: int):
    """The global staging's rows gathered into ``(D, t_rows, ...)``
    shards on its own device: shard row ``owner[i]·t_rows + local[i]``
    reads global tile ``tiles[i]`` (a hot tile twice: its primary and
    its replica row); padding rows get the sentinel box, id -1 and
    ``alive`` False (and sentinel chunk boxes).  No host round trip: at
    8 M objects that would move about 5.8 GB each way."""
    dev = ids.device
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
    ``timings``, when given, receives the host planning and the
    device gather seconds (``plan_s``, ``scatter_s``).
    -> ``(ShardedLayout, stats)``.  The reference also returns a host
    copy of the unsharded staging for its dense oracle; the port
    rebuilds that oracle on the device from the shards
    (``ShardedTiles._oracle``).  A mesh raises (ROADMAP Queue 1 item
    10).
    """
    if mesh is not None:
        raise not_ported("mesh", "Queue 1 item 10")
    t0 = time.perf_counter()
    d = max(1, int(n_shards))
    if d == 1:
        replicate_top = 0      # a second owner needs a second device
    member_counts = ((layout.ids >= 0).sum(1).cpu().numpy()
                     .astype(np.float64))
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
    t1 = time.perf_counter()
    canon_sh, id_sh, alive_sh, chunk_sh = _scatter_shards(
        layout.canon_tiles, layout.ids, layout.alive, layout.chunk_boxes,
        owner_all, local_all, tiles_all, t_rows, d)
    if timings is not None:
        _sync(canon_sh.device)
        timings.update(plan_s=t1 - t0, scatter_s=time.perf_counter() - t1)
    slayout = ShardedLayout(canon_shards=canon_sh, id_shards=id_sh,
                            alive_shards=alive_sh, chunk_shards=chunk_sh,
                            probe_boxes=layout.probe_boxes,
                            chunk_boxes=layout.chunk_boxes, uni=layout.uni,
                            owner=owner, local=local, rep_owner=rep_owner,
                            rep_local=rep_local)
    stats = dict(stats, shards=d, t_local=t_local,
                 shard_bytes=sum(_nbytes(a) for a in (canon_sh, id_sh,
                                                      alive_sh)) // d,
                 placement_skew=pstats["skew"], replicated_tiles=n_rep)
    for key in ("cut_before", "cut_after"):
        if key in pstats:
            stats[key] = pstats[key]
    if "moved" in pstats:
        stats["moved_tiles"] = pstats["moved"]
    return slayout, stats


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
    n_devices = 1

    def __init__(self, parts: api.Partitioning, layout: StagedLayout,
                 stats: dict, config: ServeConfig):
        self.parts = parts
        self.config = config
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
            fill = int((self._device_ids() >= 0).sum(1).max())
        else:
            fill = int(self._fill.max())
        return int(self.stats["cap"] - fill)

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
        Returns the bytes of the dataset uploaded."""
        boxes, ids = self._dataset_np()
        if extra is not None and len(extra):
            boxes = np.concatenate([boxes, extra], axis=0)
            ids = np.concatenate([ids, np.asarray(extra_ids, np.int32)])
        dev = self.device
        self._release()
        layout, stats = stage_tiles(
            self.parts, torch.from_numpy(boxes).to(dev),
            self.config.replace(capacity=None, slack=self._eff_slack),
            ids=torch.from_numpy(ids).to(dev))
        for key in ("n", "t", "cap", "t_live", "chunks", "replication"):
            self.stats[key] = stats[key]
        self.stats["restages"] += 1
        self._drop_mirror()
        self._install(layout)
        return int(boxes.nbytes + ids.nbytes)

    @property
    def uni(self) -> torch.Tensor:
        return self._device_arrays()[5]


class ReplicatedTiles(_TilesBase):
    """The full staging on the one device; only queries vary.

    Each routed batch probes its candidate tiles with the gathered
    kernels (chunk-skipping when the staging carries a local index);
    the dense oracle probes every tile with the dense kernels.  Every
    probe passes the alive mask and its live extent (``extent``, one a
    tile).  Stats dicts equal the reference's with ``mesh=None``.
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

    # -- routed executors ------------------------------------------------

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


class ShardedTiles(_TilesBase):
    """Tiles shard across ``config.shards`` owners; queries travel to
    them through the owner-routed exchange, the owners simulated on
    the one device (``mesh=None``).

    Staging shards by capped-LPT placement (``shard_staged``), built on
    the device from the staging, which is then dropped.  Each routed
    batch packs its queries onto home devices (``pack_queries``),
    translates their candidate lists into per-owner tables on the host
    (``router.owner_split``, timed into ``split_ms``) and runs one
    ``serve.exchange`` orchestration.  The live extent is kept a shard
    row (``extent``, ``(D, T_rows)``).  The dense oracle probes an
    unsharded staging rebuilt on the device from the shards at its
    first call and dropped on every refresh.  A streaming re-stage
    re-balances owners on the fresh member counts
    (``stats['moved_tiles']``) under the same ``ceil(T/D)`` bound;
    ``rebalance`` re-plans them on observed heat (co-locating tiles
    that share queries).  Stats dicts equal the reference's with
    ``mesh=None``.
    """

    mode = "sharded"

    def __init__(self, parts: api.Partitioning, layout: StagedLayout,
                 stats: dict, config: ServeConfig):
        self.shards = 0        # set by the first _install
        self._owner = None     # the map a re-stage re-balances from
        self._heat = None      # last observed heat and co-occurrence
        self._cooc = None      # (rebalance feeds them; re-stages re-plan)
        self._comm = exchange._Comm(None)
        self.split_ms = 0.0    # owner_split's host ms, the last batch
        self.rebalance_s: dict = {}   # the last rebalance's split seconds
        super().__init__(parts, layout, stats, config)

    @property
    def _replicate_top(self) -> int:
        return 0               # HeatSharded budgets replica rows

    def _install(self, layout: StagedLayout,
                 timings: dict | None = None) -> None:
        cfg = self.config
        if not self.shards:
            self.shards = int(cfg.shards) if cfg.shards else self.n_devices
        slayout, stats = shard_staged(
            layout, self.stats, self.shards, prev_owner=self._owner,
            cooc=self._cooc, heat=self._heat,
            replicate_top=self._replicate_top, timings=timings)
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
        # (the dense oracle and a rebalance read the primaries)
        self._rows = torch.from_numpy(
            slayout.owner.astype(np.int64) * t_rows + slayout.local).to(dev)
        # global tile -> its replica's flat row, -1 where it has none
        self._rep_rows = None
        if slayout.rep_owner is not None:
            ro = slayout.rep_owner.astype(np.int64)
            self._rep_rows = torch.from_numpy(np.where(
                ro >= 0, ro * t_rows + slayout.rep_local, -1)).to(dev)
        # (D, T_rows) int32 live extent a shard row (0 in padding rows)
        self.extent = rops.live_extent(
            slayout.alive_shards.view(-1, cap)).view(d, t_rows)
        self._oracle_t = None

    def rebalance(self, heat=None, cooc=None) -> dict:
        """Re-plan the owners on observed heat under traffic.

        ``heat``/``cooc`` (a ``HeatTracker.snapshot()``) replace the
        stored signals; the tile -> owner map is re-planned, co-locating
        on the co-occurrence graph and seeded from the current owners
        (only tiles whose move pays travel), the heat placement's
        replicas re-chosen, and the shards re-gathered.  Tile contents,
        ids, slots, probe and chunk boxes stay, so answers are the same
        bits before and after, and the shard shapes stay.  The unsharded
        staging is rebuilt on the device from the primary rows (as the
        dense oracle's is) and the old shards released before the new
        ones are gathered: one staging and one set of shards at a time.
        Returns the reference's report; ``rebalance_s`` keeps the
        split seconds (``stage_s``, ``plan_s``, ``scatter_s``)."""
        if heat is not None:
            self._heat = np.asarray(heat, np.float64)
        if cooc is not None:
            self._cooc = np.asarray(cooc, np.float64)
        t0 = time.perf_counter()
        s = self.slayout
        canon, ids, alive, _ = self._oracle()
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
        return dict(placement=self.config.placement,
                    moved_tiles=self.stats.get("moved_tiles", 0),
                    replicated_tiles=self.stats.get("replicated_tiles", 0),
                    cut_before=self.stats.get("cut_before"),
                    cut_after=self.stats.get("cut_after"),
                    bytes_transferred=int(nbytes))

    def _release(self) -> None:
        self.slayout = self.extent = self._rows = self._rep_rows = None
        self._oracle_t = None

    def _placements(self, t: torch.Tensor):
        """Every resident copy of global tiles ``t`` (int64 on the
        device) -> ``(rows, sel)``: the primary flat shard rows, then
        one replica row for each tile that has one; ``sel`` indexes the
        replicated entries back into ``t`` (None when there are none),
        so each write fans out to all copies and replicas stay
        bit-exact."""
        rows = self._rows[t]
        if self._rep_rows is None:
            return rows, None
        rr = self._rep_rows[t]
        sel = torch.nonzero(rr >= 0).squeeze(1)
        if not sel.numel():
            return rows, None
        return torch.cat([rows, rr[sel]]), sel

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
        one: ``_placements``) with ``index_put_``, the global probe and
        chunk boxes and the universe beside.  The extent a shard row
        rises to cover each slot written alive, stays on tombstones, and
        is recomputed for rewritten rows, on replica rows as on their
        primaries.  Drops the dense oracle's staging.  Returns the bytes
        uploaded."""
        if not plan:
            return 0
        s = self.slayout
        canon, ids, alive, chunk = self._flat()
        extent = self.extent.view(-1)
        put = _Upload(self.device)

        def cells(key):
            idx, vals = plan[key]
            c = put(idx)
            r, sel = self._placements(c[:, 0])
            return (r, _fan(c[:, 1], sel)), _fan(put(vals), sel)

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
            fr, sel = self._placements(rows)
            canon[fr] = _fan(put(e["boxes"]), sel)
            ids[fr] = _fan(put(e["ids"]), sel)
            alive[fr] = _fan(put(e["alive"]), sel)
            s.probe_boxes[rows] = put(e["probe"])
            if e["chunk"] is not None:
                if chunk is not None:
                    chunk[fr] = _fan(put(e["chunk"]), sel)
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
        return (_nbytes(s.canon_shards) + _nbytes(s.id_shards)) // self.shards

    def _device_arrays(self):
        canon, ids, alive, _ = self._flat()
        s, r = self.slayout, self._rows
        return (canon[r], ids[r], s.probe_boxes, s.chunk_boxes, alive[r],
                s.uni)

    def _device_ids(self) -> torch.Tensor:
        return self._flat()[1]

    def _oracle(self):
        """The unsharded ``(canon, ids, alive, extent)`` staging of the
        dense oracle, gathered from the shards on the device at first
        use (the sharded executors never need it)."""
        if self._oracle_t is None:
            canon, ids, alive, _ = self._flat()
            r = self._rows
            self._oracle_t = (canon[r], ids[r], alive[r],
                              self.extent.view(-1)[r])
        return self._oracle_t

    # -- exchange plumbing -----------------------------------------------

    def _exchange_plan(self, cand, costs: np.ndarray):
        """Host plan of one batch: LPT query packing and the owner-local
        candidate tables (``router.owner_split``, one query at a time;
        its host ms land in ``split_ms``) -> ``(slots, send_slot,
        send_cand, stats)``, the tables on the device."""
        s = self.slayout
        slots, pstats = pack_queries(costs, self.shards)
        cand = _host_np(cand)
        t0 = time.perf_counter()
        send_slot, send_cand, xstats = router.owner_split(
            cand, slots, s.owner, s.local, alt_owner=s.rep_owner,
            alt_local=s.rep_local)
        self.split_ms = (time.perf_counter() - t0) * 1e3
        dev = self.device
        return (slots, torch.from_numpy(send_slot).to(dev),
                torch.from_numpy(send_cand).to(dev), {**pstats, **xstats})

    def _shards(self) -> exchange.Shards:
        canon, ids, alive, chunk = self._flat()
        return exchange.Shards(canon, ids, alive, chunk, self.extent.view(-1),
                               self.slayout.id_shards.shape[1])

    # -- routed executors ------------------------------------------------

    def range_counts(self, qboxes, cand, costs):
        slots, ss, sc, xstats = self._exchange_plan(cand, costs)
        qp = _pack_rows(qboxes, slots, _SENTINEL)
        out = exchange.serve_range_counts(self._comm, qp, ss, sc,
                                          self._shards())
        return (_unpack_rows(out, slots, qboxes.shape[0]),
                dict(shards=self.shards, **xstats))

    def range_ids(self, qboxes, cand, costs, max_hits: int):
        slots, ss, sc, xstats = self._exchange_plan(cand, costs)
        qp = _pack_rows(qboxes, slots, _SENTINEL)
        cap = self.slayout.id_shards.shape[-1]
        mh_local = min(max_hits, sc.shape[3] * cap)
        out = exchange.serve_range_ids(self._comm, qp, ss, sc, self._shards(),
                                       max_hits=max_hits, mh_local=mh_local)
        n_q = qboxes.shape[0]
        hit_ids, counts, overflow = (_unpack_rows(x, slots, n_q) for x in out)
        return hit_ids, counts, overflow, dict(shards=self.shards, **xstats)

    def knn_attempt(self, pts, k: int, max_cand: int, f: int):
        """One sharded kNN pass at frontier width ``f`` -> ``(nn_ids,
        nn_d2, radius, overflow, excluded, stats)``."""
        n_live = self.stats["n"]
        uni = self.slayout.uni
        cand, dist, excl = router.candidate_knn(self.slayout.probe_boxes,
                                                pts, f)
        slots, ss, sc, xstats = self._exchange_plan(
            cand, _knn_cost_proxy(_host_np(uni), n_live, dist, k))
        pp = _pack_rows(pts, slots, (uni[:2] + uni[2:]) * 0.5)
        dead = torch.from_numpy(slots < 0).to(self.device)
        out = exchange.serve_knn(self._comm, pp, ss, sc, dead, self._shards(),
                                 uni, n_live, k=k, max_cand=max_cand)
        nn_ids, nn_d2, radius, overflow, rounds = (
            _unpack_rows(x, slots, pts.shape[0]) for x in out)
        return nn_ids, nn_d2, radius, overflow, excl, dict(
            xstats, shards=self.shards, rounds=_max_rounds(rounds))

    # -- dense oracle ----------------------------------------------------

    def dense_range_counts(self, qboxes):
        canon, _, alive, extent = self._oracle()
        return range_mod.range_counts(qboxes, canon, alive,
                                      extent=extent), {}

    def dense_range_ids(self, qboxes, max_hits: int):
        canon, ids, alive, extent = self._oracle()
        hit_ids, counts, overflow = range_mod.range_ids(
            qboxes, canon, ids, max_hits, alive, extent=extent)
        return hit_ids, counts, overflow, {}

    def dense_knn(self, pts, k: int, max_cand: int):
        canon, ids, alive, extent = self._oracle()
        nn_ids, nn_d2, _, overflow, rounds = knn_mod.batched_knn(
            pts, k, canon, ids, self.slayout.uni, max_cand=max_cand,
            n_live=self.stats["n"], alive=alive, extent=extent)
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


def _fan(x: torch.Tensor, sel: torch.Tensor | None) -> torch.Tensor:
    """Per-entry values ``x`` of a write, repeated for the replica rows
    ``_placements`` appended (``sel`` indexes them into ``x``)."""
    return x if sel is None else torch.cat([x, x[sel]])


def _max_rounds(rounds: torch.Tensor) -> int:
    return int(rounds.max()) if rounds.numel() else 0


_PLACEMENT_CLS = {"replicated": ReplicatedTiles, "sharded": ShardedTiles,
                  "heat": HeatSharded}


def build_tiles(parts: api.Partitioning, mbrs: torch.Tensor,
                config: ServeConfig) -> _TilesBase:
    """Stage ``mbrs`` and construct the placement ``config`` names (the
    one place the placement string is dispatched)."""
    layout, stats = stage_tiles(parts, mbrs, config)
    return _PLACEMENT_CLS[config.placement](parts, layout, stats, config)
