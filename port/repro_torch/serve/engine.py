"""The batched spatial query server (twin of ``repro.serve.engine``:
the replicated placement, and the sharded and heat placements with
their owners simulated on one device or one a rank of a process
mesh).

A dataset is partitioned and MASJ-staged once; each range batch is
then answered in three steps (the pruned probe, the default):

  route  -- probe-box overlap gives every query's fan-out and a
            fixed-width ``(Q, F)`` candidate-tile index, ``F`` covering
            the batch's true max fan-out (never truncating) and
            ratcheted through ``WidthPolicy``;
  probe  -- the layout probes candidate tiles only with the gathered
            ``range_probe`` kernel (chunk-skipping under the local
            index, always with the alive mask);
  answer -- exact unique counts, or ascending id lists with overflow
            flagged past ``max_hits``.

kNN batches deepen over each point's MINDIST frontier of tiles and
widen the frontier until no query can have missed a neighbour (the
widen-and-retry ladder).  ``probe="dense"`` or ``pruned=False`` runs
the dense oracle instead: every tile, through the dense kernels.

The dataset moves: ``append`` streams new objects into the slack
slots staging reserved (``config.slack``), ``delete`` tombstones
objects by id, ``update`` moves them, and the ``ServeConfig``
compaction policy (or ``compact``) reclaims dead slots; each writes
only the touched cells and rows to the device, and a tile overflow
re-stages the layout at a grown capacity and resets the width cache.
Answers after any ingest sequence equal a fresh staging of the live
set.

Every routed batch folds its candidate lists into a ``HeatTracker``;
``rebalance`` hands a snapshot to the layout, which re-plans its owners
on it (``"sharded"``: co-locating tiles that share queries; ``"heat"``:
that and replicas of the hottest tiles; ``"replicated"``: the
reference's no-op report), and ``PlacementPolicy.rebalance_every``
runs it every N observed batches.

The server is written once against the ``TileLayout`` protocol
(``serve.layout``): ``placement="replicated"`` keeps the whole staging
on the device, ``placement="sharded"`` and ``"heat"``
(``ServeConfig.shards`` owners) place tiles on owners and run each
batch through the owner-routed exchange (``serve.exchange``), every
owner simulated on the one device (``mesh=None``) or, given a
``launch.mesh.ProcessMesh``, one owner a rank (every rank runs the same
calls on the same inputs and gets the whole answer back); the answers
are the same bits.
"""
from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from ..core.partition import api
from ..core.partition.assign import round_up
from ..device import resolve
from ..kernels.range_probe import ops as rops
from ..query import knn as knn_mod
from . import router
from .config import ServeConfig
from .layout import ShardedLayout, StagedLayout, TileLayout, build_tiles

log = logging.getLogger(__name__)


def _f_width(fanout_max: int, t: int) -> int:
    """Candidate-list width: max batch fan-out rounded up to 8, capped
    at the tile count."""
    return min(max(t, 1), round_up(max(fanout_max, 1), 8))


class WidthPolicy:
    """Adaptive candidate-width cache: widths per query kind (``"range"``
    or ``("knn", k, max_cand)``) only move up (wider is always exact),
    clamped to ``cap`` (the live tile count).  ``at_least(key, floor)``
    returns ``max(cached, floor)``, so a narrow range batch after a wide
    one reuses the wider width; ``start(key, default)`` returns the
    cached kNN width, or ``default`` cold (any kNN width is correct: the
    ladder widens until exact)."""

    def __init__(self, cap: int | None = None):
        self.cap = cap
        self._w: dict = {}
        self.hits = 0
        self.misses = 0

    def _clamp(self, w: int) -> int:
        return w if self.cap is None else min(w, self.cap)

    def at_least(self, key, floor: int) -> int:
        w = self._w.get(key)
        if w is not None and w >= floor:
            self.hits += 1
            return w
        self.misses += 1
        return floor

    def start(self, key, default: int) -> int:
        w = self._w.get(key)
        if w is not None:
            self.hits += 1
            return w
        self.misses += 1
        return default

    def observe(self, key, width: int) -> None:
        self._w[key] = self._clamp(max(self._w.get(key, 0), width))

    def reset(self) -> None:
        """Forget every cached width (the server calls it on every
        re-stage, whose layout the widths no longer describe)."""
        self._w.clear()


class SpatialServer:
    """Stage once, then serve batched exact range and kNN queries.

    ``device`` defaults to ``cuda`` (raising where there is none);
    ``device="cpu"`` runs the plain PyTorch versions of every kernel.
    ``config`` is a frozen ``ServeConfig``; the port serves the
    ``"replicated"``, ``"sharded"`` and ``"heat"`` placements (the
    latter two's ``shards`` owners simulated on the device), ``probe``
    ``"pruned"``
    (default) or ``"dense"`` (also a per-call ``pruned=`` override),
    and ``local_index`` ``"x"`` (default), ``"hilbert"`` or ``"off"``,
    on any of the six layouts.  ``mesh`` (a ``launch.mesh.ProcessMesh``)
    runs the server SPMD: every rank constructs it and makes every call
    with the same inputs, on the mesh's device unless ``device`` is
    given; the sharded placements hold one owner's shard a rank
    (``shards`` must be the mesh size), the replicated one the whole
    staging on every rank, each batch query-sharded.
    """

    def __init__(self, parts: api.Partitioning, mbrs,
                 config: ServeConfig | None = None, *,
                 device: torch.device | str | None = None,
                 method: str | None = None, mesh=None):
        self.config = config = config if config is not None else ServeConfig()
        self.mesh = mesh
        self.device = resolve(mesh.device if device is None
                              and mesh is not None else device)
        mbrs = torch.as_tensor(mbrs, dtype=torch.float32, device=self.device)
        self.parts = api.Partitioning(parts.boxes.to(self.device),
                                      parts.valid.to(self.device))
        self.tiles: TileLayout = build_tiles(self.parts, mbrs, config, mesh)
        self.stats = self.tiles.stats
        self.stats["method"] = method
        self.widths = WidthPolicy(cap=self.stats["t_live"])
        self.heat = router.HeatTracker(self.stats["t"],
                                       decay=config.policy.heat_decay,
                                       device=self.device)
        self._batches_since_rebalance = 0
        self.rebalance_s: dict = {}   # the last rebalance's split seconds

    @classmethod
    def from_method(cls, method: str, mbrs, payload: int,
                    config: ServeConfig | None = None, *,
                    device: torch.device | str | None = None, mesh=None
                    ) -> "SpatialServer":
        """Partition ``mbrs`` with ``method`` at ``payload`` and serve
        (under a mesh every rank partitions the same objects alike)."""
        dev = resolve(mesh.device if device is None and mesh is not None
                      else device)
        mbrs = torch.as_tensor(mbrs, dtype=torch.float32, device=dev)
        parts = api.partition(method, mbrs, payload)
        return cls(parts, mbrs, config, device=dev, method=method, mesh=mesh)

    # -- accessors --------------------------------------------------------

    @property
    def probe_boxes(self) -> torch.Tensor:
        return self.tiles.probe_boxes

    @property
    def chunk_boxes(self) -> torch.Tensor | None:
        """The (T, C, 4) local index (None when unindexed)."""
        return self.tiles.chunk_boxes

    @property
    def uni(self) -> torch.Tensor:
        return self.tiles.uni

    @property
    def layout(self) -> StagedLayout | None:
        """The replicated staging (None under ``"sharded"`` and
        ``"heat"``)."""
        return getattr(self.tiles, "staged", None)

    @property
    def slayout(self) -> ShardedLayout | None:
        """The sharded staging, replica maps included under ``"heat"``
        (None under ``placement='replicated'``)."""
        return getattr(self.tiles, "slayout", None)

    @property
    def shards(self) -> int:
        return self.tiles.shards

    @property
    def n_devices(self) -> int:
        return self.tiles.n_devices

    @property
    def _oracle_np(self):
        return self.tiles.oracle_np

    def _queries(self, qboxes) -> torch.Tensor:
        """Query boxes (Q, 4) or points (Q, 2) as float32 on the device."""
        return torch.as_tensor(qboxes, dtype=torch.float32,
                               device=self.device)

    def chunk_skip_rate(self, qboxes) -> float:
        """Fraction of per-candidate 128-member chunks whose box the
        query misses (work the ``*_skip`` kernels drop); 0.0 when staged
        with ``local_index="off"``.  Does not touch the width cache."""
        if self.chunk_boxes is None:
            return 0.0
        qboxes = self._queries(qboxes)
        hit = router.probe_overlap(self.probe_boxes, qboxes)
        pf = int(hit.sum(1).max()) if hit.shape[0] else 0
        f = _f_width(pf, self.stats["t_live"])
        cand, _, _ = router.candidates_from_overlap(hit, f)
        return float(rops.chunk_skip_rate(qboxes, self.chunk_boxes, cand))

    def resident_tile_bytes(self) -> int:
        """Device bytes of the resident canonical tiles and ids, a
        device (an owner's shard under ``placement='sharded'``)."""
        return self.tiles.resident_tile_bytes()

    # -- streaming ---------------------------------------------------------

    def append(self, mbrs) -> dict:
        """Stream new objects (M, 4) into the served layout; ids continue
        the running numbering.  Inserts into each tile's slack (probe
        and chunk boxes refresh in place); a tile overflow re-stages at
        a grown capacity and resets the width cache.  Returns the
        append report (``appended``, ``restaged``, ``n``, ``n_total``,
        ``cap``, ``bytes_transferred``, ``free_slots_min``)."""
        return self._after_maintenance(self.tiles.append(mbrs))

    def delete(self, ids) -> dict:
        """Tombstone objects by id (their alive bits flip off; boxes stay
        as routing supersets).  Unknown, repeated or already-deleted ids
        raise ``ValueError`` naming them.  May trigger the compaction
        policy; the report carries ``deleted``, ``n``, ``dead_frac``,
        ``compacted_tiles`` and ``restaged``."""
        return self._after_maintenance(self.tiles.delete(ids))

    def update(self, ids, mbrs) -> dict:
        """Move objects: tombstone each id's canonical slot and insert
        its new MBR under the same id (one scatter).  Overflow re-stages
        as ``append`` does; otherwise the compaction policy applies."""
        return self._after_maintenance(self.tiles.update(ids, mbrs))

    def compact(self) -> dict:
        """Compact every tile holding dead slots, whatever the config's
        thresholds (survivors re-sorted, probe and chunk boxes
        tightened, dead counts zeroed)."""
        return self._after_maintenance(self.tiles.compact())

    def _after_maintenance(self, report: dict) -> dict:
        """The live tile count may move (compaction empties tiles, a
        re-stage rebuilds them), and a re-stage voids the width cache."""
        self.widths.cap = self.stats["t_live"]
        if report.get("restaged"):
            self.widths.reset()
        return report

    def rebalance(self) -> dict:
        """Snapshot the heat tracker and hand it to the layout: owners
        re-plan, co-locating co-occurring tiles (seeded from the current
        plan), and under ``"heat"`` the hottest
        ``config.policy.replicate_top`` tiles refresh their replicas.
        Answers are the same bits before and after; only the owner maps
        and the shards change.  The no-op report under
        ``"replicated"``.  ``rebalance_s`` keeps the split seconds: the
        snapshot (its host copy), and the layout's staging rebuild, plan
        and re-gather."""
        t0 = time.perf_counter()
        heat, cooc = self.heat.snapshot()
        snapshot_s = time.perf_counter() - t0
        report = self.tiles.rebalance(heat, cooc)
        self.rebalance_s = dict(snapshot_s=snapshot_s,
                                **getattr(self.tiles, "rebalance_s", {}))
        self._batches_since_rebalance = 0
        return report

    def _observe(self, cand) -> None:
        """Fold one routed batch into the heat tracker; rebalance every
        ``config.policy.rebalance_every`` observed batches."""
        self.heat.observe(cand)
        self._batches_since_rebalance += 1
        every = self.config.policy.rebalance_every
        if every is not None and self._batches_since_rebalance >= every:
            self.rebalance()

    # -- routing (host side, per batch) -----------------------------------

    def _use_pruned(self, pruned: bool | None) -> bool:
        return (self.config.probe == "pruned") if pruned is None else pruned

    def _route_batch(self, qboxes: torch.Tensor):
        """Candidate-tile index for one range batch: ``f_max`` covers the
        batch's true max probe fan-out and is ratcheted through the width
        cache.  -> ``(cand[Q, F], costs[Q], F)``."""
        hit = router.probe_overlap(self.probe_boxes, qboxes)
        pf = hit.sum(1, dtype=torch.int32).cpu().numpy()
        floor = _f_width(int(pf.max(initial=0)), self.stats["t_live"])
        f = self.widths.at_least("range", floor)
        cand, _, _ = router.candidates_from_overlap(hit, f)
        self.widths.observe("range", f)
        self._observe(cand)
        return cand, pf.astype(np.float64), f

    def _fanout_stats(self, qboxes: torch.Tensor) -> dict:
        """The paper's reported metric: region fan-out from the global
        index (independent of the executor's probe-box routing)."""
        _, fanout = router.route_range(self.parts, qboxes)
        fanout_np = fanout.cpu().numpy()
        return dict(fanout_mean=float(fanout_np.mean()),
                    fanout_max=int(fanout_np.max()))

    # -- queries ----------------------------------------------------------

    def range_counts(self, qboxes, pruned: bool | None = None):
        """Exact unique hit counts -> ``((Q,) int32, stats)``."""
        qboxes = self._queries(qboxes)
        stats = self._fanout_stats(qboxes)
        if self._use_pruned(pruned):
            cand, costs, f = self._route_batch(qboxes)
            counts, xstats = self.tiles.range_counts(qboxes, cand, costs)
            stats.update(mode=self.tiles.mode, f_max=f, **xstats)
        else:
            counts, xstats = self.tiles.dense_range_counts(qboxes)
            stats.update(mode="dense", **xstats)
        return counts, stats

    def range_ids(self, qboxes, max_hits: int = 1024,
                  pruned: bool | None = None):
        """Exact unique hit-id sets (ascending, -1 padded) + overflow
        -> ``(hit_ids[Q, max_hits], counts[Q], overflow[Q], stats)``."""
        qboxes = self._queries(qboxes)
        stats = self._fanout_stats(qboxes)
        if self._use_pruned(pruned):
            cand, costs, f = self._route_batch(qboxes)
            hit_ids, counts, overflow, xstats = self.tiles.range_ids(
                qboxes, cand, costs, max_hits)
            stats.update(mode=self.tiles.mode, f_max=f, **xstats)
        else:
            hit_ids, counts, overflow, xstats = self.tiles.dense_range_ids(
                qboxes, max_hits)
            stats.update(mode="dense", **xstats)
        return hit_ids, counts, overflow, stats

    def knn(self, pts, k: int, max_cand: int = 1024,
            pruned: bool | None = None):
        """Exact batched kNN -> ``(nn_ids[Q, k], nn_d2[Q, k], overflow[Q],
        stats)``; the reported fan-out is the MINDIST partitions a
        best-first search would visit given the answered kth distance.

        The pruned executor starts from a density-sized MINDIST frontier
        (or the width cache's converged start) and doubles it while any
        query's refinement radius reaches an excluded tile
        (``stats['retries']``), so unflagged answers equal the dense
        oracle's.
        """
        pts = self._queries(pts)
        if self._use_pruned(pruned):
            nn_ids, nn_d2, overflow, mode_stats = self._knn_retry_loop(
                pts, k, max_cand)
            mode_stats = dict(mode=self.tiles.mode, **mode_stats)
        else:
            nn_ids, nn_d2, overflow, xstats = self.tiles.dense_knn(
                pts, k, max_cand)
            mode_stats = dict(mode="dense", **xstats)
        fanout = knn_mod.knn_fanout(pts, nn_d2[:, -1], self.parts.boxes,
                                    self.parts.valid).cpu().numpy()
        stats = dict(fanout_mean=float(fanout.mean()),
                     fanout_max=int(fanout.max()), **mode_stats)
        return nn_ids, nn_d2, overflow, stats

    def _knn_retry_loop(self, pts: torch.Tensor, k: int, max_cand: int):
        """The widen-and-retry ladder: answer at frontier width ``f``;
        while a query's √2-inflated radius reaches its nearest excluded
        tile (it may have missed a neighbour), double ``f``, up to the
        live tile count.  The miss test is float64, as the reference's
        float32 radius times ``np.sqrt(2.0)`` is under NumPy 2."""
        t_live, n = self.stats["t_live"], self.stats["n"]
        wkey = ("knn", k, max_cand)
        f = self.widths.start(
            wkey, _f_width(4 * k * t_live // max(n, 1) + 3, t_live))
        retries = 0
        while True:
            nn_ids, nn_d2, radius, overflow, excl, xstats = \
                self.tiles.knn_attempt(pts, k, max_cand, f)
            miss = excl.double() <= radius.double() * math.sqrt(2.0)
            if not bool(miss.any()) or f >= t_live:
                break
            new_f = _f_width(2 * f, t_live)
            log.info("kNN frontier miss on %d/%d queries: widening "
                     "f_max %d -> %d (retry %d)",
                     int(miss.sum()), pts.shape[0], f, new_f, retries + 1)
            f = new_f
            retries += 1
        self.widths.observe(wkey, f)
        # heat sees the converged frontier: the tiles this batch probed
        cand, _, _ = router.candidate_knn(self.probe_boxes, pts, f)
        self._observe(cand)
        return (nn_ids, nn_d2, overflow | miss,
                dict(f_max=f, retries=retries, **xstats))
