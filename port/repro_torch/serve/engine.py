"""The batched spatial query server, routed range half (twin of
``repro.serve.engine``).

A dataset is partitioned and MASJ-staged once; each range batch is
then answered in three steps:

  route  -- probe-box overlap gives every query's fan-out and a
            fixed-width ``(Q, F)`` candidate-tile index, ``F`` covering
            the batch's true max fan-out (never truncating) and
            ratcheted through ``WidthPolicy``;
  probe  -- the layout probes candidate tiles only with the gathered
            ``range_probe`` kernel (chunk-skipping under the local
            index, always with the alive mask);
  answer -- exact unique counts, or ascending id lists with overflow
            flagged past ``max_hits``.

Features of the reference server not ported yet (kNN, ingest,
rebalancing, the dense oracle, sharded and heat placements, meshes)
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.partition import api
from ..core.partition.assign import round_up
from ..device import not_ported, resolve
from ..kernels.range_probe import ops as rops
from . import router
from .config import ServeConfig
from .layout import ReplicatedTiles, StagedLayout, build_tiles


def _f_width(fanout_max: int, t: int) -> int:
    """Candidate-list width: max batch fan-out rounded up to 8, capped
    at the tile count."""
    return min(max(t, 1), round_up(max(fanout_max, 1), 8))


class WidthPolicy:
    """Adaptive candidate-width cache: widths per query kind only move
    up (wider is always exact), clamped to ``cap`` (the live tile
    count).  ``at_least(key, floor)`` returns ``max(cached, floor)``, so
    a narrow batch after a wide one reuses the wider width."""

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

    def observe(self, key, width: int) -> None:
        self._w[key] = self._clamp(max(self._w.get(key, 0), width))


_DENSE_ITEMS = "Queue 1 items 2-3, Queue 2 items 4-5"


def _check_ported(config: ServeConfig) -> None:
    if config.probe == "dense":
        raise not_ported("probe='dense'", _DENSE_ITEMS)
    if config.placement == "sharded":
        raise not_ported("placement='sharded'", "Queue 1 item 10")
    if config.placement == "heat":
        raise not_ported("placement='heat'", "Queue 1 item 11")
    if config.local_index == "hilbert":
        raise not_ported("local_index='hilbert'", "Queue 1 item 7")
    if config.policy.rebalance_every is not None:
        raise not_ported("PlacementPolicy.rebalance_every",
                         "Queue 1 item 11")


class SpatialServer:
    """Stage once, then serve batched exact range queries on one device.

    ``device`` defaults to ``cuda`` (raising where there is none);
    ``device="cpu"`` runs the plain PyTorch versions of every kernel.
    ``config`` is a frozen ``ServeConfig``; this slice serves the
    replicated placement with the pruned probe and ``local_index``
    ``"x"`` (default) or ``"off"``.
    """

    def __init__(self, parts: api.Partitioning, mbrs,
                 config: ServeConfig | None = None, *,
                 device: torch.device | str | None = None,
                 method: str | None = None, mesh=None):
        self.config = config = config if config is not None else ServeConfig()
        _check_ported(config)
        if mesh is not None:
            raise not_ported("mesh", "Queue 1 item 10")
        self.device = resolve(device)
        mbrs = torch.as_tensor(mbrs, dtype=torch.float32, device=self.device)
        self.parts = api.Partitioning(parts.boxes.to(self.device),
                                      parts.valid.to(self.device))
        self.tiles: ReplicatedTiles = build_tiles(self.parts, mbrs, config)
        self.stats = self.tiles.stats
        self.stats["method"] = method
        self.widths = WidthPolicy(cap=self.stats["t_live"])
        self.heat = router.HeatTracker(self.stats["t"],
                                       decay=config.policy.heat_decay,
                                       device=self.device)

    @classmethod
    def from_method(cls, method: str, mbrs, payload: int,
                    config: ServeConfig | None = None, *,
                    device: torch.device | str | None = None
                    ) -> "SpatialServer":
        """Partition ``mbrs`` with ``method`` at ``payload`` and serve."""
        _check_ported(config if config is not None else ServeConfig())
        dev = resolve(device)
        mbrs = torch.as_tensor(mbrs, dtype=torch.float32, device=dev)
        parts = api.partition(method, mbrs, payload)
        return cls(parts, mbrs, config, device=dev, method=method)

    # -- accessors --------------------------------------------------------

    @property
    def probe_boxes(self) -> torch.Tensor:
        return self.tiles.probe_boxes

    @property
    def chunk_boxes(self) -> torch.Tensor | None:
        """The (T, C, 4) local index (None when unindexed)."""
        return self.tiles.chunk_boxes

    @property
    def layout(self) -> StagedLayout:
        return self.tiles.staged

    def _queries(self, qboxes) -> torch.Tensor:
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
        """Device bytes of the resident canonical tiles and ids."""
        return self.tiles.resident_tile_bytes()

    # -- not ported yet ---------------------------------------------------

    def knn(self, *args, **kwargs):
        raise not_ported("SpatialServer.knn", "Queue 1 item 6")

    def append(self, mbrs):
        raise not_ported("SpatialServer.append", "Queue 1 item 9")

    def delete(self, ids):
        raise not_ported("SpatialServer.delete", "Queue 1 item 9")

    def update(self, ids, mbrs):
        raise not_ported("SpatialServer.update", "Queue 1 item 9")

    def compact(self):
        raise not_ported("SpatialServer.compact", "Queue 1 item 9")

    def rebalance(self):
        raise not_ported("SpatialServer.rebalance", "Queue 1 item 11")

    # -- routing (host side, per batch) -----------------------------------

    def _pruned(self, pruned: bool | None) -> None:
        if pruned is False:
            raise not_ported("pruned=False (the dense oracle)", _DENSE_ITEMS)

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
        self.heat.observe(cand)
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
        self._pruned(pruned)
        qboxes = self._queries(qboxes)
        stats = self._fanout_stats(qboxes)
        cand, costs, f = self._route_batch(qboxes)
        counts, xstats = self.tiles.range_counts(qboxes, cand, costs)
        stats.update(mode=self.tiles.mode, f_max=f, **xstats)
        return counts, stats

    def range_ids(self, qboxes, max_hits: int = 1024,
                  pruned: bool | None = None):
        """Exact unique hit-id sets (ascending, -1 padded) + overflow
        -> ``(hit_ids[Q, max_hits], counts[Q], overflow[Q], stats)``."""
        self._pruned(pruned)
        qboxes = self._queries(qboxes)
        stats = self._fanout_stats(qboxes)
        cand, costs, f = self._route_batch(qboxes)
        hit_ids, counts, overflow, xstats = self.tiles.range_ids(
            qboxes, cand, costs, max_hits)
        stats.update(mode=self.tiles.mode, f_max=f, **xstats)
        return hit_ids, counts, overflow, stats
