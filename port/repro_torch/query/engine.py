"""Spatial-join engine (the paper's Algorithm 1), torch twin of
``repro.query.engine`` on one card.

Phases, as the reference's:
  A. partition  -- any of the six layouts on the merged R u S;
  B. staging    -- MASJ assignment into padded, masked tiles;
  C. planning   -- cost-model LPT packing of tiles onto devices;
  D. tile joins -- the ``mbr_join`` kernels per tile;
  E. boundary   -- reference-point ownership (non-overlapping layouts)
                   or the paper's gather + global sort-unique dedup.

``plan_join`` builds the reference's ``JoinPlan`` bit for bit for any
``n_devices`` (planning is host work), from the O(nnz) membership
pairs instead of the reference's ``(N, kmax)`` rank table.  Execution
runs every tile of a plan together, for any ``n_devices``, where the
reference ``lax.map``s inside ``shard_map``: the plan's ``(D, Tpd,
...)`` arrays are viewed as ``(D·Tpd, ...)``, one launch counts every
tile's rp-owned pairs (``mbr_join.ops.tile_rp_counts``) or, for the
raw count (``dedup="none"``), every tile's pairs (``tile_raw_counts``),
and the sum stands for the reference's ``psum``; count, scan and emit
list every tile's pairs (``tile_pair_list``), device row after device
row, which is the reference's ``all_gather``.  Under a process mesh
(``launch.mesh``, one rank a device row of a ``D``-device plan that
every rank built alike) each rank runs the same launches over its own
row, the counts are summed with ``all_reduce`` and the pair lists
gathered in rank order with ``all_gather``.

Live sizes.  The reference joins every tile at the global padded
``cap_r x cap_s``, which under skew is quadratic waste (one hotspot
tile can be tens of times the mean).  A tile's live members are a
prefix of its slots, padding never matches, and ``nonzero`` keeps
row-major order, so each tile is joined at its live size (rounded up
to the kernels' blocks) with the same count and the same pair order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import geometry
from ..core.partition import api
from ..core.partition.assign import assign_from_pairs, membership, round_up
from ..device import resolve
from ..kernels.mbr_join import ops as mops
from . import balance
from . import dedup as dd


@dataclasses.dataclass
class JoinPlan:
    """Device-shaped staging of one co-partitioned join.  The arrays are
    tensors with a leading device axis D; ``live_r``/``live_s`` give
    each tile's live slot count (a prefix of its slots) on the host."""
    r_tiles: torch.Tensor     # (D, Tpd, cap_r, 4)
    r_ids: torch.Tensor       # (D, Tpd, cap_r) int32, -1 in padding
    s_tiles: torch.Tensor     # (D, Tpd, cap_s, 4)
    s_ids: torch.Tensor       # (D, Tpd, cap_s)
    tile_boxes: torch.Tensor  # (D, Tpd, 4), sentinel in unused slots
    universe: torch.Tensor    # (4,)
    stats: dict
    live_r: np.ndarray        # (D, Tpd) int64
    live_s: np.ndarray
    # the card's layout of the batched tile passes, built at first use,
    # keyed by the device row it covers (None: every row)
    meta: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)


def _boxes(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=dev)


def _stage(mbrs: torch.Tensor, parts: api.Partitioning):
    """MASJ members of every partition -> ``(counts, members, mask)``."""
    obj, part = membership(parts, mbrs, adopt=False)
    counts = torch.bincount(part, minlength=parts.kmax)
    cap = round_up(max(int(counts.max()), 1), 128)
    members, mask, overflow = assign_from_pairs(obj, part, parts.kmax, cap)
    assert int(overflow.sum()) == 0
    return counts, members, mask, cap


def _place(mbrs, members, mask, dest, shape, cap):
    """Scatter the kept tiles' members to their (device, slot) rows."""
    dev = mbrs.device
    sentinel = geometry.sentinel(dev)
    tiles = sentinel.expand(shape[0] * shape[1], cap, 4).clone()
    ids = torch.full((shape[0] * shape[1], cap), -1, dtype=torch.int32,
                     device=dev)
    tiles[dest] = torch.where(mask[..., None], mbrs[members.long()], sentinel)
    ids[dest] = torch.where(mask, members, -1)
    return tiles.reshape(*shape, cap, 4), ids.reshape(*shape, cap)


def plan_join(method: str, r, s, payload: int, n_devices: int,
              packer: str = "lpt", parts: api.Partitioning | None = None,
              *, device: torch.device | str | None = None) -> JoinPlan:
    """Host-side planning: layout, MASJ staging, LPT packing.

    r, s: (N, 4) / (M, 4) MBRs -> ``JoinPlan`` with ``(D, Tpd, cap, 4)``
    tiles (sentinel-padded, id -1 in padding slots) on ``device``
    (``cuda`` unless given) and the reference's packing and lambda
    stats.  Capacities are sized from the true max tile payload.
    """
    dev = resolve(device)
    r, s = _boxes(r, dev), _boxes(s, dev)
    merged = torch.cat([r, s])
    if parts is None:
        parts = api.partition(method, merged, payload)
    else:
        parts = api.Partitioning(parts.boxes.to(dev), parts.valid.to(dev))
    uni = geometry.universe(merged)

    counts_r, mem_r, mask_r, cap_r = _stage(r, parts)
    counts_s, mem_s, mask_s, cap_s = _stage(s, parts)
    keep = torch.nonzero(parts.valid).flatten()
    t = keep.shape[0]
    nr = counts_r[keep].cpu().numpy()
    ns = counts_s[keep].cpu().numpy()
    costs = balance.tile_costs(nr, ns)
    pack = balance.lpt_pack if packer == "lpt" else balance.round_robin_pack
    assigned, makespan, mean_load = pack(costs, n_devices)

    tpd = max(1, math.ceil(t / n_devices))
    dest = np.empty(t, np.int64)
    slot = np.zeros(n_devices, np.int64)
    for i in range(t):
        d = assigned[i]
        if slot[d] >= tpd:   # LPT balances cost, not tile count: spill
            d = int(np.argmin(slot))
        dest[i] = d * tpd + slot[d]
        slot[d] += 1
    shape = (n_devices, tpd)
    dest_t = torch.from_numpy(dest).to(dev)
    r_tiles, r_ids = _place(r, mem_r[keep], mask_r[keep], dest_t, shape,
                            cap_r)
    s_tiles, s_ids = _place(s, mem_s[keep], mask_s[keep], dest_t, shape,
                            cap_s)
    tile_boxes = geometry.sentinel(dev).expand(n_devices * tpd, 4).clone()
    tile_boxes[dest_t] = parts.boxes[keep]
    live_r = np.zeros(n_devices * tpd, np.int64)
    live_s = np.zeros(n_devices * tpd, np.int64)
    live_r[dest], live_s[dest] = nr, ns

    stats = dict(
        k=t, cap_r=cap_r, cap_s=cap_s, tpd=tpd,
        makespan=makespan, mean_load=mean_load,
        skew=makespan / max(mean_load, 1e-9),
        lambda_r=float(counts_r.sum()) / r.shape[0] - 1.0,
        lambda_s=float(counts_s.sum()) / s.shape[0] - 1.0,
        method=method,
        overlapping=api.info(method).overlapping if method in api.methods()
        else True,
    )
    return JoinPlan(r_tiles, r_ids, s_tiles, s_ids,
                    tile_boxes.reshape(n_devices, tpd, 4), uni, stats,
                    live_r.reshape(shape), live_s.reshape(shape))


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _one_card(plan: JoinPlan, mesh) -> tuple:
    """A plan's tiles as one card's: ``(r_tiles, s_tiles, r_ids, s_ids,
    tile_boxes, live_r, live_s)`` with the device axis folded into the
    tile axis (free views; the live sizes on the host).  Under a mesh,
    the rank's own device row."""
    arrays = (plan.r_tiles, plan.s_tiles, plan.r_ids, plan.s_ids,
              plan.tile_boxes)
    if mesh is not None:
        if plan.r_tiles.shape[0] != mesh.size:
            raise ValueError(f"a plan for {plan.r_tiles.shape[0]} devices "
                             f"on a mesh of {mesh.size} ranks")
        r = mesh.rank
        return tuple(a[r] for a in arrays) + (plan.live_r[r],
                                              plan.live_s[r])
    return tuple(a.flatten(0, 1) for a in arrays) + (
        plan.live_r.reshape(-1), plan.live_s.reshape(-1))


def _meta(plan: JoinPlan, mesh=None):
    """The batched passes' work items on the plan's card (None on the
    CPU) over the tiles ``_one_card`` gives, laid out once a plan and
    device row."""
    if plan.r_tiles.device.type != "cuda":
        return None
    key = None if mesh is None else mesh.rank
    if key not in plan.meta:
        plan.meta[key] = mops.kernel.tile_meta(*_one_card(plan, mesh)[5:],
                                               plan.r_tiles.device)
    return plan.meta[key]


def tile_counts(plan: JoinPlan, mesh=None, axis: str | None = None,
                dedup: str = "rp") -> torch.Tensor:
    """Per-tile pair counts -> (D·Tpd,) int64 in the plan's (device,
    slot) order (0 for slots with no live pair; a rank's (Tpd,) under
    a mesh); ``dedup`` as in ``run_join_count``.  Either count is one
    batched pass over every tile of every device row."""
    rt, st, _, _, tb, live_r, live_s = _one_card(plan, mesh)
    meta = _meta(plan, mesh)
    if dedup == "none":
        return mops.tile_raw_counts(rt, st, live_r, live_s, meta)
    return mops.tile_rp_counts(rt, st, tb, plan.universe, live_r, live_s,
                               meta)


def run_join_count(plan: JoinPlan, mesh=None, axis: str | None = None,
                   dedup: str = "rp") -> int:
    """Execute a planned join count: the sum of every device row's tile
    counts (the reference's ``psum``).  With ``dedup='rp'`` the result
    is the exact duplicate-free pair count for non-overlapping layouts;
    ``dedup='none'`` returns the raw MASJ count (replicated pairs
    included).  Under a mesh each rank sums its row and the ranks'
    sums are all-reduced."""
    total = tile_counts(plan, mesh, axis, dedup).sum().view(1)
    if mesh is not None:
        total = mesh.all_reduce(total, "sum")
    return int(total)


def spatial_join_count(plan: JoinPlan, mesh=None, axis: str | None = None,
                       max_pairs_per_tile: int = 4096) -> int:
    """Dedup-mode-aware join count.

    Reference-point ownership is exact only for non-overlapping layouts
    (Table 1: FG/BSP/SLC/BOS); the overlapping tight-MBR layouts
    (STR/HC) take the paper's MASJ materialise + dedup path.
    """
    if plan.stats.get("overlapping", True):
        return run_join_pairs_masj(plan, mesh, axis, max_pairs_per_tile)
    return run_join_count(plan, mesh, axis, dedup="rp")


def masj_pairs(plan: JoinPlan, mesh=None, axis: str | None = None,
               max_pairs_per_tile: int = 4096, stats: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's MASJ: every tile's pairs (duplicates included),
    gathered device row after device row (the reference's
    ``all_gather``) -> ``(rid, sid, uniq)``, ``uniq`` marking the first
    copy of each distinct pair (``dedup.unique_pairs``).

    As in the reference, a tile with more than ``max_pairs_per_tile``
    pairs keeps its first ones and silently drops the rest; ``stats``,
    if given, receives ``truncated_tiles``, ``max_tile_pairs`` and
    ``pairs`` (the candidates gathered).  Padding is not gathered: the
    reference pads every tile's list to ``max_pairs_per_tile`` with
    (-1, -1), which ``unique_pairs`` never counts.  Under a mesh each
    rank lists its row's pairs and the lists (and per-tile counts) are
    gathered in rank order, so every rank holds the same ``(rid, sid,
    uniq)``.
    """
    rt, st, rids, sids, _, live_r, live_s = _one_card(plan, mesh)
    rid, sid, n = mops.tile_pair_list(rt, st, rids, sids, live_r, live_s,
                                      max_pairs_per_tile,
                                      _meta(plan, mesh))
    if mesh is not None:
        rid, sid = (mesh.all_gather_v(x) for x in (rid, sid))
        n = mesh.all_gather(n).reshape(-1)
    uniq = dd.unique_pairs(rid, sid)[1]
    if stats is not None:
        stats.update(
            truncated_tiles=int((n > max_pairs_per_tile).sum()),
            max_tile_pairs=int(n.max()) if n.numel() else 0,
            pairs=rid.shape[0])
    return rid, sid, uniq


def run_join_pairs_masj(plan: JoinPlan, mesh=None, axis: str | None = None,
                        max_pairs_per_tile: int = 4096,
                        stats: dict | None = None) -> int:
    """The paper's MASJ count: materialise per-tile pairs, gather them,
    global sort-unique dedup (``masj_pairs``) -> distinct pairs."""
    return int(masj_pairs(plan, mesh, axis, max_pairs_per_tile,
                          stats)[2].sum())
