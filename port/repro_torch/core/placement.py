"""Item -> device placement (twin of ``repro.core.placement``; host
numpy, as the reference).

Partitions are the paper's unit of parallelism.  The join engine
places its tiles on devices, and the serving stack its queries on home
devices and its tile shards on owner devices, all with greedy LPT
(longest processing time first, a 4/3-approximation to makespan) at
plan time on the host.  ``lpt_pack_capped`` bounds the items a device
holds, and ``shard_tiles`` caps it at ``ceil(T/D)``, so every owner's
staged memory is at most one tile over an even split.
``colocate_tiles`` refines a capped plan to cut the tile pairs that
queries fetch from two owners (the heat placement's planner).
"""
from __future__ import annotations

import numpy as np


def tile_costs(nr: np.ndarray, ns: np.ndarray) -> np.ndarray:
    """Per-tile join cost ``c_i = |R_i| * |S_i|`` (section 2.3).

    nr, ns: (T,) per-tile payload counts -> (T,) float64 costs.
    """
    return nr.astype(np.float64) * ns.astype(np.float64)


def lpt_pack(costs: np.ndarray, n_devices: int):
    """Greedy LPT -> ``(device[T] int32, makespan, mean_load)``.

    Equal weights degrade to round-robin placement (ties to the lowest
    device id); an all-zero vector leaves everything on device 0.
    """
    t = costs.shape[0]
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_devices, np.float64)
    assignment = np.zeros(t, np.int32)
    for i in order:
        d = int(np.argmin(loads))
        assignment[i] = d
        loads[d] += costs[i]
    mean = float(loads.mean()) if n_devices else 0.0
    return assignment, float(loads.max()), mean


def lpt_pack_capped(costs: np.ndarray, n_devices: int, max_per_device: int):
    """LPT under a per-device item-count cap (capacitated scheduling).

    Same contract as ``lpt_pack`` but no device receives more than
    ``max_per_device`` items: each item goes to the least-loaded device
    that still has a free slot.  Raises if ``n_devices·max_per_device``
    cannot hold every item.  The cap is what turns cost balancing into
    a *memory* guarantee — with ``max_per_device = ceil(T/D)`` no
    device stores more than one item over an even split.
    """
    t = costs.shape[0]
    if n_devices * max_per_device < t:
        raise ValueError(
            f"cannot place {t} items on {n_devices} devices with "
            f"cap {max_per_device}")
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_devices, np.float64)
    counts = np.zeros(n_devices, np.int64)
    assignment = np.zeros(t, np.int32)
    for i in order:
        open_ = np.flatnonzero(counts < max_per_device)
        d = int(open_[np.argmin(loads[open_])])
        assignment[i] = d
        loads[d] += costs[i]
        counts[d] += 1
    mean = float(loads.mean()) if n_devices else 0.0
    return assignment, float(loads.max()), mean


def round_robin_pack(costs: np.ndarray, n_devices: int):
    """Baseline packing (a naive tile -> mapper hash), same contract as
    ``lpt_pack``; ignores the weights when placing."""
    t = costs.shape[0]
    assignment = (np.arange(t) % n_devices).astype(np.int32)
    loads = np.zeros(n_devices, np.float64)
    np.add.at(loads, assignment, costs)
    mean = float(loads.mean()) if n_devices else 0.0
    return assignment, float(loads.max()), mean


def shard_tiles(costs: np.ndarray, n_devices: int,
                prev_owner: np.ndarray | None = None,
                cooc: np.ndarray | None = None,
                balance_tol: float = 1.25,
                ) -> tuple[np.ndarray, np.ndarray, int, dict]:
    """Assign tiles to owner devices and local shard slots.

    costs: (T,) per-tile weights (member counts for serving shards)
    -> ``(owner[T] int32, local[T] int32, t_local, stats)``.

    ``owner[t]`` is the device holding tile ``t``; ``local[t]`` its
    row in that device's ``(t_local, ...)`` shard.  Placement is
    cost-balanced LPT capped at ``t_local = ceil(T/D)`` items per
    device, so per-device shard memory is at most one tile over an
    even split regardless of the cost distribution (an uncapped LPT
    piles all zero-cost tiles onto one device).  Local slots are
    assigned in ascending global-tile order per device, so the
    global → (owner, local) map is deterministic.

    ``prev_owner`` (the map being replaced, on a streaming re-balance)
    is reporting-only: ``stats['moved']`` counts tiles whose owner
    changed — the data-movement cost of the re-balance — without
    biasing the placement itself (the memory cap, not placement
    stickiness, is the guarantee re-staging relies on).

    ``cooc`` (a ``(T, T)`` tile-pair co-occurrence weight matrix from
    the router heat tracker) switches placement to the heat-aware
    co-locating refinement ``colocate_tiles``: tiles that co-occur in
    candidate lists land on the same owner so exchange fan-out stops
    crossing devices, still under the same ``ceil(T/D)`` cap.  With
    ``cooc`` a valid ``prev_owner`` additionally *seeds* the plan
    (move-minimising local search) rather than only scoring it.
    """
    t = costs.shape[0]
    d = max(1, n_devices)
    t_local = -(-t // d)                       # ceil(T/D)
    if cooc is not None and t > 0:
        owner, makespan, mean, cstats = colocate_tiles(
            costs, cooc, d, t_local, prev_owner=prev_owner,
            balance_tol=balance_tol)
    else:
        owner, makespan, mean = lpt_pack_capped(costs, d, t_local)
        cstats = {}
    local = np.zeros(t, np.int32)
    for dev in range(d):
        mine = np.flatnonzero(owner == dev)
        local[mine] = np.arange(mine.size, dtype=np.int32)
    stats = dict(t_local=t_local, makespan=makespan, mean_load=mean,
                 skew=makespan / max(mean, 1e-9), **cstats)
    if prev_owner is not None and prev_owner.shape[0] == t:
        stats["moved"] = int(np.sum(owner != prev_owner))
    return owner.astype(np.int32), local, t_local, stats


def colocate_tiles(costs: np.ndarray, cooc: np.ndarray, n_devices: int,
                   max_per_device: int,
                   prev_owner: np.ndarray | None = None,
                   balance_tol: float = 1.25, sweeps: int = 4):
    """Capped placement that minimises the co-occurrence cut.

    costs: (T,) per-tile weights; cooc: (T, T) symmetric-ish pair
    weights (``cooc[i, j]`` ≈ how often tiles i and j appear in the
    same query's candidate list) -> ``(owner[T] int32, makespan,
    mean_load, stats)``.

    This is the serving-side version of Kolb et al.'s hot-block
    grouping: the objective is the weighted *cut* — co-occurrence mass
    between tiles on different owners — because every cut pair is a
    query that must message two devices through the exchange.  Greedy
    local search (single moves, then pairwise swaps once devices fill
    up) from either the previous plan (move-minimising: tiles only
    move when the cut pays for it) or a fresh capped LPT.  Moves keep
    the per-device item cap and a load tolerance — a move may not push
    a device's cost load past ``balance_tol ×`` the mean unless it
    stays below the source device's load, so makespan stays bounded
    while the cut drops.  Deterministic: fixed sweep order (descending
    cost, stable), ties to the lowest device id.
    """
    t = costs.shape[0]
    d = max(1, n_devices)
    costs = np.asarray(costs, np.float64)
    w = np.asarray(cooc, np.float64)
    w = w + w.T                                # symmetrise
    np.fill_diagonal(w, 0.0)

    if (prev_owner is not None and prev_owner.shape[0] == t
            and np.all((prev_owner >= 0) & (prev_owner < d))
            and np.all(np.bincount(prev_owner, minlength=d)
                       <= max_per_device)):
        owner = prev_owner.astype(np.int32).copy()
    else:
        owner, _, _ = lpt_pack_capped(costs, d, max_per_device)
        owner = owner.astype(np.int32)

    loads = np.zeros(d, np.float64)
    np.add.at(loads, owner, costs)
    counts = np.bincount(owner, minlength=d).astype(np.int64)
    mean = float(costs.sum() / d)

    def onehot(o):
        e = np.zeros((t, d), np.float64)
        e[np.arange(t), o] = 1.0
        return e

    def cut(o):
        same = o[:, None] == o[None, :]
        return float(w[~same].sum() / 2.0)

    cut_before = cut(owner)
    order = np.argsort(-costs, kind="stable")
    for _ in range(max(1, sweeps)):
        moved_any = False
        # affinity[i, dev] = co-occurrence mass tile i shares with dev
        aff = w @ onehot(owner)
        for i in order:
            src = owner[i]
            gain = aff[i] - aff[i, src]        # cut reduction per target
            gain[src] = 0.0
            for dst in np.argsort(-gain, kind="stable"):
                if gain[dst] <= 0.0:
                    break
                if dst == src or counts[dst] >= max_per_device:
                    continue
                new_load = loads[dst] + costs[i]
                if new_load > balance_tol * max(mean, 1e-9) and \
                        new_load > loads[src]:
                    continue
                aff -= np.outer(w[:, i], onehot(owner)[i])
                owner[i] = dst
                aff += np.outer(w[:, i], onehot(owner)[i])
                loads[src] -= costs[i]; loads[dst] += costs[i]
                counts[src] -= 1; counts[dst] += 1
                moved_any = True
                break
        # swap pass: when devices are full, single moves stall — trade
        # pairs across the heaviest cut edges instead.
        aff = w @ onehot(owner)
        ii, jj = np.nonzero(np.triu(w, 1))
        edge_order = np.argsort(-w[ii, jj], kind="stable")
        for e in edge_order[:4 * t]:
            i, j = int(ii[e]), int(jj[e])
            oi, oj = owner[i], owner[j]
            if oi == oj:
                continue
            gain = (aff[i, oj] + aff[j, oi] - aff[i, oi] - aff[j, oj]
                    - 2.0 * w[i, j])
            if gain <= 0.0:
                continue
            di, dj = costs[i] - costs[j], costs[j] - costs[i]
            if max(loads[oi] + dj, loads[oj] + di) > \
                    balance_tol * max(mean, 1e-9) and \
                    max(loads[oi] + dj, loads[oj] + di) > \
                    max(loads[oi], loads[oj]):
                continue
            owner[i], owner[j] = oj, oi
            loads[oi] += dj; loads[oj] += di
            aff = w @ onehot(owner)
            moved_any = True
        if not moved_any:
            break

    cut_after = cut(owner)
    stats = dict(cut_before=cut_before, cut_after=cut_after)
    return owner, float(loads.max()), mean, stats
