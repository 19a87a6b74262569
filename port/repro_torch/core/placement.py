"""Item -> device placement (the join's part of
``repro.core.placement``: ``tile_costs``, ``lpt_pack``,
``round_robin_pack``; host numpy, as the reference).

Partitions are the paper's unit of parallelism, and the join engine
places its tiles on devices with greedy LPT (longest processing time
first, a 4/3-approximation to makespan) at plan time on the host.  The
capped packer and tile sharding come with the sharded placement
(ROADMAP Queue 1 item 10).
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


def round_robin_pack(costs: np.ndarray, n_devices: int):
    """Baseline packing (a naive tile -> mapper hash), same contract as
    ``lpt_pack``; ignores the weights when placing."""
    t = costs.shape[0]
    assignment = (np.arange(t) % n_devices).astype(np.int32)
    loads = np.zeros(n_devices, np.float64)
    np.add.at(loads, assignment, costs)
    mean = float(loads.mean()) if n_devices else 0.0
    return assignment, float(loads.max()), mean
