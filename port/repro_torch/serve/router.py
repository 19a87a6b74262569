"""The global partition index, range half (twin of
``repro.serve.router``).

Range queries route by box overlap: against the partition regions for
the paper's fan-out metric (``route_range``), and against each staged
tile's canonical *probe box* for the pruned executor
(``candidate_range``).  Candidate lists are fixed-width ``(Q, f_max)``
int32 with ``-1`` padding, each query's tiles in ascending order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.partition.api import Partitioning


def route_range(parts: Partitioning, qboxes: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, 4) query boxes -> ((Q, kmax) routing mask, (Q,) fan-out)."""
    mask = geometry.intersects(qboxes[:, None, :], parts.boxes[None, :, :])
    mask = mask & parts.valid[None, :]
    return mask, mask.sum(1, dtype=torch.int32)


def probe_overlap(boxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """(T, 4) probe boxes x (Q, 4) queries -> (Q, T) bool overlap."""
    return geometry.intersects(qboxes[:, None, :], boxes[None, :, :])


def probe_fanout(boxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """(T, 4) x (Q, 4) -> (Q,) int32 overlap fan-out."""
    return probe_overlap(boxes, qboxes).sum(1, dtype=torch.int32)


def candidates_from_overlap(hit: torch.Tensor, f_max: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fixed-width candidate-tile index from an overlap matrix.

    hit: (Q, T) bool -> ``(cand[Q, f_max] int32, fanout[Q] int32,
    overflow[Q] bool)``: each query's overlapping tiles in ascending
    order, ``-1`` past its fan-out; queries overlapping more than
    ``f_max`` tiles are truncated and flagged.  Hits-first order comes
    from a *stable* sort of an integer cast (the reference relies on
    JAX's stable argsort of ``~hit``).
    """
    fanout = hit.sum(1, dtype=torch.int32)
    order = torch.sort((~hit).to(torch.uint8), dim=1, stable=True).indices
    cand = order[:, :f_max]
    live = torch.gather(hit, 1, cand)
    return (torch.where(live, cand, -1).to(torch.int32), fanout,
            fanout > f_max)


def candidate_range(boxes: torch.Tensor, qboxes: torch.Tensor, f_max: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-shot ``probe_overlap`` + ``candidates_from_overlap``."""
    return candidates_from_overlap(probe_overlap(boxes, qboxes), f_max)


class HeatTracker:
    """EWMA per-tile hit counts + tile-pair co-occurrence sketch.

    ``heat[t]``: decayed count of queries whose candidate list held
    tile ``t``; ``cooc[i, j]``: decayed count of queries whose list held
    both.  State lives on the tracker's device in float64.  The 0/1
    co-occurrence sums are exact in any order, and the decay is a
    separate multiply and add (never fused), so a batch sequence gives
    the reference's numpy state bit for bit.
    """

    def __init__(self, t: int, decay: float = 0.85,
                 device: torch.device | str = "cpu"):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.t = int(t)
        self.decay = float(decay)
        self.heat = torch.zeros(self.t, dtype=torch.float64, device=device)
        self.cooc = torch.zeros(self.t, self.t, dtype=torch.float64,
                                device=device)
        self.batches = 0

    def observe(self, cand) -> None:
        """Fold one batch's (Q, F) candidate lists (-1 padding) in."""
        cand = torch.as_tensor(cand, device=self.heat.device)
        if cand.ndim != 2:
            raise ValueError(f"cand must be (Q, F), got {tuple(cand.shape)}")
        # one-hot per query; -1 lands in a spare column that is dropped
        idx = torch.where(cand >= 0, cand, self.t).long()
        hot = torch.zeros(cand.shape[0], self.t + 1, dtype=torch.float64,
                          device=cand.device)
        hot.scatter_(1, idx, 1.0)
        hot = hot[:, :self.t]
        pair = hot.T @ hot                     # (T, T) co-occurrence
        hits = pair.diagonal().clone()
        pair.fill_diagonal_(0.0)
        self.heat = self.decay * self.heat + hits
        self.cooc = self.decay * self.cooc + pair
        self.batches += 1

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of ``(heat[T], cooc[T, T])``."""
        return self.heat.cpu().numpy(), self.cooc.cpu().numpy()
