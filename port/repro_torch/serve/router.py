"""The global partition index (twin of ``repro.serve.router``, single
device).

Range queries route by box overlap: against the partition regions for
the paper's fan-out metric (``route_range``), and against each staged
tile's canonical *probe box* for the pruned executor
(``candidate_range``).  kNN queries route by distance: partitions in
MINDIST order (``route_knn``), and each point's MINDIST frontier of
probe boxes in L∞ order (``candidate_knn``).  Candidate lists are
fixed-width ``(Q, f_max)`` int32 with ``-1`` padding.  Every sort that
stands in for a JAX ``argsort`` is stable.  ``owner_split`` translates
a batch's candidate lists into the sharded placement's per-owner
exchange tables (host numpy, one query at a time, as the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.partition.assign import round_up
from ..core.partition.api import Partitioning
from ..device import resolve
from ..query.knn import mindist2_fused


def route_range(parts: Partitioning, qboxes: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, 4) query boxes -> ((Q, kmax) routing mask, (Q,) fan-out)."""
    mask = geometry.intersects(qboxes[:, None, :], parts.boxes[None, :, :])
    mask = mask & parts.valid[None, :]
    return mask, mask.sum(1, dtype=torch.int32)


def route_knn(parts: Partitioning, pts: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, 2) query points -> best-first partition visit order
    ``(order[Q, kmax] int32, d2[Q, kmax] f32)``: partitions by ascending
    MINDIST² (ties by index), invalid ones last at +inf.  ``d2`` rounds
    as the reference's jitted ``route_knn`` does (``mindist2_fused``)."""
    d2 = mindist2_fused(pts, parts.boxes)
    d2 = torch.where(parts.valid[None, :], d2, torch.inf)
    order = torch.sort(d2, dim=1, stable=True).indices.to(torch.int32)
    return order, d2


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


def linf_dist(pts: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """L∞ distance, point to closed box: (..., 2) x (T, 4) -> (..., T);
    0 inside the box, +inf for sentinel (inverted) boxes."""
    x, y = pts[..., None, 0], pts[..., None, 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    dx = torch.maximum(torch.maximum(boxes[..., 0] - x, x - boxes[..., 2]),
                       zero)
    dy = torch.maximum(torch.maximum(boxes[..., 1] - y, y - boxes[..., 3]),
                       zero)
    return torch.where(boxes[..., 0] <= boxes[..., 2], torch.maximum(dx, dy),
                       torch.inf)


def candidate_knn(boxes: torch.Tensor, pts: torch.Tensor, f_max: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MINDIST frontier: each point's ``f_max`` nearest tiles.

    boxes: (T, 4) probe boxes; pts: (Q, 2) -> ``(cand[Q, f_max] int32,
    dist[Q, f_max] f32, excluded[Q] f32)``: tiles by ascending L∞
    distance, ties by index (many tiles sit at distance 0 from a
    point, so the sort must be stable), ``-1`` where fewer than
    ``f_max`` non-empty tiles exist; ``excluded`` is the distance of
    the nearest tile left out (+inf when none is).
    """
    d = linf_dist(pts, boxes)                          # (Q, T)
    ds, order = torch.sort(d, dim=1, stable=True)
    cand = torch.where(torch.isfinite(ds[:, :f_max]), order[:, :f_max],
                       -1).to(torch.int32)
    if f_max < boxes.shape[0]:
        excluded = ds[:, f_max]
    else:
        excluded = torch.full((pts.shape[0],), torch.inf, device=pts.device)
    return cand, ds[:, :f_max], excluded


class HeatTracker:
    """EWMA per-tile hit counts + tile-pair co-occurrence sketch.

    ``heat[t]``: decayed count of queries whose candidate list held
    tile ``t``; ``cooc[i, j]``: decayed count of queries whose list held
    both.  State lives on the tracker's device in float64.  The 0/1
    co-occurrence sums are exact in any order, and the decay is a
    separate multiply and add (never fused), so a batch sequence gives
    the reference's numpy state bit for bit.  ``device`` defaults to
    ``cuda`` (``repro_torch.device.resolve``).
    """

    def __init__(self, t: int, decay: float = 0.85,
                 device: torch.device | str | None = None):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        device = resolve(device)
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


# --------------------------------------------------------------------------
# owner translation (sharded layouts: global tiles -> (owner, local))
# --------------------------------------------------------------------------

def owner_split(cand: np.ndarray, slots: np.ndarray, owner: np.ndarray,
                local: np.ndarray, bucket: int = 8,
                alt_owner: np.ndarray | None = None,
                alt_local: np.ndarray | None = None,
                ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Translate global candidate lists into per-owner exchange tables.

    cand: (Q, F) int32 global candidate tiles (-1 padding) from
    ``candidate_range`` / ``candidate_knn``; slots: (D, Qpd) query
    packing from ``serve.layout.pack_queries`` (home placement);
    owner/local: (T,) global-tile → (owner device, local shard row)
    maps from ``core.placement.shard_tiles``.

    Returns ``(send_slot[D, D, M], send_cand[D, D, M, F_local], stats)``
    — for home device ``h`` and owner ``o``, message ``m`` carries home
    query slot ``send_slot[h, o, m]`` (-1 padding) together with that
    query's candidate tiles *owned by o, in o's local coordinates*
    (``send_cand``, -1 padded, ascending local order).  A query emits
    one message per owner holding ≥ 1 of its candidates and none to the
    rest, so exchange volume scales with routed fan-out, not D.  ``M``
    and ``F_local`` are maxima over all pairs, rounded up to ``bucket``
    so jitted exchange steps recompile per size bucket, not per batch.

    ``alt_owner``/``alt_local`` (both (T,) int32, ``-1`` = no replica)
    describe a second live copy of some tiles (``HeatSharded``).  A
    replicated candidate may be probed on either owner — both rows are
    bit-exact — so the split routes it to whichever placement helps:
    an owner the query *already* messages (saving a whole message),
    else the owner with the fewest candidate rows gathered so far this
    batch (spreading probe load off the hot device).  Deterministic:
    fixed (home, slot, candidate) order, ties to the primary owner
    then the lower device id.  Each candidate still reaches exactly
    one owner, so the merge stays owner-disjoint and exact.

    Host-side numpy (runs once per batch, O(Q·F)); ``stats`` reports
    the message/width geometry for the serving stats dict, plus the
    per-owner probe load (gathered candidate rows), its max/mean
    imbalance, the padded exchange buffer bytes, and how many
    candidate rows took the alternate replica.
    """
    d, qpd = slots.shape
    send: list[list[list[tuple[int, np.ndarray]]]] = \
        [[[] for _ in range(d)] for _ in range(d)]
    f_local = 1
    n_msgs = 0
    probe_rows = np.zeros(d, np.int64)
    routed_alt = 0
    for h in range(d):
        for s in range(qpd):
            qi = slots[h, s]
            if qi < 0:
                continue
            c = cand[qi]
            c = c[c >= 0]
            if c.size == 0:
                continue
            ow = owner[c].copy()
            lc = local[c].copy()
            if alt_owner is not None:
                flex = np.flatnonzero(alt_owner[c] >= 0)
                if flex.size:
                    fixed_owners = set(np.unique(np.delete(ow, flex)))
                    for k in flex:
                        o1, o2 = int(ow[k]), int(alt_owner[c[k]])
                        if o1 in fixed_owners:
                            pick = o1
                        elif o2 in fixed_owners:
                            pick = o2
                        elif probe_rows[o2] < probe_rows[o1]:
                            pick = o2
                        else:
                            pick = o1
                        if pick != o1:
                            ow[k] = pick
                            lc[k] = alt_local[c[k]]
                            routed_alt += 1
                        fixed_owners.add(pick)
            np.add.at(probe_rows, ow, 1)
            for o in np.unique(ow):
                lt = np.sort(lc[ow == o])
                send[h][int(o)].append((s, lt))
                f_local = max(f_local, int(lt.size))
                n_msgs += 1
    m = max(1, max(len(send[h][o]) for h in range(d) for o in range(d)))
    m = min(qpd, round_up(m, bucket))
    f_local = round_up(f_local, bucket)
    send_slot = np.full((d, d, m), -1, np.int32)
    send_cand = np.full((d, d, m, f_local), -1, np.int32)
    for h in range(d):
        for o in range(d):
            for j, (s, lt) in enumerate(send[h][o]):
                send_slot[h, o, j] = s
                send_cand[h, o, j, :lt.size] = lt
    # Padded all_to_all buffer estimate for one range_counts exchange:
    # forward — per (home, owner) pair, m message slots each carrying a
    # slot id (4 B), a query box (16 B) and f_local local tiles (4 B
    # each); return — one count (4 B) per message slot.
    xbytes = d * d * m * (4 + 16 + 4 * f_local) + d * d * m * 4
    mean_rows = float(probe_rows.mean())
    stats = dict(m_per_pair=m, f_local=f_local, messages=n_msgs,
                 probe_rows=probe_rows.tolist(),
                 probe_load_imbalance=(float(probe_rows.max()) /
                                       max(mean_rows, 1e-9)),
                 exchange_bytes=int(xbytes),
                 routed_alt=int(routed_alt))
    return send_slot, send_cand, stats
