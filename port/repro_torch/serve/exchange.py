"""Owner-routed query exchange over sharded tile layouts (twin of
``repro.serve.exchange``, simulation mode).

The sharded placement (``serve.layout.ShardedTiles``) places tiles on
``D`` owner devices and packs each batch's queries onto ``D`` *home*
devices; every batch then runs three moves:

  scatter -- each home sends, per owner, the queries whose candidate
             lists touch that owner's tiles (``router.owner_split``
             translated them to local coordinates on the host), with
             their local candidate lists;
  probe   -- each owner runs the gathered ``range_probe`` executors
             (``query.range`` / ``query.knn``) against its own shard;
  reduce  -- partial counts, id lists and top-k frontiers go back to
             the homes, which merge them (``merge_owner_counts`` /
             ``merge_owner_ids`` / ``merge_knn_partials``): canonical
             copies make hits owner-disjoint, so the merged answers
             equal the dense single-device oracle's bit for bit.

kNN deepening is lock-step: the radius state lives at home, each round
sends the radii out and sums the owners' counts back, and the loop
continues while any query anywhere is short (``query.knn._deepen``,
at most 32 rounds); the frontier-miss check stays the caller's.

Every orchestration is written against the ``_Comm`` seam.  Only its
simulation mode is ported: the ``D`` homes and owners live on one
device as a leading axis of every array, the exchange is a transpose
of that axis, and the owners' probes run *folded*: the shards are one
contiguous ``(D·T_rows, ...)`` staging, owner ``o``'s local candidate
``c`` is row ``o·T_rows + c`` of it, and the received messages of every
owner form one query axis, so each move is one kernel launch over all
owners, not ``D``.  Each (query, candidate) pair is probed on its own,
so the bits equal a loop over the owners.  The mesh mode
(``torch.distributed`` ``all_to_all_single`` behind the same seam,
with an all-reduce for the deepening's continue flag) raises
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import geometry
from ..core.fma import sqrt32
from ..device import not_ported
from ..query import knn as knn_mod
from ..query import range as range_mod


@dataclasses.dataclass(frozen=True)
class Shards:
    """Every owner's shard as one flat staging: row ``o·t_rows + l`` is
    owner ``o``'s local row ``l``.

    tiles (D·T_rows, cap, 4) canonical member boxes; ids (D·T_rows,
    cap) int32; alive (D·T_rows, cap) bool; cboxes (D·T_rows, C, 4)
    chunk boxes or None (unindexed); extent (D·T_rows,) int32 live
    extent a shard row.  Each is a view of the contiguous ``(D, T_rows,
    ...)`` shard array.
    """

    tiles: torch.Tensor
    ids: torch.Tensor
    alive: torch.Tensor
    cboxes: torch.Tensor | None
    extent: torch.Tensor
    t_rows: int


class _Comm:
    """The sharded/simulated seam.  ``axis=None`` is the in-process
    simulation: ``exchange`` transposes the leading (home, owner) axes
    and ``fold`` lays every owner's received candidates over the flat
    shards; a mesh axis is not ported."""

    def __init__(self, axis: str | None = None):
        if axis is not None:
            raise not_ported("mesh", "Queue 1 item 10")

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Device transpose: row ``o`` of the result came from device
        ``o``.  Contiguous, so no strided view reaches a kernel."""
        return x.transpose(0, 1).contiguous()

    def fold(self, cand: torch.Tensor, t_rows: int) -> torch.Tensor:
        """Received local candidates ``(D_owner, ..., F_local)`` -> the
        flat ``(rows, F_local)`` int32 candidates over ``Shards``: owner
        ``o``'s local tile ``c`` becomes ``o·t_rows + c``; ``-1`` stays
        ``-1``."""
        d = cand.shape[0]
        base = (torch.arange(d, device=cand.device, dtype=torch.int32)
                * t_rows).view((d,) + (1,) * (cand.ndim - 1))
        flat = torch.where(cand >= 0, cand + base, -1)
        return flat.reshape(-1, cand.shape[-1]).to(torch.int32).contiguous()


def _gather_send(x: torch.Tensor, slots: torch.Tensor, pad) -> torch.Tensor:
    """Home-side send buffers: (D, Qpd, ...) x (D, D, M) slots ->
    (D, D, M, ...), ``pad`` where a message slot is -1."""
    h = torch.arange(x.shape[0], device=x.device)[:, None, None]
    out = x[h, slots.clamp_min(0).long()]
    live = (slots >= 0).view(slots.shape + (1,) * (out.ndim - 3))
    return torch.where(live, out, torch.as_tensor(pad, dtype=x.dtype,
                                                  device=x.device))


# --------------------------------------------------------------------------
# orchestrations
# --------------------------------------------------------------------------

def serve_range_counts(comm: _Comm, q: torch.Tensor, sl: torch.Tensor,
                       sc: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Sharded exact range counts: scatter -> folded probe -> sum merge.

    q (D, Qpd, 4) home query shards; sl (D, D, M) message slots of
    each (home, owner) pair; sc (D, D, M, Fl) their owner-local
    candidate lists -> (D, Qpd) int32.  The chunk-skipping probe runs
    when ``sh.cboxes`` is given (same bits).
    """
    d, m = sl.shape[0], sl.shape[-1]
    qr = comm.exchange(_gather_send(q, sl, geometry.sentinel(q.device)))
    cr = comm.fold(comm.exchange(sc), sh.t_rows)
    per = range_mod.pruned_range_counts(
        qr.reshape(-1, 4), sh.tiles, cr, chunk_boxes=sh.cboxes,
        alive=sh.alive, extent=sh.extent)
    pb = comm.exchange(per.view(d, d, m))
    return range_mod.merge_owner_counts(pb, sl, q.shape[1])


def serve_range_ids(comm: _Comm, q: torch.Tensor, sl: torch.Tensor,
                    sc: torch.Tensor, sh: Shards, *, max_hits: int,
                    mh_local: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded exact unique id sets: scatter -> folded ids -> union
    merge.  As ``serve_range_counts``; ``mh_local`` bounds each owner's
    partial list (callers pass ``min(max_hits, Fl·cap)``) ->
    ``(hit_ids[D, Qpd, max_hits], counts[D, Qpd], overflow[D, Qpd])``.
    """
    d, m = sl.shape[0], sl.shape[-1]
    qr = comm.exchange(_gather_send(q, sl, geometry.sentinel(q.device)))
    cr = comm.fold(comm.exchange(sc), sh.t_rows)
    hids, counts, _ = range_mod.pruned_range_ids(
        qr.reshape(-1, 4), sh.tiles, sh.ids, cr, mh_local,
        chunk_boxes=sh.cboxes, alive=sh.alive, extent=sh.extent)
    bids = comm.exchange(hids.view(d, d, m, mh_local))
    bcounts = comm.exchange(counts.view(d, d, m))
    return range_mod.merge_owner_ids(bids, bcounts, sl, q.shape[1], max_hits)


def serve_knn(comm: _Comm, pts: torch.Tensor, sl: torch.Tensor,
              sc: torch.Tensor, dead: torch.Tensor, sh: Shards,
              uni: torch.Tensor, n_live: int, *, k: int, max_cand: int,
              max_rounds: int = 32):
    """Sharded exact kNN: lock-step deepening + top-k frontier merge.

    pts (D, Qpd, 2) home shards; sl/sc as in the range moves; dead
    (D, Qpd) marks padding slots (they start at the covering radius);
    uni (4,) the dataset universe; ``n_live`` the *global* live member
    count, so the first radius is the single-device paths' ->
    ``(nn_ids[D, Qpd, k], nn_d2[D, Qpd, k], radius[D, Qpd],
    overflow[D, Qpd], rounds[D, Qpd])``.  Each deepening round recounts
    the homes whose radius moved: their messages' boxes go to the
    owners as one folded counts launch, and the partial counts come
    back and merge.  ``overflow`` flags an owner's extraction past
    ``max_cand``.
    """
    d, qpd = pts.shape[:2]
    m = sl.shape[-1]
    dev = pts.device
    pad_pt = (uni[:2] + uni[2:]) * 0.5
    pr = comm.exchange(_gather_send(pts, sl, pad_pt)).reshape(-1, 2)
    cr = comm.fold(comm.exchange(sc), sh.t_rows)
    # each received message's home query as a flat index h·Qpd + slot
    home = torch.arange(d, device=dev)[:, None, None] * qpd + sl
    home = comm.exchange(torch.where(sl >= 0, home, -1)).reshape(-1)

    diag = sqrt32(torch.sum((uni[2:] - uni[:2]) ** 2))
    r_init = knn_mod.initial_radius(diag, k, n_live)
    p = pts.reshape(-1, 2)
    r_cover = torch.maximum(
        torch.maximum(p[:, 0] - uni[0], uni[2] - p[:, 0]),
        torch.maximum(p[:, 1] - uni[1], uni[3] - p[:, 1]))
    r_cover = torch.maximum(r_cover, diag * 1e-6)

    def counts_at(r, rows):
        """Unique counts of home queries ``rows`` at radii ``r``: their
        live messages probed in one folded launch, then merged."""
        rad = torch.zeros(d * qpd, dtype=torch.float32, device=dev)
        rad[rows] = r
        want = torch.zeros(d * qpd + 1, dtype=torch.bool, device=dev)
        want[rows] = True
        msg = want[home].nonzero().squeeze(1)          # home -1 -> want[-1]
        rm = rad[home[msg]][:, None]
        qb = torch.cat([pr[msg] - rm, pr[msg] + rm], dim=-1)
        part = torch.zeros(d * d * m, dtype=torch.int32, device=dev)
        part[msg] = range_mod.pruned_range_counts(
            qb, sh.tiles, cr[msg], chunk_boxes=sh.cboxes, alive=sh.alive,
            extent=sh.extent)
        pb = comm.exchange(part.view(d, d, m))
        return range_mod.merge_owner_counts(pb, sl, qpd).reshape(-1)[rows]

    r0 = torch.where(dead.reshape(-1), r_cover, r_init)
    r, rounds = knn_mod._deepen(counts_at, r0, r_cover, k, max_rounds)

    # refinement: owners extract local top-k within the √2-inflated box
    re = r * knn_mod._SQRT2_F32
    rr = comm.exchange(_gather_send(re.view(d, qpd), sl, 0.0)).reshape(-1)
    nn_i, nn_d, nc = knn_mod.knn_partial(
        pr, sh.tiles, sh.ids, cr, rr, k, max_cand=max_cand,
        chunk_boxes=sh.cboxes, alive=sh.alive, extent=sh.extent)
    kk = nn_i.shape[-1]
    nn_ids, nn_d2 = knn_mod.merge_knn_partials(
        comm.exchange(nn_i.view(d, d, m, kk)),
        comm.exchange(nn_d.view(d, d, m, kk)), sl, qpd, k)
    bnc = comm.exchange(nc.view(d, d, m))
    over = range_mod.merge_owner_counts((bnc > max_cand).to(torch.int32), sl,
                                        qpd) > 0
    return nn_ids, nn_d2, r.view(d, qpd), over, rounds.view(d, qpd)
