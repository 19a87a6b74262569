"""Owner-routed query exchange over sharded tile layouts (twin of
``repro.serve.exchange``).

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

Every orchestration is written once against the ``_Comm`` seam and
runs in two modes:

- **in-process simulation** (``_Comm(None)``): the ``D`` homes and
  owners live on one device as a leading axis of every array, the
  exchange is a transpose of that axis, and the owners' probes run
  *folded*: the shards are one contiguous ``(D·T_rows, ...)`` staging,
  owner ``o``'s local candidate ``c`` is row ``o·T_rows + c`` of it,
  and the received messages of every owner form one query axis, so
  each move is one kernel launch over all owners, not ``D``;
- **SPMD over a process mesh** (``_Comm(mesh)``, ``launch.mesh``):
  each rank is one home and one owner.  Its arrays keep a leading axis
  of 1 (``(1, Qpd, ...)`` queries, ``(1, D, M)`` message tables), the
  exchange is an ``all_to_all_single`` over the second axis, a rank's
  shard is ``(T_rows, ...)`` (no ``o·T_rows`` offset), and the
  deepening's continue flag is an all-reduced ``max``, so every rank
  runs the same rounds and reaches the same collectives.

Each (query, candidate) pair is probed on its own, so the bits equal a
loop over the owners in both modes.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import geometry
from ..core.fma import sqrt32
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
    """The sharded seam.  ``mesh=None`` is the in-process simulation:
    ``exchange`` transposes the leading (home, owner) axes and ``fold``
    lays every owner's received candidates over the flat shards.  A
    ``launch.mesh.ProcessMesh`` makes each rank one home and one owner:
    ``exchange`` is an ``all_to_all_single`` of the ``(1, D, ...)``
    send buffers, ``fold`` keeps the rank's local rows, and ``any`` is
    global."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Device transpose: row ``o`` of the result came from device
        ``o``.  Contiguous, so no strided view reaches a kernel."""
        if self.mesh is None:
            return x.transpose(0, 1).contiguous()
        return self.mesh.all_to_all(x[0])[None]

    def fold(self, cand: torch.Tensor, t_rows: int) -> torch.Tensor:
        """Received local candidates ``(D_owner, ..., F_local)`` -> the
        flat ``(rows, F_local)`` int32 candidates over ``Shards``: owner
        ``o``'s local tile ``c`` becomes ``o·t_rows + c`` (a rank's own
        shard: ``c``); ``-1`` stays ``-1``."""
        flat = cand
        if self.mesh is None:
            d = cand.shape[0]
            base = (torch.arange(d, device=cand.device, dtype=torch.int32)
                    * t_rows).view((d,) + (1,) * (cand.ndim - 1))
            flat = torch.where(cand >= 0, cand + base, -1)
        return flat.reshape(-1, cand.shape[-1]).to(torch.int32).contiguous()

    def any(self, flag: torch.Tensor) -> bool:
        """``any`` over every home: all-reduced under a mesh, so a loop
        whose body holds collectives runs the same rounds on every
        rank (the reference's ``psum``-reduced flag)."""
        if self.mesh is None:
            return bool(flag.any())
        return self.mesh.any(flag)


def _gather_send(x: torch.Tensor, slots: torch.Tensor, pad) -> torch.Tensor:
    """Home-side send buffers: (H, Qpd, ...) x (H, D, M) slots ->
    (H, D, M, ...), ``pad`` where a message slot is -1."""
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

    q (H, Qpd, 4) home query shards; sl (H, D, M) message slots of
    each (home, owner) pair; sc (H, D, M, Fl) their owner-local
    candidate lists -> (H, Qpd) int32.  ``H`` is ``D`` in the
    simulation and 1 (the rank's own home) under a mesh.  The
    chunk-skipping probe runs when ``sh.cboxes`` is given (same bits).
    """
    qr = comm.exchange(_gather_send(q, sl, geometry.sentinel(q.device)))
    cr = comm.fold(comm.exchange(sc), sh.t_rows)
    per = range_mod.pruned_range_counts(
        qr.reshape(-1, 4), sh.tiles, cr, chunk_boxes=sh.cboxes,
        alive=sh.alive, extent=sh.extent)
    pb = comm.exchange(per.view(sl.shape))
    return range_mod.merge_owner_counts(pb, sl, q.shape[1])


def serve_range_ids(comm: _Comm, q: torch.Tensor, sl: torch.Tensor,
                    sc: torch.Tensor, sh: Shards, *, max_hits: int,
                    mh_local: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded exact unique id sets: scatter -> folded ids -> union
    merge.  As ``serve_range_counts``; ``mh_local`` bounds each owner's
    partial list (callers pass ``min(max_hits, Fl·cap)``) ->
    ``(hit_ids[H, Qpd, max_hits], counts[H, Qpd], overflow[H, Qpd])``.
    """
    qr = comm.exchange(_gather_send(q, sl, geometry.sentinel(q.device)))
    cr = comm.fold(comm.exchange(sc), sh.t_rows)
    hids, counts, _ = range_mod.pruned_range_ids(
        qr.reshape(-1, 4), sh.tiles, sh.ids, cr, mh_local,
        chunk_boxes=sh.cboxes, alive=sh.alive, extent=sh.extent)
    bids = comm.exchange(hids.view(sl.shape + (mh_local,)))
    bcounts = comm.exchange(counts.view(sl.shape))
    return range_mod.merge_owner_ids(bids, bcounts, sl, q.shape[1], max_hits)


def serve_knn(comm: _Comm, pts: torch.Tensor, sl: torch.Tensor,
              sc: torch.Tensor, dead: torch.Tensor, sh: Shards,
              uni: torch.Tensor, n_live: int, *, k: int, max_cand: int,
              max_rounds: int = 32):
    """Sharded exact kNN: lock-step deepening + top-k frontier merge.

    pts (H, Qpd, 2) home shards; sl/sc as in the range moves; dead
    (H, Qpd) marks padding slots (they start at the covering radius);
    uni (4,) the dataset universe; ``n_live`` the *global* live member
    count, so the first radius is the single-device paths' ->
    ``(nn_ids[H, Qpd, k], nn_d2[H, Qpd, k], radius[H, Qpd],
    overflow[H, Qpd], rounds[H, Qpd])``.  Each deepening round recounts
    the homes whose radius moved: their radii and a want flag go out
    with the messages, the owners probe the wanted messages in one
    folded counts launch, and the partial counts come back and merge.
    The continue flag is ``comm.any``, so under a mesh every rank runs
    the same rounds.  ``overflow`` flags an owner's extraction past
    ``max_cand``.
    """
    h, qpd = pts.shape[:2]
    dev = pts.device
    pad_pt = (uni[:2] + uni[2:]) * 0.5
    pr = comm.exchange(_gather_send(pts, sl, pad_pt)).reshape(-1, 2)
    cr = comm.fold(comm.exchange(sc), sh.t_rows)

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
        rad = torch.zeros(h * qpd, dtype=torch.float32, device=dev)
        rad[rows] = r
        want = torch.zeros(h * qpd, dtype=torch.bool, device=dev)
        want[rows] = True
        rr = comm.exchange(_gather_send(rad.view(h, qpd), sl, 0.0))
        wm = comm.exchange(_gather_send(want.view(h, qpd), sl, False))
        msg = wm.reshape(-1).nonzero().squeeze(1)
        rm = rr.reshape(-1)[msg][:, None]
        qb = torch.cat([pr[msg] - rm, pr[msg] + rm], dim=-1)
        part = torch.zeros(sl.numel(), dtype=torch.int32, device=dev)
        part[msg] = range_mod.pruned_range_counts(
            qb, sh.tiles, cr[msg], chunk_boxes=sh.cboxes, alive=sh.alive,
            extent=sh.extent)
        pb = comm.exchange(part.view(sl.shape))
        return range_mod.merge_owner_counts(pb, sl, qpd).reshape(-1)[rows]

    r0 = torch.where(dead.reshape(-1), r_cover, r_init)
    r, rounds = knn_mod._deepen(counts_at, r0, r_cover, k, max_rounds,
                                any_=comm.any)

    # refinement: owners extract local top-k within the √2-inflated box
    re = r * knn_mod._SQRT2_F32
    rr = comm.exchange(_gather_send(re.view(h, qpd), sl, 0.0)).reshape(-1)
    nn_i, nn_d, nc = knn_mod.knn_partial(
        pr, sh.tiles, sh.ids, cr, rr, k, max_cand=max_cand,
        chunk_boxes=sh.cboxes, alive=sh.alive, extent=sh.extent)
    kk = nn_i.shape[-1]
    nn_ids, nn_d2 = knn_mod.merge_knn_partials(
        comm.exchange(nn_i.view(sl.shape + (kk,))),
        comm.exchange(nn_d.view(sl.shape + (kk,))), sl, qpd, k)
    bnc = comm.exchange(nc.view(sl.shape))
    over = range_mod.merge_owner_counts((bnc > max_cand).to(torch.int32), sl,
                                        qpd) > 0
    return nn_ids, nn_d2, r.view(h, qpd), over, rounds.view(h, qpd)
