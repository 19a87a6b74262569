"""Plain PyTorch versions of the mbr_join kernels (twin of
``repro.kernels.mbr_join.ref``), plus the kernels' own contracts on
component-major ``(4, N)`` inputs, which the CPU path and the card's
checks use, and of the join's batched passes: ``tile_rp_counts`` and
``tile_pair_list`` loop over a plan's live tiles with the reference's
table path (``query/join.py``), in row blocks of at most
``TABLE_BYTES`` of table."""
from __future__ import annotations

import torch

TABLE_BYTES = 1 << 28        # one (rows, M) bool table block of the loops


def intersect_mask(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) closed-box intersection."""
    return ((r[:, None, 0] <= s[None, :, 2]) & (s[None, :, 0] <= r[:, None, 2])
            & (r[:, None, 1] <= s[None, :, 3])
            & (s[None, :, 1] <= r[:, None, 3]))


def intersect_count(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return intersect_mask(r, s).sum(dtype=torch.int32)


def mask_cm(r4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """The ``mask`` kernel's function: (4, N) x (4, M) -> (N, M) bool."""
    return intersect_mask(r4.T, s4.T)


def count_cm(r4: torch.Tensor, s4: torch.Tensor, br: int, bs: int
             ) -> torch.Tensor:
    """The ``count`` kernel's function: hits per (br, bs) block ->
    (N/br, M/bs) int32."""
    n, m = r4.shape[1], s4.shape[1]
    hits = mask_cm(r4, s4).reshape(n // br, br, m // bs, bs)
    return hits.sum(dim=(1, 3), dtype=torch.int32)


def rp_own_mask(r: torch.Tensor, s: torch.Tensor, tile_box: torch.Tensor,
                uni: torch.Tensor) -> torch.Tensor:
    """(N, 4), (M, 4), (4,), (4,) -> (N, M) reference-point ownership,
    half-open on the tile's high edge, closed where it reaches the
    universe's."""
    rpx = torch.maximum(r[:, None, 0], s[None, :, 0])
    rpy = torch.maximum(r[:, None, 1], s[None, :, 1])
    hi_x = torch.where(tile_box[2] >= uni[2], rpx <= tile_box[2],
                       rpx < tile_box[2])
    hi_y = torch.where(tile_box[3] >= uni[3], rpy <= tile_box[3],
                       rpy < tile_box[3])
    return (rpx >= tile_box[0]) & hi_x & (rpy >= tile_box[1]) & hi_y


def _live_row_blocks(live_r, live_s):
    """(tile, rows slice, live_s) of every tile with members on both
    sides, in row blocks of at most TABLE_BYTES of table."""
    for j, (nr, ns) in enumerate(zip(live_r, live_s)):
        nr, ns = int(nr), int(ns)
        if nr and ns:
            rows = max(1, TABLE_BYTES // ns)
            for i0 in range(0, nr, rows):
                yield j, slice(i0, min(nr, i0 + rows)), ns


def tile_rp_counts(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
                   tile_boxes: torch.Tensor, uni: torch.Tensor, live_r,
                   live_s) -> torch.Tensor:
    """The ``rp_counts`` kernel's function: (T, cap_r, 4), (T, cap_s, 4),
    (T, 4), (4,), live sizes (T,) -> (T,) int64, each tile's intersecting
    pairs of its live prefixes whose reference point it owns."""
    out = torch.zeros(r_tiles.shape[0], dtype=torch.int64,
                      device=r_tiles.device)
    for j, rows, ns in _live_row_blocks(live_r, live_s):
        r, s = r_tiles[j, rows], s_tiles[j, :ns]
        out[j] += (intersect_mask(r, s)
                   & rp_own_mask(r, s, tile_boxes[j], uni)).sum()
    return out


def tile_pair_list(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
                   r_ids: torch.Tensor, s_ids: torch.Tensor, live_r, live_s,
                   max_pairs: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``pair_list`` kernels' function -> ``(rid, sid, n)``: every
    tile's intersecting (r_id, s_id) pairs with both ids >= 0 in
    row-major order, its first ``max_pairs`` kept, tiles in slot order;
    n (T,) int64 every tile's hits, those past ``max_pairs`` included."""
    dev = r_tiles.device
    n = torch.zeros(r_tiles.shape[0], dtype=torch.int64, device=dev)
    prs, pss = [], []
    for j, rows, ns in _live_row_blocks(live_r, live_s):
        hits = (intersect_mask(r_tiles[j, rows], s_tiles[j, :ns])
                & (r_ids[j, rows, None] >= 0) & (s_ids[j, None, :ns] >= 0))
        room = max_pairs - int(n[j])
        if room <= 0:
            n[j] += hits.sum()
            continue
        ri, si = hits.nonzero(as_tuple=True)
        n[j] += ri.shape[0]
        prs.append(r_ids[j, rows][ri[:room]])
        pss.append(s_ids[j, si[:room]])
    empty = torch.zeros(0, dtype=r_ids.dtype, device=dev)
    return (torch.cat(prs) if prs else empty,
            torch.cat(pss) if pss else empty, n)
