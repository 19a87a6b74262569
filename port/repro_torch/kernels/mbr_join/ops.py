"""Public wrappers of the mbr_join kernels (twin of
``repro.kernels.mbr_join.ops``).

They pad to block multiples with never-intersecting sentinel boxes in
the component-major ``(4, N_pad)`` layout and dispatch on device: a CPU
tensor runs the plain version (``ref``), a CUDA tensor launches the
kernel, which raises rather than falls back.  ``br``/``bs`` are the
reference's block shape (256 x 128): ``join_count`` sums the count
kernel's ``(N/br, M/bs)`` block counts, and both pad to them.
``tile_rp_counts``, ``tile_raw_counts`` and ``tile_pair_list`` take a
one-device plan's tiles whole (the join's path); their ``meta`` is the
card's layout of the work items (``kernel.tile_meta``, built if not
given; the CPU needs none).
"""
from __future__ import annotations

import torch

from ...core import geometry
from . import kernel, ref

DEFAULT_BR = 256
DEFAULT_BS = 128


def pad_cm(mbrs: torch.Tensor, block: int) -> torch.Tensor:
    """(N, 4) -> component-major (4, N_pad) float32, sentinel-padded."""
    mbrs = mbrs.to(torch.float32)
    pad = (-mbrs.shape[0]) % block
    if pad:
        mbrs = torch.cat([mbrs, geometry.sentinel(mbrs.device).expand(pad, 4)])
    return mbrs.T.contiguous()


def count_blocks(r4: torch.Tensor, s4: torch.Tensor, br: int, bs: int
                 ) -> torch.Tensor:
    if r4.device.type == "cpu":
        return ref.count_cm(r4, s4, br, bs)
    return kernel.count(r4, s4, br, bs)


def mask_cm(r4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    if r4.device.type == "cpu":
        return ref.mask_cm(r4, s4)
    return kernel.mask(r4, s4)


def join_count(r: torch.Tensor, s: torch.Tensor, br: int = DEFAULT_BR,
               bs: int = DEFAULT_BS) -> torch.Tensor:
    """Total intersecting (r, s) pairs -> 0-d int64.  r (N, 4), s (M, 4)."""
    return count_blocks(pad_cm(r, br), pad_cm(s, bs), br, bs).sum()


def join_mask(r: torch.Tensor, s: torch.Tensor, br: int = DEFAULT_BR,
              bs: int = DEFAULT_BS) -> torch.Tensor:
    """(N, M) bool intersection table, the un-padded view."""
    full = mask_cm(pad_cm(r, br), pad_cm(s, bs))
    return full[:r.shape[0], :s.shape[0]]


def tile_rp_counts(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
                   tile_boxes: torch.Tensor, uni: torch.Tensor, live_r,
                   live_s, meta: kernel.TileMeta | None = None
                   ) -> torch.Tensor:
    """(T, cap_r, 4), (T, cap_s, 4), (T, 4), (4,) float32, live sizes
    (T,) on the host -> (T,) int64 reference-point-owned pair counts."""
    if r_tiles.device.type == "cpu":
        return ref.tile_rp_counts(r_tiles, s_tiles, tile_boxes, uni, live_r,
                                  live_s)
    meta = meta or kernel.tile_meta(live_r, live_s, r_tiles.device)
    return kernel.rp_counts(r_tiles, s_tiles, tile_boxes, uni, meta)


def tile_raw_counts(r_tiles: torch.Tensor, s_tiles: torch.Tensor, live_r,
                    live_s, meta: kernel.TileMeta | None = None
                    ) -> torch.Tensor:
    """(T, cap_r, 4), (T, cap_s, 4) float32, live sizes (T,) on the host
    -> (T,) int64 raw pair counts (duplicates included)."""
    if r_tiles.device.type == "cpu":
        return ref.tile_raw_counts(r_tiles, s_tiles, live_r, live_s)
    meta = meta or kernel.tile_meta(live_r, live_s, r_tiles.device)
    return kernel.raw_counts(r_tiles, s_tiles, meta)


def tile_pair_list(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
                   r_ids: torch.Tensor, s_ids: torch.Tensor, live_r, live_s,
                   max_pairs: int, meta: kernel.TileMeta | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every tile's (r_id, s_id) pairs, its first ``max_pairs`` in
    row-major order -> ``(rid, sid, n)``, n (T,) int64 every tile's
    hits."""
    if r_tiles.device.type == "cpu":
        return ref.tile_pair_list(r_tiles, s_tiles, r_ids, s_ids, live_r,
                                  live_s, max_pairs)
    meta = meta or kernel.tile_meta(live_r, live_s, r_tiles.device)
    return kernel.pair_list(r_tiles, s_tiles, r_ids, s_ids, meta, max_pairs)
