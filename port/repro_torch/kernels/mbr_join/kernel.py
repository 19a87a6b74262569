"""Build, bind and launch the Hopper MBR-join kernels.

``csrc/mbr_join.cu`` holds the port's counterparts of
``repro.kernels.mbr_join.kernel.count_pallas`` and ``mask_pallas``; it
is built at first use (``kernels/cuda_build.py``).  ``count`` and
``mask`` take component-major ``(4, N)`` float32 boxes, padded by the
caller to block multiples with the inverted sentinel box.  The join's
path takes a one-device plan's tiles whole instead: ``rp_counts`` (the
reference-point-owned count of every tile, one launch), ``raw_counts``
(every tile's hits, duplicates included, one launch) and ``pair_list``
(every tile's (r_id, s_id) pairs: count, scan, one host read, emit),
over the work items that ``tile_meta`` lays out from the live sizes.  Each wrapper checks its inputs, launches on the current
stream, raises if the launch returned an error, and adds one to its
count in ``LAUNCHES`` (``pair_list`` one a list, its two passes
together).
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mbr_join.cu"
MAX_BS = 2048          # S boxes a count block stages (32 KB of float4)

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"count": 0, "mask": 0, "rp_counts": 0, "raw_counts": 0,
            "pair_list": 0}

_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_pi = ctypes.POINTER(_ci)
LIB = cuda_build.Library(SOURCE, {
    "mbr_join_count": ([_ci, _vp, _vp, _ll, _ll, _ci, _ci, _vp, _vp], _ci),
    "mbr_join_mask": ([_ci, _vp, _vp, _ll, _ll, _vp, _vp], _ci),
    "mbr_join_tiles": ([_ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll,
                        _ll, _ci, _ll, _vp, _vp, _vp], _ci),
    "mbr_join_emit": ([_ci, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _ci, _ll, _vp,
                       _vp, _vp, _ll, _vp, _vp, _vp], _ci),
    "mbr_join_item_shape": ([_pi, _pi], _ci),
}, "mbr_join_error_string")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    return LIB.build()


def _inputs(name: str, r4: torch.Tensor, s4: torch.Tensor
            ) -> tuple[torch.device, int, int]:
    dev = cuda_build.require_cuda(name, r4)
    n, m = r4.shape[-1], s4.shape[-1]
    cuda_build.check("r4", r4, torch.float32, (4, n), dev)
    cuda_build.check("s4", s4, torch.float32, (4, m), dev)
    return dev, n, m


def count(r4: torch.Tensor, s4: torch.Tensor, br: int, bs: int
          ) -> torch.Tensor:
    """(4, N) x (4, M), N % br == 0, M % bs == 0 -> (N/br, M/bs) int32
    hit counts, one per (br, bs) block."""
    dev, n, m = _inputs("count", r4, s4)
    if br < 1 or not 1 <= bs <= MAX_BS or n % br or m % bs:
        raise ValueError(f"count: need N % br == 0 and M % bs == 0 with "
                         f"1 <= bs <= {MAX_BS}; got N={n}, M={m}, "
                         f"br={br}, bs={bs}")
    out = torch.empty((n // br, m // bs), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    err = LIB.get().mbr_join_count(
        cuda_build.device_index(dev), r4.data_ptr(), s4.data_ptr(), n, m,
        br, bs, out.data_ptr(), cuda_build.stream(dev))
    LIB.launched("count", err, LAUNCHES)
    return out


def mask(r4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """(4, N) x (4, M) -> (N, M) bool intersection table, padding
    included."""
    dev, n, m = _inputs("mask", r4, s4)
    out = torch.empty((n, m), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    err = LIB.get().mbr_join_mask(
        cuda_build.device_index(dev), r4.data_ptr(), s4.data_ptr(), n, m,
        out.data_ptr(), cuda_build.stream(dev))
    LIB.launched("mask", err, LAUNCHES)
    return out


# -- the join's path: a plan's tiles whole -----------------------------------

@dataclasses.dataclass
class TileMeta:
    """The batched passes' layout of one plan's T tiles, on the card:
    ``data`` int64 holds live_r and live_s (T each), ``item_start``, the
    exclusive scan of each tile's (512-row, 1024-column) work items over
    its live extent, and ``row_base``, of its live rows (T + 1 each); a
    tile with no member on one side has neither.  Built once a plan."""
    tiles: int
    items: int
    rows: int
    data: torch.Tensor


def item_shape() -> tuple[int, int]:
    """(rows, columns) of one work item, as ``mbr_join.cu`` sets them."""
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    LIB.get().mbr_join_item_shape(ctypes.byref(rows), ctypes.byref(cols))
    return rows.value, cols.value


def tile_meta(live_r, live_s, device: torch.device,
              shape: tuple[int, int] | None = None) -> TileMeta:
    """Live sizes (T,) on the host -> the work items' layout on
    ``device`` (one copy), for items of ``shape`` (rows, columns),
    ``item_shape()`` unless given."""
    br, bs = shape or item_shape()
    lr = np.asarray(live_r, np.int64)
    ls = np.asarray(live_s, np.int64)
    both = (lr > 0) & (ls > 0)
    items = np.where(both, -(-lr // br) * -(-ls // bs), 0)
    rows = np.where(both, lr, 0)
    scan = [np.concatenate([[0], np.cumsum(v)]) for v in (items, rows)]
    data = torch.from_numpy(np.concatenate([lr, ls, *scan])).to(device)
    return TileMeta(lr.shape[0], int(scan[0][-1]), int(scan[1][-1]), data)


def _tile_inputs(name, r_tiles, s_tiles, meta, r_ids=None, s_ids=None):
    dev = cuda_build.require_cuda(name, r_tiles)
    t, cap_r = r_tiles.shape[:2]
    cap_s = s_tiles.shape[1]
    cuda_build.check("r_tiles", r_tiles, torch.float32, (t, cap_r, 4), dev,
                     16)
    cuda_build.check("s_tiles", s_tiles, torch.float32, (t, cap_s, 4), dev,
                     16)
    if r_ids is not None:
        cuda_build.check("r_ids", r_ids, torch.int32, (t, cap_r), dev)
        cuda_build.check("s_ids", s_ids, torch.int32, (t, cap_s), dev)
    cuda_build.check("meta", meta.data, torch.int64, (4 * t + 2,), dev)
    if meta.tiles != t:
        raise ValueError(f"{name}: meta is for {meta.tiles} tiles, not {t}")
    return dev, t, cap_r, cap_s


def rp_counts(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
              tile_boxes: torch.Tensor, uni: torch.Tensor, meta: TileMeta
              ) -> torch.Tensor:
    """(T, cap_r, 4), (T, cap_s, 4), (T, 4), (4,) float32 -> (T,) int64,
    each tile's intersecting pairs whose reference point it owns
    (``ref.tile_rp_counts``), over the live extents in ``meta``."""
    dev, t, cap_r, cap_s = _tile_inputs("rp_counts", r_tiles, s_tiles, meta)
    cuda_build.check("tile_boxes", tile_boxes, torch.float32, (t, 4), dev, 16)
    cuda_build.check("uni", uni, torch.float32, (4,), dev)
    out = torch.zeros(t, dtype=torch.int64, device=dev)
    err = LIB.get().mbr_join_tiles(
        cuda_build.device_index(dev), 0, r_tiles.data_ptr(),
        s_tiles.data_ptr(), None, None, tile_boxes.data_ptr(),
        uni.data_ptr(), meta.data.data_ptr(), cap_r, cap_s, t, meta.items,
        out.data_ptr(), None, cuda_build.stream(dev))
    LIB.launched("rp_counts", err, LAUNCHES)
    return out


def raw_counts(r_tiles: torch.Tensor, s_tiles: torch.Tensor, meta: TileMeta
               ) -> torch.Tensor:
    """(T, cap_r, 4), (T, cap_s, 4) float32 -> (T,) int64, each tile's
    intersecting pairs of its live prefixes (``ref.tile_raw_counts``),
    over the live extents in ``meta``."""
    dev, t, cap_r, cap_s = _tile_inputs("raw_counts", r_tiles, s_tiles, meta)
    out = torch.zeros(t, dtype=torch.int64, device=dev)
    err = LIB.get().mbr_join_tiles(
        cuda_build.device_index(dev), 2, r_tiles.data_ptr(),
        s_tiles.data_ptr(), None, None, None, None, meta.data.data_ptr(),
        cap_r, cap_s, t, meta.items, out.data_ptr(), None,
        cuda_build.stream(dev))
    LIB.launched("raw_counts", err, LAUNCHES)
    return out


def pair_row_counts(r_tiles, s_tiles, r_ids, s_ids, meta: TileMeta
                    ) -> torch.Tensor:
    """The pair list's count pass -> (rows,) int32, each live (tile, row)
    cell's hits with both ids >= 0, tiles in slot order."""
    dev, t, cap_r, cap_s = _tile_inputs("pair_row_counts", r_tiles, s_tiles,
                                        meta, r_ids, s_ids)
    cells = torch.zeros(meta.rows, dtype=torch.int32, device=dev)
    err = LIB.get().mbr_join_tiles(
        cuda_build.device_index(dev), 1, r_tiles.data_ptr(),
        s_tiles.data_ptr(), r_ids.data_ptr(), s_ids.data_ptr(), None, None,
        meta.data.data_ptr(), cap_r, cap_s, t, meta.items, None,
        cells.data_ptr(), cuda_build.stream(dev))
    LIB.check("pair_row_counts", err)
    return cells


def emit_pairs(r_tiles, s_tiles, r_ids, s_ids, meta: TileMeta,
               cells: torch.Tensor, max_pairs: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair list's scan and emit after ``pair_row_counts`` -> ``(rid,
    sid, n)``: int32 pairs, each tile's first ``max_pairs`` in row-major
    order, tiles in slot order; n (T,) int64 every tile's hits.  Reads
    the kept total on the host once."""
    dev, t, cap_r, cap_s = _tile_inputs("emit_pairs", r_tiles, s_tiles,
                                        meta, r_ids, s_ids)
    excl = torch.zeros(meta.rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(cells, 0, out=excl[1:])
    row_base = meta.data[3 * t + 1:]
    n = excl[row_base[1:]] - excl[row_base[:-1]]
    kept = n.clamp(max=max_pairs)
    start = kept.cumsum(0)
    total = int(start[-1])                        # the one host read
    start -= kept
    out = torch.empty((2, total), dtype=torch.int32, device=dev)
    err = LIB.get().mbr_join_emit(
        cuda_build.device_index(dev), r_tiles.data_ptr(), s_tiles.data_ptr(),
        r_ids.data_ptr(), s_ids.data_ptr(), meta.data.data_ptr(), cap_r,
        cap_s, t, meta.items, cells.data_ptr(), excl.data_ptr(),
        start.data_ptr(), max_pairs, out[0].data_ptr(), out[1].data_ptr(),
        cuda_build.stream(dev))
    LIB.check("emit_pairs", err)
    return out[0], out[1], n


def pair_list(r_tiles: torch.Tensor, s_tiles: torch.Tensor,
              r_ids: torch.Tensor, s_ids: torch.Tensor, meta: TileMeta,
              max_pairs: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every tile's intersecting (r_id, s_id) pairs -> ``(rid, sid, n)``
    as ``ref.tile_pair_list``: count, scan, emit."""
    if max_pairs < 0:
        raise ValueError(f"pair_list: max_pairs must be >= 0, got "
                         f"{max_pairs}")
    cells = pair_row_counts(r_tiles, s_tiles, r_ids, s_ids, meta)
    out = emit_pairs(r_tiles, s_tiles, r_ids, s_ids, meta, cells, max_pairs)
    LAUNCHES["pair_list"] += 1
    return out
