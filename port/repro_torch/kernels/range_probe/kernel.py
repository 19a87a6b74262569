"""Build, bind and launch the Hopper range-probe kernels.

``csrc/range_probe.cu`` is compiled with ``nvcc`` for ``sm_90a`` at
first use into a shared library with a plain C interface and bound
with ``ctypes`` (``kernels/cuda_build.py``).  Nothing is compiled or
loaded when this module is imported.

Eight launch wrappers are the port's counterparts of the
``pl.pallas_call`` entry points in ``repro.kernels.range_probe.kernel``:
four gathered (``gather_*``, routed candidates) and four dense
(``count``, ``mask`` and their ``*_skip`` twins, all tiles); four more,
``gather_hits{,_skip}``, ``dense_counts`` and ``dense_hits``, give the
serving path and the dense oracle the counts and the nonzeros of the
masks without their tables.  Each checks device, dtype, shape,
contiguity and alignment, allocates its output with ``torch.empty``
(the kernels write every element) or ``torch.zeros`` (count cells),
launches on the current stream without synchronising, raises if the
launch returned an error, and adds one to its count in ``LAUNCHES``.

The routed counts are tile-major: ``group_pairs`` groups the live
(query, candidate) pairs by tile on the device, then the probe's
blocks take (tile, run of up to 128 of its pairs, slot segment) work
items, stopping at the tile's live ``extent`` when an alive mask is
given (``ops.live_extent``).  The routed hit lists (``gather_hits``,
``gather_hits_skip``) run the same grouping and work items twice:
``hit_counts`` counts each (pair, segment)'s hits, a scan places them,
and ``emit_hits`` writes them as (query, tile, slot) in the
reference's flat order; no (Q, F, cap) table exists.  The routed masks
give each (query, candidate) pair a warp.

The dense oracle's path runs the same tile-major probe with every tile
a candidate of every query: ``dense_group`` lists each tile's slot
segments up to its extent (the pairs of a tile are all the queries, so
there is nothing else to group), ``dense_counts`` counts (Q, T) with
four queries a thread, and ``dense_hits`` counts, scans and emits the
dense hit list a block of queries at a time.  ``count`` and ``mask``
(a block per tile and 128 queries) stay as yardsticks off that path.

The chunk-skipping dense pair has no serving caller.  ``count_skip``
runs the dense tile-major probe to each tile's extent with the routed
skip counts' (query, chunk) list; ``mask_skip`` writes the (Q, T, cap)
table slot-parallel, a thread 16 slots, bound by its stores.  Their
first, block-per-tile design stays as ``count_skip_v1`` and
``mask_skip_v1``, yardsticks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build
from ..cuda_build import check as _check, device_index as _index
from ..cuda_build import ptr as _ptr

CHUNK = 128  # member slots summarised per chunk box

SOURCE = Path(__file__).resolve().parent / "csrc" / "range_probe.cu"

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"gather_count": 0, "gather_mask": 0,
            "gather_count_skip": 0, "gather_mask_skip": 0,
            "gather_hits": 0, "gather_hits_skip": 0,
            "dense_counts": 0, "dense_hits": 0,
            "count": 0, "mask": 0, "count_skip": 0, "mask_skip": 0,
            "count_skip_v1": 0, "mask_skip_v1": 0}

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = cuda_build.Library(SOURCE, {
    "rp_gathered_mask": ([_ci, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci,
                          _ci, _vp, _vp], _ci),
    "rp_count_scratch": ([_ci, _cll, _ci], _cll),
    "rp_group_pairs": ([_ci, _vp, _vp, _cll, _ci, _ci, _ci, _vp, _vp, _vp],
                       _ci),
    "rp_tile_counts": ([_ci, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci,
                        _ci, _vp, _vp, _vp], _ci),
    "rp_hit_segments": ([_ci], _ci),
    "rp_tile_hits": ([_ci, _ci, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci,
                      _ci, _vp, _vp, _vp, _vp, _cll, _vp], _ci),
    "rp_dense_scratch": ([_ci, _ci], _cll),
    "rp_dense_group": ([_ci, _vp, _ci, _ci, _vp, _vp], _ci),
    "rp_dense_skip_scratch": ([_cll, _ci, _ci], _cll),
    "rp_dense_tiles": ([_ci, _ci, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci,
                        _vp, _vp, _vp, _vp, _vp, _cll, _vp], _ci),
    "rp_dense_table": ([_ci, _vp, _vp, _vp, _vp, _vp, _cll, _ci, _ci, _ci,
                        _vp, _vp], _ci),
    "rp_dense_probe": ([_ci, _ci, _vp, _vp, _vp, _vp, ctypes.c_longlong,
                        _ci, _ci, _ci, _vp, _vp, _vp], _ci),
}, "rp_error_string")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    -> its path (the compiler's report beside it as ``<name>.log``)."""
    return LIB.build()


def _inputs(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
            cboxes: torch.Tensor | None, alive: torch.Tensor | None
            ) -> tuple[torch.device, int, int, int]:
    """Checks shared by every wrapper -> ``(device, T, cap, C)``."""
    dev = tiles.device
    cuda_build.require_cuda(name, tiles)
    t, cap = tiles.shape[:2]
    c = -(-cap // CHUNK)
    _check("qboxes", qboxes, torch.float32, (qboxes.shape[0], 4), dev, 16)
    _check("tiles", tiles, torch.float32, (t, cap, 4), dev, 16)
    if cboxes is not None:
        _check("cboxes", cboxes, torch.float32, (t, c, 4), dev, 16)
    if alive is not None:
        _check("alive", alive, torch.bool, (t, cap), dev)
    return dev, t, cap, c


def _routed(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
            cand: torch.Tensor, cboxes: torch.Tensor | None,
            alive: torch.Tensor | None, extent: torch.Tensor | None):
    """Checks of the routed wrappers -> ``(device, T, cap, C, Q, F,
    extent)``; the extent is kept only beside an alive mask (without
    one every slot counts)."""
    dev, t, cap, c = _inputs(name, qboxes, tiles, cboxes, alive)
    q, f = qboxes.shape[0], cand.shape[-1]
    _check("cand", cand, torch.int32, (q, f), dev)
    if max(t, cap, q * f) >= 2**31:
        raise ValueError(f"{name}: T, cap and Q*F must fit in int32")
    if alive is None:
        extent = None
    elif extent is not None:
        _check("extent", extent, torch.int32, (t,), dev)
    return dev, t, cap, c, q, f, extent


def _mask(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
          cand: torch.Tensor, cboxes: torch.Tensor | None,
          alive: torch.Tensor | None) -> torch.Tensor:
    dev, t, cap, c, q, f, _ = _routed(name, qboxes, tiles, cand, cboxes,
                                      alive, None)
    out = torch.empty((q, f, cap), dtype=torch.bool, device=dev)
    if q * f == 0:
        return out
    err = LIB.get().rp_gathered_mask(
        _index(dev), _ptr(qboxes), _ptr(tiles), _ptr(cboxes), _ptr(alive),
        _ptr(cand), q, f, t, cap, c, out.data_ptr(), cuda_build.stream(dev))
    LIB.launched(name, err, LAUNCHES)
    return out


def group_pairs(cand: torch.Tensor, t: int, cap: int,
                extent: torch.Tensor | None = None, *,
                zero_counts: bool = True
                ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The routed probes' grouping pass on ``cand``'s device: the live
    pairs of ``cand`` (Q, F) int32 by tile, and the probe's work items
    by tile, run and slot segment (up to ``extent``, else ``cap``) ->
    ``(counts, scratch)``, counts (Q, F) int32 all 0 (the count probe
    adds the hits; None unless ``zero_counts``), scratch the grouping
    the probes read.  Every routed count and hit-list call runs it
    first; alone it is a yardstick."""
    dev = cand.device
    q, f = cand.shape
    lib = LIB.get()
    counts = (torch.empty((q, f), dtype=torch.int32, device=dev)
              if zero_counts else None)
    scratch = torch.empty(lib.rp_count_scratch(t, q * f, cap),
                          dtype=torch.int32, device=dev)
    err = lib.rp_group_pairs(_index(dev), _ptr(cand), _ptr(extent), q, f, t,
                             cap, _ptr(scratch), _ptr(counts),
                             cuda_build.stream(dev))
    LIB.check("group_pairs", err)
    return counts, scratch


def _count(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
           cand: torch.Tensor, cboxes: torch.Tensor | None,
           alive: torch.Tensor | None,
           extent: torch.Tensor | None) -> torch.Tensor:
    dev, t, cap, c, q, f, extent = _routed(name, qboxes, tiles, cand, cboxes,
                                           alive, extent)
    counts, scratch = group_pairs(cand, t, cap, extent)
    if q * f == 0:
        return counts
    err = LIB.get().rp_tile_counts(
        _index(dev), _ptr(qboxes), _ptr(tiles), _ptr(cboxes), _ptr(alive),
        _ptr(extent), q, f, t, cap, c, _ptr(scratch), _ptr(counts),
        cuda_build.stream(dev))
    LIB.launched(name, err, LAUNCHES)
    return counts


def hit_counts(qboxes, tiles, cand, scratch, *, cboxes=None, alive=None,
               extent=None) -> torch.Tensor:
    """The hit list's count pass, after ``group_pairs`` on the same
    ``cand`` and ``extent``: -> (Q, F, S) int32, each (pair, slot
    segment)'s hits, ``S = ceil(cap / 8192)``."""
    dev, t, cap, c, q, f, extent = _routed("hit_counts", qboxes, tiles, cand,
                                           cboxes, alive, extent)
    lib = LIB.get()
    seg = torch.zeros((q, f, lib.rp_hit_segments(cap)), dtype=torch.int32,
                      device=dev)
    err = lib.rp_tile_hits(
        _index(dev), 0, _ptr(qboxes), _ptr(tiles), _ptr(cboxes), _ptr(alive),
        _ptr(extent), q, f, t, cap, c, _ptr(scratch), _ptr(seg), None, None,
        0, cuda_build.stream(dev))
    LIB.check("hit_counts", err)
    return seg


def emit_hits(qboxes, tiles, cand, scratch, seg, incl, *, cboxes=None,
              alive=None, extent=None) -> torch.Tensor:
    """The hit list's emit pass, after ``hit_counts`` -> ``seg`` and
    ``incl``, the inclusive scan of ``seg`` flattened (int64): -> (3,
    incl[-1]) int64 rows (query, tile, slot), in flat (query,
    candidate, slot) order.  Reads ``incl[-1]`` on the host."""
    dev, t, cap, c, q, f, extent = _routed("emit_hits", qboxes, tiles, cand,
                                           cboxes, alive, extent)
    total = int(incl[-1]) if incl.numel() else 0     # the one host read
    out = torch.empty((3, total), dtype=torch.int64, device=dev)
    err = LIB.get().rp_tile_hits(
        _index(dev), 1, _ptr(qboxes), _ptr(tiles), _ptr(cboxes), _ptr(alive),
        _ptr(extent), q, f, t, cap, c, _ptr(scratch), _ptr(seg), _ptr(incl),
        _ptr(out), total, cuda_build.stream(dev))
    LIB.check("emit_hits", err)
    return out


def _hits(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
          cand: torch.Tensor, cboxes: torch.Tensor | None,
          alive: torch.Tensor | None, extent: torch.Tensor | None
          ) -> torch.Tensor:
    """Group, count, scan, emit -> (3, H) int64 (query, tile, slot)."""
    dev, t, cap, _, q, f, extent = _routed(name, qboxes, tiles, cand, cboxes,
                                           alive, extent)
    if q * f == 0:
        return torch.empty((3, 0), dtype=torch.int64, device=dev)
    kw = dict(cboxes=cboxes, alive=alive, extent=extent)
    _, scratch = group_pairs(cand, t, cap, extent, zero_counts=False)
    seg = hit_counts(qboxes, tiles, cand, scratch, **kw)
    incl = seg.view(-1).cumsum(0)
    out = emit_hits(qboxes, tiles, cand, scratch, seg, incl, **kw)
    LAUNCHES[name] += 1
    return out


def _dense_args(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
                alive: torch.Tensor | None, extent: torch.Tensor | None,
                cboxes: torch.Tensor | None = None):
    """Checks of the dense tile-major wrappers -> ``(device, T, cap, Q,
    extent)``; the extent is kept only beside an alive mask."""
    dev, t, cap, _ = _inputs(name, qboxes, tiles, cboxes, alive)
    q = qboxes.shape[0]
    if max(t, cap, q * t) >= 2**31:
        raise ValueError(f"{name}: T, cap and Q*T must fit in int32")
    if alive is None:
        extent = None
    elif extent is not None:
        _check("extent", extent, torch.int32, (t,), dev)
    return dev, t, cap, q, extent


def dense_group(tiles: torch.Tensor,
                extent: torch.Tensor | None = None) -> torch.Tensor:
    """The dense passes' grouping on ``tiles``' device: each tile's slot
    segments up to ``extent`` (else cap) -> the int32 scratch the passes
    read.  It depends on the tiles and the extent only, so one serves
    every query block of a call."""
    dev = tiles.device
    t, cap = tiles.shape[:2]
    lib = LIB.get()
    scratch = torch.empty(lib.rp_dense_scratch(t, cap), dtype=torch.int32,
                          device=dev)
    err = lib.rp_dense_group(_index(dev), _ptr(extent), t, cap,
                             _ptr(scratch), cuda_build.stream(dev))
    LIB.check("dense_group", err)
    return scratch


def _dense_pass(name: str, mode: int, qboxes, tiles, scratch, counts, *,
                alive, extent, cboxes=None, skip=None, incl=None,
                out=None, total=0) -> int:
    dev, t, cap, q, extent = _dense_args(name, qboxes, tiles, alive, extent,
                                         cboxes)
    return LIB.get().rp_dense_tiles(
        _index(dev), mode, _ptr(qboxes), _ptr(tiles), _ptr(cboxes),
        _ptr(alive), _ptr(extent), q, t, cap, _ptr(scratch), _ptr(skip),
        _ptr(counts), _ptr(incl), _ptr(out), total, cuda_build.stream(dev))


def _dense_counts(name: str, qboxes, tiles, cboxes, alive,
                  extent) -> torch.Tensor:
    dev, t, cap, q, extent = _dense_args(name, qboxes, tiles, alive, extent,
                                         cboxes)
    counts = torch.zeros((q, t), dtype=torch.int32, device=dev)
    if q * t == 0:
        return counts
    scratch = dense_group(tiles, extent)
    skip = None
    if cboxes is not None:   # query order, run and unit boxes, live items
        lib = LIB.get()
        if t * lib.rp_hit_segments(cap) * -(-q // 128) >= 2**31:
            raise ValueError(f"{name}: (unit, run) items must fit in int32")
        skip = torch.empty(lib.rp_dense_skip_scratch(q, t, cap),
                           dtype=torch.int32, device=dev)
    err = _dense_pass(name, 0, qboxes, tiles, scratch, counts, alive=alive,
                      extent=extent, cboxes=cboxes, skip=skip)
    LIB.launched(name, err, LAUNCHES)
    return counts


def dense_counts(qboxes, tiles, *, alive=None, extent=None) -> torch.Tensor:
    """Dense probe counts, tile-major: (Q, 4), (T, cap, 4) -> (Q, T)
    int32; ``extent`` as for ``gather_count``."""
    return _dense_counts("dense_counts", qboxes, tiles, None, alive, extent)


def dense_row_bytes(t: int, cap: int) -> int:
    """Bytes of one query's cells in a dense hit list block: its int32
    count and int64 scan for each (tile, slot segment)."""
    return t * LIB.get().rp_hit_segments(cap) * 12


def dense_hit_counts(qboxes, tiles, scratch, *, alive=None,
                     extent=None) -> torch.Tensor:
    """The dense hit list's count pass, after ``dense_group`` on the same
    ``tiles`` and ``extent``: -> (Q, T, S) int32, each (query, tile,
    slot segment)'s hits, ``S = ceil(cap / 8192)``."""
    dev, t, cap = tiles.device, *tiles.shape[:2]
    seg = torch.zeros((qboxes.shape[0], t, LIB.get().rp_hit_segments(cap)),
                      dtype=torch.int32, device=dev)
    err = _dense_pass("dense_hit_counts", 1, qboxes, tiles, scratch, seg,
                      alive=alive, extent=extent)
    LIB.check("dense_hit_counts", err)
    return seg


def dense_emit_hits(qboxes, tiles, scratch, seg, incl, *, alive=None,
                    extent=None) -> torch.Tensor:
    """The dense hit list's emit pass, after ``dense_hit_counts`` ->
    ``seg`` and ``incl``, the inclusive scan of ``seg`` flattened
    (int64): -> (3, incl[-1]) int64 rows (query, tile, slot), in flat
    (query, tile, slot) order.  Reads ``incl[-1]`` on the host."""
    total = int(incl[-1]) if incl.numel() else 0     # the one host read
    out = torch.empty((3, total), dtype=torch.int64, device=tiles.device)
    err = _dense_pass("dense_emit_hits", 2, qboxes, tiles, scratch, seg,
                      alive=alive, extent=extent, incl=incl, out=out,
                      total=total)
    LIB.check("dense_emit_hits", err)
    return out


def dense_hits(qboxes, tiles, *, alive=None, extent=None,
               blocks: list[slice] | None = None) -> torch.Tensor:
    """Dense probe hit list: (Q, 4), (T, cap, 4) -> (3, H) int64 rows
    (query, tile, slot), the nonzeros of ``mask``'s table in flat
    (query, tile, slot) order.  The queries go through in ``blocks``
    (consecutive slices, default one): each block counts its (query,
    tile, segment) cells, scans them, reads its total once and emits.
    ``extent`` as for ``gather_count``."""
    dev, t, cap, q, extent = _dense_args("dense_hits", qboxes, tiles,
                                         alive, extent)
    parts = []
    if q * t:
        scratch = dense_group(tiles, extent)
        for rows in blocks or [slice(0, q)]:
            qb = qboxes[rows]
            seg = dense_hit_counts(qb, tiles, scratch, alive=alive,
                                   extent=extent)
            incl = seg.view(-1).cumsum(0)
            out = dense_emit_hits(qb, tiles, scratch, seg, incl, alive=alive,
                                  extent=extent)
            LAUNCHES["dense_hits"] += 1
            if rows.start:
                out[0] += rows.start
            parts.append(out)
    return (torch.cat(parts, 1) if parts
            else torch.empty((3, 0), dtype=torch.int64, device=dev))


def _dense(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
           cboxes: torch.Tensor | None, alive: torch.Tensor | None,
           mask_out: bool) -> torch.Tensor:
    dev, t, cap, c = _inputs(name, qboxes, tiles, cboxes, alive)
    q = qboxes.shape[0]
    if max(t, cap) >= 2**31 or t * -(-q // 128) >= 2**31:
        raise ValueError(f"{name}: T, cap and the grid must fit in int32")
    if mask_out:
        out = torch.empty((q, t, cap), dtype=torch.bool, device=dev)
    else:
        out = torch.empty((q, t), dtype=torch.int32, device=dev)
    if q * t == 0:
        return out
    lib = LIB.get()
    err = lib.rp_dense_probe(
        _index(dev), int(mask_out), _ptr(qboxes), _ptr(tiles), _ptr(cboxes),
        _ptr(alive), q, t, cap, c,
        None if mask_out else out.data_ptr(),
        out.data_ptr() if mask_out else None,
        cuda_build.stream(dev))
    LIB.launched(name, err, LAUNCHES)
    return out


def gather_count(qboxes, tiles, cand, *, alive=None,
                 extent=None) -> torch.Tensor:
    """Routed probe counts: (Q, 4), (T, cap, 4), (Q, F) -> (Q, F) int32.
    ``extent`` (T,) int32: no slot at or past ``extent[t]`` is alive
    (read only with ``alive``; None walks all of cap)."""
    return _count("gather_count", qboxes, tiles, cand, None, alive, extent)


def gather_mask(qboxes, tiles, cand, *, alive=None) -> torch.Tensor:
    """Routed probe hit table -> (Q, F, cap) bool."""
    return _mask("gather_mask", qboxes, tiles, cand, None, alive)


def gather_count_skip(qboxes, tiles, cboxes, cand, *, alive=None,
                      extent=None) -> torch.Tensor:
    """Chunk-skipping routed counts; cboxes (T, ceil(cap/128), 4)."""
    return _count("gather_count_skip", qboxes, tiles, cand, cboxes, alive,
                  extent)


def gather_mask_skip(qboxes, tiles, cboxes, cand, *,
                     alive=None) -> torch.Tensor:
    """Chunk-skipping routed hit table -> (Q, F, cap) bool."""
    return _mask("gather_mask_skip", qboxes, tiles, cand, cboxes, alive)


def gather_hits(qboxes, tiles, cand, *, alive=None,
                extent=None) -> torch.Tensor:
    """Routed probe hit list: (Q, 4), (T, cap, 4), (Q, F) -> (3, H)
    int64 rows (query, tile, slot), the nonzeros of ``gather_mask``'s
    table in flat (query, candidate, slot) order; ``extent`` as for
    ``gather_count``."""
    return _hits("gather_hits", qboxes, tiles, cand, None, alive, extent)


def gather_hits_skip(qboxes, tiles, cboxes, cand, *, alive=None,
                     extent=None) -> torch.Tensor:
    """Chunk-skipping routed hit list: the nonzeros of
    ``gather_mask_skip``'s table -> (3, H) int64."""
    return _hits("gather_hits_skip", qboxes, tiles, cand, cboxes, alive,
                 extent)


def count(qboxes, tiles, *, alive=None) -> torch.Tensor:
    """Dense probe counts: (Q, 4), (T, cap, 4) -> (Q, T) int32."""
    return _dense("count", qboxes, tiles, None, alive, False)


def mask(qboxes, tiles, *, alive=None) -> torch.Tensor:
    """Dense probe hit table -> (Q, T, cap) bool."""
    return _dense("mask", qboxes, tiles, None, alive, True)


# reprolint: disable=kernel-twin-parity -- count and mask are the
# block-per-tile first designs, yardsticks off every path; the dense
# path's extent-aware passes are dense_counts and dense_hits, and this
# pair was redesigned to stop at the extent
def count_skip(qboxes, tiles, cboxes, *, alive=None,
               extent=None) -> torch.Tensor:
    """Chunk-skipping dense counts, tile-major (a query a thread, the
    routed skip counts' (query, chunk) list): (Q, 4), (T, cap, 4),
    cboxes (T, ceil(cap/128), 4) -> (Q, T) int32; ``extent`` as for
    ``gather_count``."""
    return _dense_counts("count_skip", qboxes, tiles, cboxes, alive, extent)


# reprolint: disable=kernel-twin-parity -- see count_skip: mask is the
# block-per-tile yardstick, this table stops at the extent
def mask_skip(qboxes, tiles, cboxes, *, alive=None,
              extent=None) -> torch.Tensor:
    """Chunk-skipping dense hit table, slot-parallel (a thread 16 slots,
    a 16-byte store a query where rows are aligned) -> (Q, T, cap) bool;
    ``extent`` as for ``gather_count`` (slots past it are written
    False without a read)."""
    dev, t, cap, q, extent = _dense_args("mask_skip", qboxes, tiles, alive,
                                         extent, cboxes)
    out = torch.empty((q, t, cap), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    err = LIB.get().rp_dense_table(
        _index(dev), _ptr(qboxes), _ptr(tiles), _ptr(cboxes), _ptr(alive),
        _ptr(extent), q, t, cap, cboxes.shape[1], out.data_ptr(),
        cuda_build.stream(dev))
    LIB.launched("mask_skip", err, LAUNCHES)
    return out


def count_skip_v1(qboxes, tiles, cboxes, *, alive=None) -> torch.Tensor:
    """``count_skip`` in its first design (``rp_dense_probe``: a block
    per (tile, 128 queries) walking every chunk of cap): a yardstick off
    every path."""
    return _dense("count_skip_v1", qboxes, tiles, cboxes, alive, False)


def mask_skip_v1(qboxes, tiles, cboxes, *, alive=None) -> torch.Tensor:
    """``mask_skip`` in its first design (``rp_dense_probe``: a block
    per (tile, 128 queries), each warp's rows a chunk at a time): a
    yardstick off every path."""
    return _dense("mask_skip_v1", qboxes, tiles, cboxes, alive, True)
