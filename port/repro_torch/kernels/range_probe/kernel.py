"""Build, bind and launch the Hopper range-probe kernels.

``csrc/range_probe.cu`` is compiled with ``nvcc`` for ``sm_90a`` at
first use into a shared library with a plain C interface and bound
with ``ctypes`` (``kernels/cuda_build.py``).  Nothing is compiled or
loaded when this module is imported.

Eight launch wrappers are the port's counterparts of the
``pl.pallas_call`` entry points in ``repro.kernels.range_probe.kernel``:
four gathered (``gather_*``, routed candidates) and four dense
(``count``, ``mask`` and their ``*_skip`` twins, all tiles); two more,
``gather_hits{,_skip}``, give the serving path the nonzeros of the
routed masks without their table.  Each checks device, dtype, shape,
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
            "count": 0, "mask": 0, "count_skip": 0, "mask_skip": 0}

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


def count_skip(qboxes, tiles, cboxes, *, alive=None) -> torch.Tensor:
    """Chunk-skipping dense counts; cboxes (T, ceil(cap/128), 4)."""
    return _dense("count_skip", qboxes, tiles, cboxes, alive, False)


def mask_skip(qboxes, tiles, cboxes, *, alive=None) -> torch.Tensor:
    """Chunk-skipping dense hit table -> (Q, T, cap) bool."""
    return _dense("mask_skip", qboxes, tiles, cboxes, alive, True)
