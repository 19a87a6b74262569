"""Public surface of the range probe (twin of
``repro.kernels.range_probe.ops``): dense (``probe_*``, every tile)
and routed (``gathered_*``, each query's candidate tiles).

Dispatch: tensors on the CPU go to the plain versions in ``ref``;
tensors on a CUDA device go to the Hopper kernel in ``kernel``, which
either launches or raises.  There is no other path.

Candidate-list contract (``gathered_*``): ``cand`` is (Q, F) int32 tile
indices from ``serve.router`` -- entries in [0, T) are real tiles,
``-1`` marks padding and reads as an all-sentinel tile (no hits), an
all-dead alive row and all-sentinel chunk boxes.

Local-index contract (``*_skip``): ``cboxes`` is the staging's
``(T, C, 4)`` chunk-box summary, ``C == ceil(cap / CHUNK)``.

Tombstone contract (keyword-only ``alive``): an optional (T, cap) bool
per-slot alive mask; a hit counts only if its slot is alive.

Live-extent contract (keyword-only ``extent``, routed counts and
routed hit lists): an optional (T,) int32 ``live_extent(alive)`` (any
larger value will do): no slot at or past ``extent[t]`` is alive, so
the kernel stops there.  It is read only beside ``alive`` and only by
the kernel; the plain versions need no bound.

Hit lists (``gathered_hit_list*``): the nonzeros of the routed masks
as int64 ``(query, tile, slot)``, in the order of ``nonzero`` over the
flattened ``(Q, F·cap)`` table (a ``-1`` candidate holds no hits).
The kernels count, scan and emit without the table; the plain version
builds it in ``hit_table_blocks``.
"""
from __future__ import annotations

import torch

from ...core.geometry import sentinel
from . import kernel, ref
from .kernel import CHUNK  # noqa: F401  (re-export: staging chunks on this)

_SKIP_RATE_BLOCK = 1 << 24   # (query, candidate, chunk) tests per block
_HIT_TABLE_BYTES = 1 << 31   # bytes of the plain hit list's table block


def _gather(table: torch.Tensor, cand: torch.Tensor, pad_value
            ) -> torch.Tensor:
    """``table[cand]`` along the leading axis, with every ``-1``
    candidate reading a row of ``pad_value`` (the reference appends
    that row to the table; here the table is never copied)."""
    if table.shape[0] == 0:
        table = table.new_empty((1,) + table.shape[1:])
    out = table[cand.clamp_min(0).long()]
    out[cand < 0] = torch.as_tensor(pad_value, dtype=table.dtype,
                                    device=table.device)
    return out


def gathered_rows(tiles: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(T, cap, 4) x (Q, F) -> (Q, F, cap, 4), -1 -> all-sentinel tile."""
    return _gather(tiles.float(), cand, sentinel(tiles.device))


def gathered_ids(ids: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(T, cap) int32 x (Q, F) -> (Q, F, cap), -1 -> all ``-1`` row."""
    return _gather(ids, cand, -1)


def gathered_alive(alive: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(T, cap) bool x (Q, F) -> (Q, F, cap), -1 -> all-dead row."""
    return _gather(alive, cand, False)


def gathered_chunk_boxes(cboxes: torch.Tensor, cand: torch.Tensor
                         ) -> torch.Tensor:
    """(T, C, 4) x (Q, F) -> (Q, F, C, 4), -1 -> all-sentinel chunks."""
    return _gather(cboxes.float(), cand, sentinel(cboxes.device))


def live_extent(alive: torch.Tensor) -> torch.Tensor:
    """(T, cap) bool -> (T,) int32: 1 + the index of each tile's last
    alive slot, 0 for a tile with none."""
    a = alive.to(torch.uint8)
    last = alive.shape[1] - a.flip(1).argmax(1)
    return torch.where(a.amax(1) > 0, last, 0).to(torch.int32)


def _kargs(qboxes: torch.Tensor, cand: torch.Tensor):
    return qboxes.float().contiguous(), cand.int().contiguous()


def probe_counts(qboxes: torch.Tensor, tiles: torch.Tensor, *,
                 alive: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(query, tile) hit counts: (Q, 4), (T, cap, 4) -> (Q, T)
    int32.  ``alive``: (T, cap) bool, dead slots never count."""
    if tiles.is_cuda:
        return kernel.count(qboxes.float().contiguous(), tiles, alive=alive)
    return ref.probe_counts(qboxes.float(), tiles.float(), alive)


def probe_mask(qboxes: torch.Tensor, tiles: torch.Tensor, *,
               alive: torch.Tensor | None = None) -> torch.Tensor:
    """Full hit table for id extraction -> (Q, T, cap) bool."""
    if tiles.is_cuda:
        return kernel.mask(qboxes.float().contiguous(), tiles, alive=alive)
    return ref.probe_mask(qboxes.float(), tiles.float(), alive).transpose(0, 1)


def probe_counts_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                      cboxes: torch.Tensor, *,
                      alive: torch.Tensor | None = None) -> torch.Tensor:
    """Dense counts with chunk skipping -> (Q, T) int32; equal to
    ``probe_counts`` whenever each chunk box bounds its members."""
    if tiles.is_cuda:
        return kernel.count_skip(qboxes.float().contiguous(), tiles, cboxes,
                                 alive=alive)
    return ref.probe_counts_skip(qboxes.float(), tiles.float(),
                                 cboxes.float(), alive)


def probe_mask_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                    cboxes: torch.Tensor, *,
                    alive: torch.Tensor | None = None) -> torch.Tensor:
    """Dense hit table with chunk skipping -> (Q, T, cap) bool."""
    if tiles.is_cuda:
        return kernel.mask_skip(qboxes.float().contiguous(), tiles, cboxes,
                                alive=alive)
    return ref.probe_mask_skip(qboxes.float(), tiles.float(), cboxes.float(),
                               alive).transpose(0, 1)


def gathered_counts(qboxes: torch.Tensor, tiles: torch.Tensor,
                    cand: torch.Tensor, *,
                    alive: torch.Tensor | None = None,
                    extent: torch.Tensor | None = None) -> torch.Tensor:
    """Routed probe: (Q, 4), (T, cap, 4), (Q, F) -> (Q, F) int32
    per-(query, candidate) hit counts."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return kernel.gather_count(q, tiles, c, alive=alive, extent=extent)
    return ref.gathered_counts(
        qboxes.float(), gathered_rows(tiles, cand),
        None if alive is None else gathered_alive(alive, cand))


def gathered_mask(qboxes: torch.Tensor, tiles: torch.Tensor,
                  cand: torch.Tensor, *,
                  alive: torch.Tensor | None = None) -> torch.Tensor:
    """Routed probe hit table -> (Q, F, cap) bool."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return kernel.gather_mask(q, tiles, c, alive=alive)
    return ref.gathered_mask(
        qboxes.float(), gathered_rows(tiles, cand),
        None if alive is None else gathered_alive(alive, cand))


def gathered_counts_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                         cboxes: torch.Tensor, cand: torch.Tensor, *,
                         alive: torch.Tensor | None = None,
                         extent: torch.Tensor | None = None) -> torch.Tensor:
    """Routed counts with chunk skipping -> (Q, F) int32; equal to
    ``gathered_counts`` whenever the chunk boxes bound their members."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return kernel.gather_count_skip(q, tiles, cboxes, c, alive=alive,
                                        extent=extent)
    return ref.gathered_counts_skip(
        qboxes.float(), gathered_rows(tiles, cand),
        gathered_chunk_boxes(cboxes, cand),
        None if alive is None else gathered_alive(alive, cand))


def gathered_mask_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                       cboxes: torch.Tensor, cand: torch.Tensor, *,
                       alive: torch.Tensor | None = None) -> torch.Tensor:
    """Routed hit table with chunk skipping -> (Q, F, cap) bool."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return kernel.gather_mask_skip(q, tiles, cboxes, c, alive=alive)
    return ref.gathered_mask_skip(
        qboxes.float(), gathered_rows(tiles, cand),
        gathered_chunk_boxes(cboxes, cand),
        None if alive is None else gathered_alive(alive, cand))


def gathered_hit_list(qboxes: torch.Tensor, tiles: torch.Tensor,
                      cand: torch.Tensor, *,
                      alive: torch.Tensor | None = None,
                      extent: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every hit of the routed probe: (Q, 4), (T, cap, 4), (Q, F) ->
    int64 ``(query, tile, slot)``, the nonzeros of ``gathered_mask``
    in flat (query, candidate, slot) order."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return tuple(kernel.gather_hits(q, tiles, c, alive=alive,
                                        extent=extent))
    return plain_hit_list(qboxes, tiles, cand, alive=alive)


def gathered_hit_list_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                           cboxes: torch.Tensor, cand: torch.Tensor, *,
                           alive: torch.Tensor | None = None,
                           extent: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Chunk-skipping ``gathered_hit_list``: the nonzeros of
    ``gathered_mask_skip``."""
    if tiles.is_cuda:
        q, c = _kargs(qboxes, cand)
        return tuple(kernel.gather_hits_skip(q, tiles, cboxes, c, alive=alive,
                                             extent=extent))
    return plain_hit_list(qboxes, tiles, cand, cboxes, alive=alive)


def hit_table_blocks(cand: torch.Tensor, cap: int, budget: int | None = None
                     ) -> list[tuple[slice, int]]:
    """How the plain hit list cuts one batch into routed hit tables ->
    ``[(query rows, width), ...]``.

    The full (Q, F, cap) table can exceed any memory (1024 x 448 x 135k
    is 62 GB); ``F`` is the batch's widest fan-out, ratcheted, so most
    columns are -1 padding, which has no hits.  Each block of
    consecutive queries keeps only the candidate columns up to its last
    live one, and holds at most ``budget`` bytes of table (default
    ``_HIT_TABLE_BYTES``; at least one query).  Blocks whose queries
    have no live candidate are left out: they hit nothing.
    """
    budget = _HIT_TABLE_BYTES if budget is None else budget
    q, f = cand.shape
    col = torch.arange(1, f + 1, device=cand.device)
    width = ((cand >= 0) * col).amax(1).tolist() if f else [0] * q
    blocks, i = [], 0
    while i < q:
        j, w = i, 0
        while j < q and (j == i or max(w, width[j]) * cap * (j + 1 - i)
                         <= budget):
            w = max(w, width[j])
            j += 1
        if w:
            blocks.append((slice(i, j), w))
        i = j
    return blocks


def plain_hit_list(qboxes: torch.Tensor, tiles: torch.Tensor,
                   cand: torch.Tensor, cboxes: torch.Tensor | None = None, *,
                   alive: torch.Tensor | None = None,
                   budget: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of both hit lists, on any device: the ``ref``
    table of each of ``hit_table_blocks(cand, cap, budget)``, then its
    ``nonzero``; ``cboxes`` selects the chunk-masked table."""
    qboxes = qboxes.float()
    parts = []
    for rows, w in hit_table_blocks(cand, tiles.shape[1], budget):
        cd = cand[rows, :w]
        galive = None if alive is None else gathered_alive(alive, cd)
        if cboxes is None:
            mask = ref.gathered_mask(qboxes[rows], gathered_rows(tiles, cd),
                                     galive)
        else:
            mask = ref.gathered_mask_skip(
                qboxes[rows], gathered_rows(tiles, cd),
                gathered_chunk_boxes(cboxes, cd), galive)
        bq, bf, bs = mask.nonzero(as_tuple=True)     # -1 columns are empty
        parts.append((bq + rows.start, cd[bq, bf].long(), bs))
    if not parts:
        empty = torch.zeros(0, dtype=torch.int64, device=qboxes.device)
        return empty, empty, empty
    return tuple(torch.cat(x) for x in zip(*parts))


def chunk_skip_rate(qboxes: torch.Tensor, cboxes: torch.Tensor,
                    cand: torch.Tensor) -> torch.Tensor:
    """Fraction of (query, live candidate) chunk probes the local index
    skips: chunks whose box the query misses, over all chunks of all
    non-padding candidates (all-sentinel chunks count as skipped).
    -> () float32 in [0, 1].  Counted in query blocks, so the gathered
    (Q, F, C, 4) chunk boxes never materialise at once."""
    q, f = cand.shape
    rows = max(1, _SKIP_RATE_BLOCK // max(f * cboxes.shape[1], 1))
    skipped = torch.zeros((), dtype=torch.int64, device=cand.device)
    for i in range(0, q, rows):
        cd = cand[i:i + rows]
        hit = ref.gathered_chunk_hits(qboxes[i:i + rows].float(),
                                      gathered_chunk_boxes(cboxes, cd))
        skipped += (~hit & (cd >= 0)[..., None]).sum()
    total = (cand >= 0).sum() * cboxes.shape[1]
    return skipped / total.clamp_min(1)
