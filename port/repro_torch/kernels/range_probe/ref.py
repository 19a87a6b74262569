"""Plain PyTorch versions of the range_probe kernels (twins of
``repro.kernels.range_probe.ref``).

They are the CPU executors and the oracles the CUDA kernels are held
to on the card.  Dense oracles are tile-major, gathered oracles are
query-major.  Sentinel boxes (xmin > xmax) intersect nothing, so
padding contributes zero hits by construction.

The ``*_skip`` oracles define the chunk-masked semantics of the
local-index kernels: a member hit only counts if the query also hits
the member's 128-slot chunk box.  When chunk boxes bound their members
(the staging invariant) this equals the unmasked result; when they do
not, the kernels must still match these oracles bit for bit.

Every oracle takes an optional per-slot alive mask (``(T, cap)`` dense,
``(Q, F, cap)`` gathered): a hit survives only if its slot is alive.
"""
from __future__ import annotations

import torch

from .kernel import CHUNK


def _hits(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return ((q[..., 0] <= s[..., 2]) & (s[..., 0] <= q[..., 2])
            & (q[..., 1] <= s[..., 3]) & (s[..., 1] <= q[..., 3]))


def probe_mask(qboxes: torch.Tensor, tiles: torch.Tensor,
               alive: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 4) x (T, cap, 4) -> (T, Q, cap) closed-box intersection;
    ``alive`` (T, cap) masks dead member slots out of the hit table."""
    hit = _hits(qboxes[None, :, None, :], tiles[:, None, :, :])
    if alive is not None:
        hit = hit & alive[:, None, :]
    return hit


def probe_counts(qboxes: torch.Tensor, tiles: torch.Tensor,
                 alive: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 4) x (T, cap, 4) -> (Q, T) per-(query, tile) hit counts."""
    return probe_mask(qboxes, tiles, alive).sum(2, dtype=torch.int32).T


def gathered_mask(qboxes: torch.Tensor, gtiles: torch.Tensor,
                  galive: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 4) x (Q, F, cap, 4) -> (Q, F, cap): query j vs ITS OWN
    gathered candidate tiles; ``galive`` (Q, F, cap) is the matching
    gathered alive mask."""
    hit = _hits(qboxes[:, None, None, :], gtiles)
    if galive is not None:
        hit = hit & galive
    return hit


def gathered_counts(qboxes: torch.Tensor, gtiles: torch.Tensor,
                    galive: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, 4) x (Q, F, cap, 4) -> (Q, F) per-candidate hit counts."""
    return gathered_mask(qboxes, gtiles, galive).sum(2, dtype=torch.int32)


# --------------------------------------------------------------------------
# chunk-masked (local-index) oracles
# --------------------------------------------------------------------------

def _pad_lanes(mask: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Pad a (..., cap) hit table with False up to n_chunks * CHUNK."""
    pad = n_chunks * CHUNK - mask.shape[-1]
    if not pad:
        return mask
    return torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], -1)


def _lanes(live: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., C) per-chunk flags -> (..., cap) per-slot flags."""
    return live.repeat_interleave(CHUNK, dim=-1)[..., :cap]


def chunk_hits(qboxes: torch.Tensor, cboxes: torch.Tensor) -> torch.Tensor:
    """(Q, 4) x (T, C, 4) -> (Q, T, C) query-vs-chunk-box intersection."""
    return _hits(qboxes[:, None, None, :], cboxes[None])


def probe_mask_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                    cboxes: torch.Tensor,
                    alive: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-masked ``probe_mask``: -> (T, Q, cap)."""
    live = chunk_hits(qboxes, cboxes).transpose(0, 1)        # (T, Q, C)
    return probe_mask(qboxes, tiles, alive) & _lanes(live, tiles.shape[1])


def probe_counts_skip(qboxes: torch.Tensor, tiles: torch.Tensor,
                      cboxes: torch.Tensor,
                      alive: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-masked ``probe_counts``: -> (Q, T).  Sums per-chunk
    partials, then zeroes chunks the query's box cannot reach."""
    n_chunks = cboxes.shape[1]
    m = _pad_lanes(probe_mask(qboxes, tiles, alive), n_chunks)
    part = m.reshape(m.shape[0], m.shape[1], n_chunks, CHUNK).sum(
        3, dtype=torch.int32)                                # (T, Q, C)
    live = chunk_hits(qboxes, cboxes).transpose(0, 1)
    return (part * live).sum(2, dtype=torch.int32).T


def gathered_chunk_hits(qboxes: torch.Tensor, gcboxes: torch.Tensor
                        ) -> torch.Tensor:
    """(Q, 4) x (Q, F, C, 4) -> (Q, F, C): query j vs ITS OWN gathered
    candidates' chunk boxes."""
    return _hits(qboxes[:, None, None, :], gcboxes)


def gathered_mask_skip(qboxes: torch.Tensor, gtiles: torch.Tensor,
                       gcboxes: torch.Tensor,
                       galive: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-masked ``gathered_mask``: -> (Q, F, cap)."""
    live = gathered_chunk_hits(qboxes, gcboxes)              # (Q, F, C)
    return (gathered_mask(qboxes, gtiles, galive)
            & _lanes(live, gtiles.shape[2]))


def gathered_counts_skip(qboxes: torch.Tensor, gtiles: torch.Tensor,
                         gcboxes: torch.Tensor,
                         galive: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk-masked ``gathered_counts``: -> (Q, F)."""
    n_chunks = gcboxes.shape[2]
    m = _pad_lanes(gathered_mask(qboxes, gtiles, galive), n_chunks)
    part = m.reshape(m.shape[0], m.shape[1], n_chunks, CHUNK).sum(
        3, dtype=torch.int32)                                # (Q, F, C)
    return (part * gathered_chunk_hits(qboxes, gcboxes)).sum(
        2, dtype=torch.int32)
