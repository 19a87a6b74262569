"""Plain PyTorch versions of the mbr_join kernels (twin of
``repro.kernels.mbr_join.ref``), plus the kernels' own contracts on
component-major ``(4, N)`` inputs, which the CPU path and the card's
checks use."""
from __future__ import annotations

import torch


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
