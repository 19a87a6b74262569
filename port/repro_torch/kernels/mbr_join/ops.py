"""Public wrappers of the mbr_join kernels (twin of
``repro.kernels.mbr_join.ops``).

They pad to block multiples with never-intersecting sentinel boxes in
the component-major ``(4, N_pad)`` layout and dispatch on device: a CPU
tensor runs the plain version (``ref``), a CUDA tensor launches the
kernel, which raises rather than falls back.  ``br``/``bs`` are the
reference's block shape (256 x 128): ``join_count`` sums the count
kernel's ``(N/br, M/bs)`` block counts, and both pad to them.
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
