"""Public wrappers of the Hilbert encode (twin of
``repro.kernels.hilbert.ops``).

A CPU tensor runs the plain version (``ref``); a CUDA tensor launches
the kernel, which raises rather than falls back.  Quantisation stays
in torch outside the kernel, as the reference keeps it outside its
``pallas_call``.  The reference pads to ``(R, 128)`` rows for the
TPU's layout; the CUDA kernel takes flat ``(N,)`` grids and masks its
ragged edge.
"""
from __future__ import annotations

import torch

from ...core import hilbert as core_hilbert
from . import kernel, ref


def encode(gx: torch.Tensor, gy: torch.Tensor,
           order: int = core_hilbert.DEFAULT_ORDER) -> torch.Tensor:
    """(N,) grid coords -> (N,) int64 curve index (the uint32 value)."""
    if gx.device.type == "cpu":
        return ref.encode(gx, gy, order)
    return kernel.encode(gx.to(torch.int32).contiguous(),
                         gy.to(torch.int32).contiguous(), order)


def hilbert_keys(pts: torch.Tensor, bounds: torch.Tensor,
                 order: int = core_hilbert.DEFAULT_ORDER) -> torch.Tensor:
    """``core.hilbert.hilbert_keys`` through the kernel on the card."""
    gx, gy = core_hilbert.quantize(pts, bounds, order)
    return encode(gx, gy, order)
