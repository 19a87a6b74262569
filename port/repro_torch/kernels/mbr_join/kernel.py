"""Build, bind and launch the Hopper MBR-join kernels.

``csrc/mbr_join.cu`` holds the port's counterparts of
``repro.kernels.mbr_join.kernel.count_pallas`` and ``mask_pallas``; it
is built at first use (``kernels/cuda_build.py``).  Both take
component-major ``(4, N)`` float32 boxes, padded by the caller to
block multiples with the inverted sentinel box.  Each wrapper checks
its inputs, allocates its output with ``torch.empty`` (the kernel
writes every element), launches on the current stream, raises if the
launch returned an error, and adds one to its count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mbr_join.cu"
MAX_BS = 2048          # S boxes a count block stages (32 KB of float4)

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"count": 0, "mask": 0}

_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = cuda_build.Library(SOURCE, {
    "mbr_join_count": ([_ci, _vp, _vp, _ll, _ll, _ci, _ci, _vp, _vp], _ci),
    "mbr_join_mask": ([_ci, _vp, _vp, _ll, _ll, _vp, _vp], _ci),
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
