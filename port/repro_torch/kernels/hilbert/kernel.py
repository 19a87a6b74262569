"""Build, bind and launch the Hopper Hilbert encode kernel.

``csrc/hilbert.cu`` is the port's counterpart of
``repro.kernels.hilbert.kernel.encode_pallas``; it is built at first
use (``kernels/cuda_build.py``).  ``encode`` checks its inputs,
allocates the output with ``torch.empty`` (the kernel writes every
element), launches on the current stream, raises if the launch
returned an error, and adds one to ``LAUNCHES["encode"]``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "hilbert.cu"

# kernel launches since the last reset_launches()
LAUNCHES = {"encode": 0}

LIB = cuda_build.Library(SOURCE, {
    "hilbert_encode": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p], ctypes.c_int),
}, "hilbert_error_string")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    return LIB.build()


def encode(gx: torch.Tensor, gy: torch.Tensor, order: int) -> torch.Tensor:
    """(N,) int32 grid coords on the card -> (N,) int64 curve index."""
    dev = cuda_build.require_cuda("encode", gx)
    n = gx.shape[0]
    cuda_build.check("gx", gx, torch.int32, (n,), dev)
    cuda_build.check("gy", gy, torch.int32, (n,), dev)
    if not 1 <= order <= 31:
        raise ValueError(f"encode: order must be in [1, 31], got {order}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    err = LIB.get().hilbert_encode(
        cuda_build.device_index(dev), gx.data_ptr(), gy.data_ptr(),
        out.data_ptr(), n, order, cuda_build.stream(dev))
    LIB.launched("encode", err, LAUNCHES)
    return out
