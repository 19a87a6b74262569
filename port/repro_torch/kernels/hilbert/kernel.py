"""Build, bind and launch the Hopper Hilbert encode kernel.

``csrc/hilbert.cu`` is the port's counterpart of
``repro.kernels.hilbert.kernel.encode_pallas``; it is built at first
use (``kernels/cuda_build.py``).  ``encode`` takes every bit plane at
once for orders 1-16 and steps plane by plane above them;
``encode_v1`` is the first design, one plane a step for every order,
kept as a yardstick.  Each checks its inputs, allocates the output with
``torch.empty`` (the kernel writes every element), launches on the
current stream, raises if the launch returned an error, and adds one to
its count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "hilbert.cu"

# kernel launches since the last reset_launches()
LAUNCHES = {"encode": 0, "encode_v1": 0}

_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
LIB = cuda_build.Library(SOURCE, {"hilbert_encode": _ARGS,
                                  "hilbert_encode_v1": _ARGS},
                         "hilbert_error_string")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    return LIB.build()


def encode(gx: torch.Tensor, gy: torch.Tensor, order: int) -> torch.Tensor:
    """(N,) int32 grid coords on the card -> (N,) int64 curve index.  Any
    alignment; the vector path needs gx, gy and the output 16-byte
    aligned."""
    return _launch("encode", gx, gy, order)


def encode_v1(gx: torch.Tensor, gy: torch.Tensor, order: int
              ) -> torch.Tensor:
    """``encode`` through the first design (one plane a step)."""
    return _launch("encode_v1", gx, gy, order)


def _launch(name: str, gx: torch.Tensor, gy: torch.Tensor, order: int
            ) -> torch.Tensor:
    dev = cuda_build.require_cuda(name, gx)
    n = gx.shape[0]
    cuda_build.check("gx", gx, torch.int32, (n,), dev)
    cuda_build.check("gy", gy, torch.int32, (n,), dev)
    if not 1 <= order <= 31:
        raise ValueError(f"{name}: order must be in [1, 31], got {order}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    err = getattr(LIB.get(), f"hilbert_{name}")(
        cuda_build.device_index(dev), gx.data_ptr(), gy.data_ptr(),
        out.data_ptr(), n, order, cuda_build.stream(dev))
    LIB.launched(name, err, LAUNCHES)
    return out
