"""Build, bind and launch the Hopper SSD intra-chunk kernel.

``csrc/ssd.cu`` is the port's counterpart of
``repro.kernels.ssd.kernel.intra_chunk_pallas``; it is built at first
use (``kernels/cuda_build.py``).  ``intra_chunk`` launches the
tensor-core design (3xTF32 ``mma.sync``); ``intra_chunk_v1``, the first
design (scalar FFMA), is a yardstick that nothing on the model's path
calls.  Each checks its inputs, allocates its output with
``torch.empty`` (the kernel writes every element), launches on the
current stream, raises if the launch returned an error, and adds one to
its count in ``LAUNCHES``.

The launch is invisible to autograd: with grad mode on and any input
requiring grad, the wrapper raises rather than hand back a result whose
gradient would be silently wrong.  Training reaches the kernel through
``ops.ssd_forward``, whose ``IntraChunk`` launches it as its forward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
MAX_DIM = 128          # Q, P and S at most (the shared-memory staging)

# kernel launches since the last reset_launches()
LAUNCHES = {"intra_chunk": 0, "intra_chunk_v1": 0}
VERSIONS = {"intra_chunk": 2, "intra_chunk_v1": 1}   # ssd.cu's selector

_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = cuda_build.Library(SOURCE, {
    "ssd_intra_chunk": ([_ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _ll,
                         _ci, _ci, _ci, _ci, _ci, _ci, _vp], _ci),
    "ssd_resident_blocks": ([_ci, _ci, _ci, _ci, _ci, ctypes.POINTER(_ci)],
                            _ci),
}, "ssd_error_string")
_RESIDENT: dict = {}   # (version, device index, Q, P, S) -> resident blocks


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Path:
    return LIB.build()


def resident_blocks(index: int, q: int, p: int, s: int,
                    name: str = "intra_chunk") -> int:
    """Blocks of kernel ``name`` the card holds at once at (Q, P, S), as
    the CUDA occupancy calculator and the card's SM count give it
    (queried once a shape): two an SM for the tensor-core design at
    Mamba2's widths (100 KB of shared memory a block), one for the FFMA
    design (200 KB)."""
    key = (VERSIONS[name], index, q, p, s)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        err = LIB.get().ssd_resident_blocks(VERSIONS[name], index, q, p, s,
                                            ctypes.byref(out))
        if err:
            msg = LIB.get().ssd_error_string(err).decode()
            raise RuntimeError(f"ssd_resident_blocks failed: {msg}")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def heads_per_block(chunks: int, rep: int, min_blocks: int) -> int:
    """Heads of one group a block serves: the whole group (G = C . B^T is
    computed once a block), halved while the grid of ``chunks``
    (batch, chunk, group) blocks would hold fewer than ``min_blocks``,
    the blocks the card holds at once."""
    run = rep
    while run % 2 == 0 and chunks * (rep // run) < min_blocks:
        run //= 2
    return run


def intra_chunk(x: torch.Tensor, dt: torch.Tensor, cl: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """x (B, L, H, P), dt/cl (B, L, H), b/c (B, L, G, S), all float32 on
    the card -> y_intra (B, L, H, P) float32 (``ref.intra_chunk_grouped``,
    within 2e-5), on the tensor cores."""
    return _launch("intra_chunk", x, dt, cl, b, c, chunk)


def intra_chunk_v1(x: torch.Tensor, dt: torch.Tensor, cl: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int
                   ) -> torch.Tensor:
    """``intra_chunk`` in the first design (scalar FFMA): a yardstick."""
    return _launch("intra_chunk_v1", x, dt, cl, b, c, chunk)


def _launch(name: str, x: torch.Tensor, dt: torch.Tensor, cl: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, cl, b, c)):
        raise RuntimeError(
            f"{name}: a direct launch is invisible to autograd; "
            "differentiate through ops.ssd_forward (ops.IntraChunk)")
    dev = cuda_build.require_cuda(name, x)
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"{name}: x and b must be 4-d")
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    if not (8 <= chunk <= MAX_DIM and chunk % 8 == 0 and l % chunk == 0
            and 4 <= p <= MAX_DIM and p % 4 == 0 and 4 <= s <= MAX_DIM
            and s % 4 == 0 and g >= 1 and h % g == 0):
        raise ValueError(
            f"{name}: need L % chunk == 0, chunk % 8 == 0, P % 4 == 0, "
            f"S % 4 == 0, chunk, P, S <= {MAX_DIM} and H % G == 0; got L={l}, "
            f"chunk={chunk}, H={h}, P={p}, G={g}, S={s}")
    cuda_build.check("x", x, torch.float32, (bs, l, h, p), dev, 16)
    cuda_build.check("dt", dt, torch.float32, (bs, l, h), dev)
    cuda_build.check("cl", cl, torch.float32, (bs, l, h), dev)
    cuda_build.check("b", b, torch.float32, (bs, l, g, s), dev, 16)
    cuda_build.check("c", c, torch.float32, (bs, l, g, s), dev, 16)
    y = torch.empty((bs, l, h, p), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    index = cuda_build.device_index(dev)
    run = heads_per_block(bs * (l // chunk) * g, h // g,
                          resident_blocks(index, chunk, p, s, name))
    err = LIB.get().ssd_intra_chunk(
        VERSIONS[name], index, x.data_ptr(), dt.data_ptr(),
        cl.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), bs, l, h,
        g, chunk, p, s, run, cuda_build.stream(dev))
    LIB.launched(name, err, LAUNCHES)
    return y
