"""Build, bind and launch the Hopper range-probe kernels.

``csrc/range_probe.cu`` is compiled with ``nvcc`` for ``sm_90a`` at
first use into a shared library with a plain C interface, under the
git-ignored ``port/repro_torch/build/`` (named by the source's hash, so
an edited source rebuilds), and bound with ``ctypes``.  Nothing is
compiled or loaded when this module is imported.

The eight launch wrappers are the port's counterparts of the
``pl.pallas_call`` entry points in ``repro.kernels.range_probe.kernel``:
four gathered (``gather_*``, routed candidates) and four dense
(``count``, ``mask`` and their ``*_skip`` twins, all tiles).  Each
checks device, dtype, shape, contiguity and alignment, allocates its
output with ``torch.empty`` (the kernel writes every element),
launches on the current stream without synchronising, raises if the
launch returned an error, and adds one to its count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CHUNK = 128  # member slots summarised per chunk box

SOURCE = Path(__file__).resolve().parent / "csrc" / "range_probe.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"gather_count": 0, "gather_mask": 0,
            "gather_count_skip": 0, "gather_mask_skip": 0,
            "count": 0, "mask": 0, "count_skip": 0, "mask_skip": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the range-probe "
                       "kernels are built from source at first use")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    -> its path.  The compiler's register/spill report is kept beside
    it as ``<name>.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"librange_probe-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)        # atomic: concurrent builders agree
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rp_gathered_probe.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci,
            vp, vp, vp]
        lib.rp_gathered_probe.restype = ci
        lib.rp_dense_probe.argtypes = [
            ci, ci, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp, vp, vp]
        lib.rp_dense_probe.restype = ci
        lib.rp_error_string.argtypes = [ci]
        lib.rp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, align: int = 1) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _inputs(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
            cboxes: torch.Tensor | None, alive: torch.Tensor | None
            ) -> tuple[torch.device, int, int, int]:
    """Checks shared by every wrapper -> ``(device, T, cap, C)``."""
    dev = tiles.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs cuda tensors, "
                         f"got {dev}")
    t, cap = tiles.shape[:2]
    c = -(-cap // CHUNK)
    _check("qboxes", qboxes, torch.float32, (qboxes.shape[0], 4), dev, 16)
    _check("tiles", tiles, torch.float32, (t, cap, 4), dev, 16)
    if cboxes is not None:
        _check("cboxes", cboxes, torch.float32, (t, c, 4), dev, 16)
    if alive is not None:
        _check("alive", alive, torch.bool, (t, cap), dev)
    return dev, t, cap, c


def _launched(name: str, lib, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.rp_error_string(err).decode()}")
    LAUNCHES[name] += 1


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _probe(name: str, qboxes: torch.Tensor, tiles: torch.Tensor,
           cand: torch.Tensor, cboxes: torch.Tensor | None,
           alive: torch.Tensor | None, mask_out: bool) -> torch.Tensor:
    dev, t, cap, c = _inputs(name, qboxes, tiles, cboxes, alive)
    q, f = qboxes.shape[0], cand.shape[-1]
    _check("cand", cand, torch.int32, (q, f), dev)
    if max(t, cap, f) >= 2**31:
        raise ValueError(f"{name}: T, cap and F must fit in int32")
    if mask_out:
        out = torch.empty((q, f, cap), dtype=torch.bool, device=dev)
    else:
        out = torch.empty((q, f), dtype=torch.int32, device=dev)
    if q * f == 0:
        return out
    lib = _load()
    err = lib.rp_gathered_probe(
        _index(dev), int(mask_out), _ptr(qboxes), _ptr(tiles), _ptr(cboxes),
        _ptr(alive), _ptr(cand), q, f, t, cap, c,
        None if mask_out else out.data_ptr(),
        out.data_ptr() if mask_out else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(name, lib, err)
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
    lib = _load()
    err = lib.rp_dense_probe(
        _index(dev), int(mask_out), _ptr(qboxes), _ptr(tiles), _ptr(cboxes),
        _ptr(alive), q, t, cap, c,
        None if mask_out else out.data_ptr(),
        out.data_ptr() if mask_out else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(name, lib, err)
    return out


def gather_count(qboxes, tiles, cand, *, alive=None) -> torch.Tensor:
    """Routed probe counts: (Q, 4), (T, cap, 4), (Q, F) -> (Q, F) int32."""
    return _probe("gather_count", qboxes, tiles, cand, None, alive, False)


def gather_mask(qboxes, tiles, cand, *, alive=None) -> torch.Tensor:
    """Routed probe hit table -> (Q, F, cap) bool."""
    return _probe("gather_mask", qboxes, tiles, cand, None, alive, True)


def gather_count_skip(qboxes, tiles, cboxes, cand, *,
                      alive=None) -> torch.Tensor:
    """Chunk-skipping routed counts; cboxes (T, ceil(cap/128), 4)."""
    return _probe("gather_count_skip", qboxes, tiles, cand, cboxes, alive,
                  False)


def gather_mask_skip(qboxes, tiles, cboxes, cand, *,
                     alive=None) -> torch.Tensor:
    """Chunk-skipping routed hit table -> (Q, F, cap) bool."""
    return _probe("gather_mask_skip", qboxes, tiles, cand, cboxes, alive,
                  True)


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
