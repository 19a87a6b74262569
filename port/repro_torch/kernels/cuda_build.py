"""Build, bind and check the port's hand-written CUDA sources.

Every kernel family keeps its source under ``kernels/<family>/csrc/``
with a plain C interface.  ``build`` compiles a source with ``nvcc``
for ``sm_90a`` at first use into the git-ignored
``port/repro_torch/build/``, named by the source's hash (an edited
source rebuilds), and ``Library`` binds it with ``ctypes``.  Nothing is
compiled or loaded when a module is imported.  ``build_all`` starts one
``nvcc`` per source at once, so a program that needs every family
waits for the slowest build, not their sum.

The launch wrappers share the checks here: each checks device, dtype,
shape, contiguity and alignment, launches on the current stream
without synchronising, and raises if the launch returned an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels "
                       "are built from source at first use")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_all(sources) -> list[Path]:
    """Compile every source not built yet, all at once -> their library
    paths.  The compiler's register/spill report is kept beside each
    library as ``<name>.log``."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, lib, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, lib, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{err}")
                continue
            lib.with_suffix(".log").write_text(err)
            os.replace(tmp, lib)        # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def build(source: Path) -> Path:
    """Compile ``source`` if it has not been built yet -> its library."""
    return build_all([source])[0]


class Library:
    """One CUDA source's library, built and bound at first use.

    ``signatures`` maps each exported function to ``(argtypes,
    restype)``; ``error_fn`` names the export that turns an error code
    into its message."""

    def __init__(self, source: Path, signatures: dict, error_fn: str):
        self.source = source
        self.signatures = signatures
        self.error_fn = error_fn
        self._lib: ctypes.CDLL | None = None

    def build(self) -> Path:
        return build(self.source)

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn, (args, res) in self.signatures.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            err = getattr(lib, self.error_fn)
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, name: str, err: int) -> None:
        """Raise if the launch returned an error."""
        if err:
            msg = getattr(self.get(), self.error_fn)(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg}")

    def launched(self, name: str, err: int, launches: dict) -> None:
        """Raise if the launch returned an error, else count it."""
        self.check(name, err)
        launches[name] += 1


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
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


def require_cuda(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs cuda tensors, "
                         f"got {x.device}")
    return x.device


def ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
