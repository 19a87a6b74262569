"""Process meshes: the port's SPMD mode over ``torch.distributed``
(counterpart of ``repro.launch.mesh`` and of ``repro.core.compat``'s
``shard_map`` and ``all_to_all``).

The reference's mesh has a single controller: one host plans each step
and ``shard_map`` runs it on every device of a ``jax.sharding.Mesh``.
The port runs one process a rank instead.  Every rank runs the same
program on the same inputs, makes the same host plan (stable sorts and
deterministic planners, held bit for bit against the reference), and
keeps only its own shard on its device; the collectives below move what
the reference's ``all_to_all``, ``psum`` and ``all_gather`` move.  A
``ProcessMesh`` from ``init_process_mesh`` has one axis, ``"d"``, of
``size`` ranks (the spatial path's); ``make_mesh`` lays the same ranks
out on named axes, row-major as ``make_host_mesh`` reshapes its devices
(a ``("data", "model")`` mesh of ``(2, 2)``: rank = data index x 2 +
model index), with one process group a row or column, and the
collectives that take ``axis=`` run over this rank's group along it.

The caller names the backend; nothing picks one.  ``gloo`` serves CPU
ranks and, on one card, CUDA ranks (NCCL refuses two ranks on one
device): there every collective copies its operands through host
memory, as gloo's own CUDA path does, and the copies are timed apart
from the collective (``ProcessMesh.timers``).  ``nccl`` takes device
tensors directly, one card a rank.  Every process group has a timeout,
and ``spawn`` joins its ranks with a deadline, then kills them: no
collective waits forever.

Run under ``python -m torch.distributed.run`` with ``from_env``; tests
spawn ranks with ``spawn`` and a ``file://`` store.  The reference's
``make_production_mesh`` (TPU pods of 256 and 512 chips) returns a
``RecordingMesh``: one rank's view of such a mesh with no process
group, whose collectives return tensors of the right shape and type and
record what they would move (the dry-run's collective term).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time

import torch
import torch.distributed as dist

from ..device import resolve

AXIS = "d"
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ProcessMesh:
    """One rank's view of a one-axis process mesh.

    group: the ``torch.distributed`` process group; rank and size: this
    process's place in it; device: the rank's device; backend: the
    group's backend; axis: the mesh axis name.  ``timers`` accumulates
    the collectives' seconds (``comm_s``), the host copies of gloo on
    CUDA (``copy_s``), the calls and the bytes sent.
    """

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = AXIS
    timers: dict = dataclasses.field(default_factory=lambda: dict(
        calls=0, comm_s=0.0, copy_s=0.0, bytes=0))
    axes: tuple = ()            # named axes (``make_mesh``); () is ``axis``
    dims: tuple = ()            # their extents, row-major over the ranks
    groups: dict = dataclasses.field(default_factory=dict)  # axis -> group

    @property
    def shape(self) -> dict:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        if not self.axes:
            return {self.axis: self.size}
        return dict(zip(self.axes, self.dims))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.axes or (self.axis,)

    @property
    def coords(self) -> dict:
        """Axis name -> this rank's index along it (row-major)."""
        out, rest = {}, self.rank
        for name, n in reversed(self.shape.items()):
            out[name] = rest % n
            rest //= n
        return {name: out[name] for name in self.axis_names}

    def _group(self, axis: str | None):
        """(process group, its size) of ``axis`` (None: every rank); an
        axis of one rank needs no group."""
        if axis is None or (not self.axes and axis == self.axis):
            return self.group, self.size
        if axis not in self.shape:
            raise ValueError(f"no axis {axis!r} on a mesh of "
                             f"{self.axis_names}")
        return self.groups.get(axis), self.shape[axis]

    @property
    def host_staging(self) -> bool:
        """gloo on CUDA ranks: operands go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_timers(self) -> None:
        self.timers.update(calls=0, comm_s=0.0, copy_s=0.0, bytes=0)

    # -- plumbing ---------------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """The collective's operand: on the host under host staging
        (pending kernels are waited for first, so the copy's time is
        the copy's), bool as uint8; contiguous."""
        if self.host_staging:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            x = x.to("cpu")
            self.timers["copy_s"] += time.perf_counter() - t0
        x = x.contiguous()
        return x.view(torch.uint8) if x.dtype == torch.bool else x

    def _back(self, x: torch.Tensor, dtype: torch.dtype,
              host: bool = False) -> torch.Tensor:
        if dtype == torch.bool:
            x = x.view(torch.bool)
        if self.host_staging and not host:
            t0 = time.perf_counter()
            x = x.to(self.device)
            torch.cuda.synchronize(self.device)
            self.timers["copy_s"] += time.perf_counter() - t0
        return x

    def _run(self, fn, nbytes: int, kind: str = "", result: int = 0,
             n: int = 1) -> None:
        """Run the collective ``fn`` (``nbytes`` sent; ``kind``, the
        ``result`` bytes and the group's size ``n`` are what a
        ``RecordingMesh`` records in its place)."""
        t0 = time.perf_counter()
        fn()
        if self.device.type == "cuda" and not self.host_staging:
            torch.cuda.synchronize(self.device)
        self.timers["comm_s"] += time.perf_counter() - t0
        self.timers["calls"] += 1
        self.timers["bytes"] += nbytes

    # -- collectives ------------------------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Device transpose of the leading axis (``size`` rows): row
        ``o`` of the result is what rank ``o`` held in its row for this
        rank (the reference's tiled ``all_to_all``)."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all of {tuple(x.shape)} on a mesh of "
                             f"{self.size} ranks")
        src = self._out(x)
        dst = torch.empty_like(src)
        nb = src.numel() * src.element_size()
        self._run(lambda: dist.all_to_all_single(dst, src, group=self.group),
                  nb, "all-to-all", nb, self.size)
        return self._back(dst, x.dtype)

    def all_to_all_v(self, x: torch.Tensor, send: list[int],
                     recv: list[int]) -> torch.Tensor:
        """Uneven exchange along the leading axis: ``send[o]`` rows of
        ``x`` (in order) go to rank ``o``; ``recv[o]`` rows come from
        rank ``o``, concatenated in rank order."""
        src = self._out(x)
        dst = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
        self._run(lambda: dist.all_to_all_single(
            dst, src, list(recv), list(send), group=self.group),
            src.numel() * src.element_size(), "all-to-all",
            dst.numel() * dst.element_size(), self.size)
        return self._back(dst, x.dtype)

    def all_gather(self, x: torch.Tensor, host: bool = False, *,
                   axis: str | None = None, dim: int | None = None
                   ) -> torch.Tensor:
        """Every rank's ``x`` (same shape everywhere) stacked on a new
        leading axis in rank order, or with ``dim`` concatenated along
        it (the reference's tiled ``all_gather``); ``axis`` gathers over
        this rank's group along that axis only; ``host`` leaves the
        result in host memory under host staging (a host mirror's
        source)."""
        group, n = self._group(axis)
        if n == 1:
            return x.unsqueeze(0) if dim is None else x
        src = self._out(x)
        parts = [torch.empty_like(src) for _ in range(n)]
        nb = src.numel() * src.element_size()
        self._run(lambda: dist.all_gather(parts, src, group=group),
                  nb, "all-gather", n * nb, n)
        out = torch.stack(parts) if dim is None else torch.cat(parts, dim)
        return self._back(out, x.dtype, host)

    def all_gather_v(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (leading lengths may differ) concatenated
        in rank order: the lengths are gathered first, each rank's rows
        are padded to the longest and cut after."""
        n = self.all_gather(torch.tensor([x.shape[0]], dtype=torch.int64,
                                         device=x.device)).view(-1).tolist()
        top = max(n)
        if x.shape[0] < top:
            x = torch.cat([x, x.new_zeros((top - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        g = self.all_gather(x)
        return torch.cat([g[r, :n[r]] for r in range(self.size)])

    def all_reduce(self, x: torch.Tensor, op: str = "sum", *,
                   axis: str | None = None) -> torch.Tensor:
        """Elementwise ``"sum"``, ``"mean"`` or ``"max"`` over the ranks
        (the reference's ``psum``, ``pmean`` and its global ``any``), or
        over this rank's group along ``axis``."""
        red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX}[op]
        group, n = self._group(axis)
        if n == 1:
            return x.clone()
        buf = self._out(x).clone()
        nb = buf.numel() * buf.element_size()
        self._run(lambda: dist.all_reduce(buf, op=red, group=group),
                  nb, "all-reduce", nb, n)
        out = self._back(buf, x.dtype)
        if op == "mean":    # the reference's pmean: psum / n
            out = out / torch.full((), n, dtype=out.dtype, device=out.device)
        return out

    def any(self, flag: torch.Tensor) -> bool:
        """Global ``any`` of a bool tensor, the same on every rank (it
        steers loops whose bodies hold collectives)."""
        f = torch.tensor([int(bool(flag.any()))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce(f, "max").item())

    def barrier(self) -> None:
        self._run(lambda: dist.barrier(group=self.group), 0, "barrier", 0,
                  self.size)


def _device(device, local_rank: int) -> torch.device:
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_process_mesh(backend: str, init_method: str, rank: int,
                      world_size: int, device=None, *,
                      timeout: float = DEFAULT_TIMEOUT_S,
                      local_rank: int | None = None) -> ProcessMesh:
    """Join a process group and return this rank's mesh.

    ``backend``: ``"gloo"`` or ``"nccl"``; ``init_method``: a
    ``file://`` path (tests) or ``tcp://host:port``; ``device``: the
    rank's device (``cuda`` unless given; a bare ``cuda`` becomes
    ``cuda:local_rank`` modulo the device count); ``timeout`` seconds
    bound every collective.
    """
    dev = _device(device, rank if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=init_method, rank=rank,
              world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return ProcessMesh(dist.group.WORLD, rank, world_size, dev, backend)


def from_env(backend: str, device=None, *,
             timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """The mesh of a rank started by ``python -m torch.distributed.run``
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in the environment)."""
    return init_process_mesh(
        backend, "env://", int(os.environ["RANK"]),
        int(os.environ["WORLD_SIZE"]), device, timeout=timeout,
        local_rank=int(os.environ.get("LOCAL_RANK", 0)))


def launched() -> bool:
    """True in a rank started by ``torch.distributed.run``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def make_mesh(base: ProcessMesh, dims: tuple[int, ...],
              axes: tuple[str, ...], *,
              timeout: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """``base``'s ranks laid out on named ``axes`` of extents ``dims``
    (row-major, as ``make_host_mesh`` reshapes its devices), with a
    process group for each row or column along each axis.  Every rank
    of ``base`` calls this with the same arguments: each creates every
    group, in the same order, as ``dist.new_group`` requires."""
    if len(dims) != len(axes) or math.prod(dims) != base.size:
        raise ValueError(f"a mesh of {dims} over {axes} on {base.size} "
                         f"ranks")
    grid = torch.arange(base.size).reshape(dims)
    groups = {}
    for a, name in enumerate(axes):
        lines = grid.movedim(a, -1).reshape(-1, dims[a])
        for line in lines.tolist():
            g = dist.new_group(line, timeout=datetime.timedelta(
                seconds=timeout))
            if base.rank in line:
                groups[name] = g
    return ProcessMesh(base.group, base.rank, base.size, base.device,
                       base.backend, axes=tuple(axes), dims=tuple(dims),
                       groups=groups)


@dataclasses.dataclass
class RecordingMesh(ProcessMesh):
    """One rank's view of a mesh of ``dims`` ranks on named ``axes``,
    with no process group: the dry-run's stand-in for a production mesh
    (``launch.dryrun``).  Each collective returns a tensor of the shape
    and type the real one returns (its values are not computed: run the
    step on fake tensors) and appends ``(kind, result bytes, group
    size)`` to ``ops``, in the reference's HLO names (``"all-reduce"``,
    ``"all-gather"``, ``"all-to-all"``; ``"barrier"`` moves nothing);
    ``timers`` counts the calls and bytes sent where a ``ProcessMesh``
    would.  An axis of one rank records nothing, as a ``ProcessMesh``
    runs nothing there."""

    ops: list = dataclasses.field(default_factory=list)

    @classmethod
    def of(cls, dims: tuple[int, ...], axes: tuple[str, ...],
           device="cpu", rank: int = 0) -> "RecordingMesh":
        if len(dims) != len(axes):
            raise ValueError(f"a mesh of {dims} over {axes}")
        return cls(None, rank, math.prod(dims), torch.device(device),
                   "record", axes=tuple(axes), dims=tuple(dims))

    def _run(self, fn, nbytes: int, kind: str = "", result: int = 0,
             n: int = 1) -> None:
        self.timers["calls"] += 1
        self.timers["bytes"] += nbytes
        self.ops.append((kind, result, n))

    def reset_timers(self) -> None:
        super().reset_timers()
        self.ops.clear()


def make_production_mesh(*, multi_pod: bool = False,
                         device="cpu") -> RecordingMesh:
    """The reference's production mesh seen from rank 0: (16, 16) over
    ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")`` with ``multi_pod`` (``pod`` folds into the data axes,
    ``dp_axes``)."""
    if multi_pod:
        return RecordingMesh.of((2, 16, 16), ("pod", "data", "model"),
                                device)
    return RecordingMesh.of((16, 16), ("data", "model"), device)


def close(mesh: ProcessMesh | None) -> None:
    """Leave the process group (a no-op without a mesh)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def axis_size(mesh: ProcessMesh | None, name: str) -> int:
    """The mesh's extent along ``name`` (1 for an axis it lacks)."""
    return 1 if mesh is None else mesh.shape.get(name, 1)


def dp_axes(mesh: ProcessMesh | None) -> tuple[str, ...]:
    """The pure data-parallel axes: the reference's ``pod`` and
    ``data`` (``("data",)`` on a ``("data", "model")`` mesh); a process
    mesh's one axis ``"d"`` is neither."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def in_turns(mesh: ProcessMesh | None, fn):
    """Run ``fn()`` on one rank at a time, in rank order, and return its
    result on each: work whose transient memory would not fit if every
    rank on a card ran it at once (a whole staging).  CUDA ranks hand
    their cached blocks back to the device before the first turn and
    after their own, so a turn has the card's free memory."""
    if mesh is None:
        return fn()

    def release():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
            torch.cuda.empty_cache()

    release()
    mesh.barrier()
    out = None
    for r in range(mesh.size):
        if r == mesh.rank:
            out = fn()
            release()
        mesh.barrier()
    return out


def spawn(fn, args: tuple, nprocs: int, deadline_s: float) -> None:
    """Start ``fn(rank, *args)`` in ``nprocs`` spawned processes and join
    them within ``deadline_s`` seconds.  A rank that raises fails the
    run (the others are terminated); past the deadline every rank is
    killed and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.1, min(1.0, end - time.monotonic()))):
            if time.monotonic() > end:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
