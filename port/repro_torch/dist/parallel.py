"""Tensor and data parallelism of the model over a ``("data", "model")``
process mesh: what the reference's GSPMD does for its sharded train
step, written out as Megatron's scheme over ``launch.mesh``'s groups.

``Parallel`` is one rank's view: the mesh, the model axis and the data
axes, and whether the batch splits over them (it stays replicated when
the global batch does not divide, as the reference's launcher drops
its activation spec then).  The model's forward takes it as ``par``
(``models.lm.forward``, ``models.blocks``, ``models.moe``):

- ``copy`` before a column-parallel product: identity forward, sum over
  ``"model"`` backward (each rank's input gradient is partial);
- ``reduce`` after a row-parallel product: sum over ``"model"``
  forward, identity backward;
- ``gather``: a tiled all-gather along a dimension; its backward takes
  this rank's block of the gradient, summed over the axis first
  (``grad="sum"``: the ranks used different parts of the whole) or not
  (``grad="own"``: every rank computed the same from it);
- ``mean``: the reference's ``pmean`` of an aux value, whose gradient
  reaches this rank's own value unscaled (the loss divides it by the
  data extent, ``objective``).

Every rank of the mesh makes the same calls in the same order: each of
these is a collective over its row or column of ranks.

``shard`` cuts a full tensor to this rank's block of a spec (a tuple
of ``None``, an axis name or a tuple of axis names a dimension,
``dist.sharding.param_specs``, ``launch.cells.cache_specs``)
and ``unshard`` gathers it back; ``StateSpecs`` names the spec of each
leaf of a checkpointed train state, for ``checkpoint.store``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..launch.mesh import axis_size, dp_axes


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, axis=ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        ctx.size = x.shape[dim]
        return mesh.all_gather(x, axis=axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = ctx.mesh.all_reduce(g, axis=ctx.axis)
        i = ctx.mesh.coords[ctx.axis]
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None, None)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """One rank's place on a ``("data", "model")`` process mesh."""

    mesh: object
    tp_axis: str = "model"
    dp: tuple = ("data",)
    split: bool = True          # the batch splits over ``dp``

    @classmethod
    def of(cls, mesh, global_batch: int | None = None,
           tp_axis: str = "model") -> "Parallel":
        """The mesh's data axes (``launch.mesh.dp_axes``); the batch
        splits over them when ``global_batch`` divides (or is None)."""
        dp = dp_axes(mesh)
        n = math.prod(axis_size(mesh, a) for a in dp)
        return cls(mesh, tp_axis, dp, global_batch is None
                   or global_batch % n == 0)

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, self.tp_axis)

    @property
    def tp_rank(self) -> int:
        return self.mesh.coords.get(self.tp_axis, 0)

    @property
    def data_size(self) -> int:
        return math.prod(axis_size(self.mesh, a) for a in self.dp)

    @property
    def data_rank(self) -> int:
        """This rank's row-major index over the data axes."""
        i = 0
        for a in self.dp:
            i = i * axis_size(self.mesh, a) + self.mesh.coords[a]
        return i

    # -- the model axis --------------------------------------------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.mesh, self.tp_axis) if self.tp > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return (_Reduce.apply(x, self.mesh, self.tp_axis) if self.tp > 1
                else x)

    def gather(self, x: torch.Tensor, dim: int, grad: str = "sum",
               axis: str | None = None) -> torch.Tensor:
        axis = axis or self.tp_axis
        if axis_size(self.mesh, axis) == 1:
            return x
        return _Gather.apply(x, self.mesh, axis, dim % x.dim(), grad)

    # -- the data axes ---------------------------------------------------

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of a global batch tensor (all of it
        when the batch is replicated)."""
        if not self.split or self.data_size == 1:
            return x
        b = x.shape[0] // self.data_size
        return x[self.data_rank * b:(self.data_rank + 1) * b]

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` (dimension 0) in rank order;
        the gradient comes back summed over the data ranks."""
        if not self.split:
            return x
        for a in reversed(self.dp):
            x = self.gather(x, 0, "sum", a)
        return x

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        for a in self.dp:
            x = self.mesh.all_reduce(x, axis=a)
        return x

    def mean(self, v: torch.Tensor, axes: tuple) -> torch.Tensor:
        """``pmean`` of ``v`` over ``axes`` in turn; the gradient reaches
        this rank's ``v`` as it is."""
        m = v.detach()
        for a in axes:
            m = self.mesh.all_reduce(m, "mean", axis=a)
        return v + (m - v.detach())

    def objective(self, nll_sum: torch.Tensor, z_sum: torch.Tensor,
                  count: int, aux: dict) -> torch.Tensor:
        """This rank's part of the global loss: its tokens' summed
        cross-entropy and z-loss over the global token count, and each
        ``*lb_loss`` of ``aux`` (a global value on every rank) times
        0.01 over the data extent, so the parts sum over the data ranks
        to the global loss, and their gradients to its gradient."""
        dev = nll_sum.device
        n = torch.tensor(float(count), dtype=nll_sum.dtype, device=dev)
        if self.split:
            n = self.sum_data(n)
        else:
            n = n * self.data_size
        loss = (nll_sum + 1e-4 * z_sum) / n
        d = torch.tensor(float(self.data_size), dtype=nll_sum.dtype,
                         device=dev)
        for k, v in aux.items():
            if k.endswith("lb_loss"):
                loss = loss + 0.01 * v / d
        return loss


def spec_axes(entry) -> tuple:
    """The mesh axes of one entry of a spec: None, an axis name, or a
    tuple of names (split over their product, row-major, as a
    ``PartitionSpec`` entry that is a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh, axes: tuple) -> tuple:
    """(this rank's block, the block count) over ``axes``, row-major."""
    i, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        i, n = i * size + mesh.coords[a], n * size
    return i, n


def _blocks(shape: tuple, spec: tuple, mesh) -> list:
    """(dim, index, count) of each split dimension of ``spec``."""
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            i, n = block_index(mesh, axes)
            if shape[dim] % n:
                raise ValueError(f"{shape} does not split {n} ways on "
                                 f"dimension {dim}")
            out.append((dim, i, n))
    return out


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a
    contiguous copy; ``t`` itself when replicated)."""
    for dim, i, n in _blocks(tuple(t.shape), spec, mesh):
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t.contiguous().clone() if any(spec) else t


def unshard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor of this rank's block ``t`` under ``spec``: a
    tiled all-gather along each split dimension (every rank calls it)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(spec_axes(entry)):
            t = mesh.all_gather(t, axis=axis, dim=dim)
    return t



@dataclasses.dataclass(frozen=True)
class StateSpecs:
    """A mesh and the specs of a model's parameters: how the leaves of
    a checkpointed train state lie on the mesh (``params/<name>``,
    ``opt/m/<name>`` and ``opt/v/<name>`` as the parameter ``name``;
    every other leaf replicated).  The reference passes a tree of
    ``NamedSharding``s."""

    mesh: object
    specs: dict

    def leaf(self, leaf_name: str, ndim: int) -> tuple:
        for prefix in ("params/", "opt/m/", "opt/v/"):
            if leaf_name.startswith(prefix):
                name = leaf_name[len(prefix):]
                if name in self.specs:
                    return self.specs[name]
        return (None,) * ndim
