"""Parameter partitioning rules over a ``("data", "model")`` process
mesh, name and shape driven (twin of ``repro.dist.sharding``).

``param_specs`` gives every parameter of the port's model a spec: a
tuple of ``None`` or ``"model"``, one entry a dimension of the port's
tensor.  The rules are the reference's: ``wq``, ``wk`` and ``wv`` split
their heads (last dimension), ``wo`` and ``w2`` their contraction
(second to last), ``w1`` and ``w3`` the FF dimension (last); the MoE
experts go to E with ``shard_experts`` (the router ``wr`` on its last
dimension), else to F (the router whole); every other leaf, and any
leaf whose target dimension does not divide the model axis, is
replicated.  Without a ``"model"`` axis everything replicates.

The reference stacks each block parameter over a leading super-block
axis and the port keeps one tensor a layer (``models.lm.ref_path``).
The rules count dimensions in the reference's leaf: a stacked leaf has
one more, so the port's axis is the reference's less one and the
divisibility test reads the same dimension.  The ``rest`` layers'
leaves are not stacked there, and the expert rule's "axis 1" then
names their D, as in the reference.

``shard_params`` and ``shard_train_state`` cut a model's parameters,
or a whole train state with its moments, to this rank's blocks
(``dist.parallel.shard``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import encdec, lm
from .parallel import shard

# name -> the axis split over "model", counted in the reference's
# (stacked) leaf (negative = from the end)
_TP_AXIS = {
    "wq": -1, "wk": -1, "wv": -1,        # (L, D, H·hd): split heads
    "wo": -2,                            # (L, H·hd, D): split contraction
    "w1": -1, "w3": -1,                  # (L, [E,] D, F): split FF
    "w2": -2,                            # (L, [E,] F, D): split contraction
}
_MOE_NAMES = {"wr", "w1", "w3", "w2"}
TP_AXIS = "model"


def model_size(mesh) -> int:
    """The mesh's ``"model"`` extent, 0 without one (the reference's
    ``_model_size``: anything with a ``shape`` mapping will do)."""
    try:
        return int(mesh.shape[TP_AXIS])
    except (KeyError, TypeError, AttributeError):
        return 0


def _spec(name: str, shape: tuple, stacked: bool, tp: int,
          shard_experts: bool) -> tuple:
    parts = name.split(".")
    leaf = parts[-1]
    ndim = len(shape) + stacked             # the reference leaf's rank
    replicated = (None,) * len(shape)
    if tp <= 1 or ndim < 2:
        return replicated
    axis = None
    if "moe" in parts[:-1] and leaf in _MOE_NAMES:
        if shard_experts:
            axis = ndim - 1 if leaf == "wr" else 1
        elif leaf != "wr":
            axis = _TP_AXIS[leaf] % ndim
    elif leaf in _TP_AXIS:
        axis = _TP_AXIS[leaf] % ndim
    if axis is None:
        return replicated
    axis -= stacked
    if axis < 0:
        raise ValueError(f"{name}: the rule splits the reference's "
                         f"super-block axis")
    if shape[axis] % tp != 0:
        return replicated
    spec = list(replicated)
    spec[axis] = TP_AXIS
    return tuple(spec)


def param_specs(params, cfg, *, shard_experts: bool = False,
                mesh=None) -> dict:
    """Parameter name -> spec, for the full (unsharded) ``params``: a
    model (``lm.LM``, ``encdec.EncDec``) or a dict of name -> tensor
    (tensors of any device, ``meta`` and fake ones too: only shapes are
    read)."""
    named = (params if isinstance(params, dict)
             else dict(params.named_parameters()))
    tp = model_size(mesh)
    return {k: _spec(k, tuple(p.shape), lm.ref_path(k, cfg)[1] is not None,
                     tp, shard_experts)
            for k, p in named.items()}


def abstract_params(cfg) -> dict:
    """Name -> a fake tensor of every parameter of ``cfg``'s model, at
    full size, allocating nothing (the reference's ``jax.eval_shape``
    of ``init_params``)."""
    family = encdec if cfg.family == "encdec" else lm
    with FakeTensorMode():
        model = family.init_params(torch.Generator(), cfg)
    return dict(model.named_parameters())


def shard_params(params, specs: dict, mesh) -> None:
    """Cut a model's full parameters to this rank's blocks in place."""
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.data = shard(p.data, specs[k], mesh)


def shard_train_state(state, specs: dict, mesh):
    """Cut a full train state to this rank's blocks in place: each
    parameter's data and its moments (``api.TrainState``) -> the
    state."""
    shard_params(state.params, specs, mesh)
    for part in (state.opt.m, state.opt.v):
        for k in part:
            part[k] = shard(part[k], specs[k], mesh)
    return state
