"""Dry-run cell construction: one rank's state and inputs on fake
tensors, and its step run once under the counters (twin of
``repro.launch.cells``).

One "cell" = (architecture x input shape x mesh).  Everything here
allocates nothing: parameters, optimizer state, caches and batches are
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``, torch's
counterpart of ``jax.eval_shape``), the mesh is a ``launch.mesh.
RecordingMesh`` seen from rank 0, and the step is the port's own CPU
code (the kernels' plain versions), so a 480B-parameter cell runs on a
laptop.  The state a rank holds is the port's actual layout: the
parameters cut by ``dist.sharding.param_specs`` (a weight whose split
the model cannot use is gathered whole in the step, and the gather is
recorded), the batch's rows (``dist.parallel.Parallel``), the decode
caches cut by ``cache_specs``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import configs
from ..dist import parallel, sharding
from ..models import api, layers, moe
from ..models.config import ModelConfig
from ..optim import adamw
from . import mesh as mesh_lib
from . import roofline
from . import shapes as shapes_lib


def _div(n, size):
    return size > 1 and n % size == 0


def _dp(mesh):
    dp = mesh_lib.dp_axes(mesh)
    size = 1
    for a in dp:
        size *= mesh_lib.axis_size(mesh, a)
    return dp, size


def _entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis
    is that axis's name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def batch_shardings(cfg: ModelConfig, shape, mesh) -> dict:
    """The spec of each batch tensor: the rows over the data axes where
    the global batch divides, else whole on every rank (a rank's rows
    are ``dist.parallel.shard`` of the global batch under it)."""
    dp, dp_size = _dp(mesh)
    bspec = (_entry(dp),) if _div(shape.global_batch, dp_size) else ()
    out = {"tokens": bspec + (None,)}
    if cfg.family == "vlm":
        out["img"] = bspec + (None, None)
    if cfg.family == "encdec":
        out["frames"] = bspec + (None, None)
    return out


def cache_specs(cfg: ModelConfig, shape, mesh, cache_tree,
                cache_shard: str = "w"):
    """Sharding rules for the decode caches: for each of the port's
    per-layer cache leaves, the reference's spec of its stacked leaf
    with the layer axis dropped (the same structure as ``cache_tree``,
    a spec tuple a leaf).

    Batch -> data when divisible; otherwise the *length* axis of
    attention caches is sequence-sharded over data (long_500k, batch 1):
    distributed flash-decode.  Head-like axes -> model when divisible.
    """
    data = mesh_lib.axis_size(mesh, "data")
    model = mesh_lib.axis_size(mesh, "model")
    dp, dp_size = _dp(mesh)
    b = shape.global_batch

    def stacked_spec(base, shp):
        """Spec for a layer-stacked cache leaf (leading L axis)."""
        nd = len(shp)
        bshard = _entry(dp) if _div(b, dp_size) else None
        spec = [None] * nd
        if base in ("k", "v"):
            # (L, B, W, KV, hd): batch -> dp; then either the length
            # axis -> model (+ data when the batch cannot split) with the
            # flash-decode combine, or with cache_shard="hd" the head
            # dimension -> model (the ring write stays local)
            spec[1] = bshard
            if cache_shard == "hd" and _div(shp[4], model):
                spec[4] = "model"
                if bshard is None and _div(shp[2], data):
                    spec[2] = "data"
                return spec
            w_axes = []
            if bshard is None and _div(shp[2], data):
                w_axes.append("data")
            if _div(shp[2], model):
                w_axes.append("model")
            if w_axes:
                spec[2] = tuple(w_axes) if len(w_axes) > 1 else w_axes[0]
            elif _div(shp[3], model):
                spec[3] = "model"
            return spec
        if base in ("state", "conv", "h"):
            # state: (L, B, H, S, P) H -> model; conv: (L, B, K, C)
            # C -> model; h: (L, B, W) W -> model
            spec[1] = bshard
            axis = 2 if base == "state" else nd - 1
            if _div(shp[axis], model):
                spec[axis] = "model"
            return spec
        return spec

    def layer(c: dict) -> dict:
        # the reference's rule reads no extent of the layer axis, and a
        # remainder layer's unstacked leaf shifts it left by one
        return {base: tuple(stacked_spec(base, (1,) + tuple(t.shape))[1:])
                for base, t in c.items()}

    if isinstance(cache_tree, dict):
        return {k: [layer(c) for c in v] for k, v in cache_tree.items()}
    return [layer(c) for c in cache_tree]


def shard_cache(cache, specs, mesh):
    """This rank's blocks of a whole cache under ``specs``."""
    def layer(c, sp):
        return {k: parallel.shard(t, sp[k], mesh) for k, t in c.items()}
    if isinstance(cache, dict):
        return {k: [layer(c, s) for c, s in zip(cache[k], specs[k])]
                for k in cache}
    return [layer(c, s) for c, s in zip(cache, specs)]


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    cfg: ModelConfig
    kind: str
    run_fn: object              # () -> roofline.Counts


def reduced_depth_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same config at k super-blocks of depth (the dry-run's depth-1 and
    depth-2 probes, from which the full depth's counts follow)."""
    kw = dict(n_layers=k * len(cfg.pattern))
    if cfg.family == "encdec":
        kw["enc_layers"] = k
    return dataclasses.replace(cfg, **kw)


def state_tensors(tree) -> list:
    """The tensors of a step's state: tensors, dicts, lists, modules
    and ``api.TrainState``s, nested."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in state_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in state_tensors(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, api.TrainState):
        return (state_tensors(tree.params) + state_tensors(tree.opt.m)
                + state_tensors(tree.opt.v) + [tree.opt.step, tree.step])
    return []


def build_cell(arch: str, shape_name, mesh,
               remat: str = "full",
               opt_policy: str | None = None,
               cfg_override: ModelConfig | None = None,
               n_micro: int = 1,
               bf16_weight_gather: bool = False,
               fast_attn: bool = False,
               moe_local: bool = False,
               cache_shard: str = "w") -> Cell | None:
    """The cell of ``arch`` x ``shape_name`` (a name of
    ``shapes.SHAPES`` or a ``ShapeSpec``) on ``mesh`` (a
    ``RecordingMesh``), or None where the shape does not apply; its
    ``run_fn()`` runs the rank's step once on fake tensors under
    ``roofline.count``."""
    layers.FAST_ATTN = fast_attn
    cfg = cfg_override or configs.get(arch)
    shape = (shapes_lib.SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if moe_local and cfg.n_experts:
        moe.set_local_moe((mesh, mesh_lib.dp_axes(mesh), "model", "data"))
        # the local MoE form takes F-split expert weights (models.moe)
        cfg = dataclasses.replace(cfg, shard_experts=False)
    else:
        moe.set_local_moe(None)
    ok, _ = shapes_lib.cell_supported(cfg, shape)
    if not ok:
        return None
    model = api.build(cfg, "cpu")
    mode = FakeTensorMode()
    gen = torch.Generator()

    def run(fn, state):
        with mode:
            return roofline.count(fn, mesh, state_tensors(state))[0]

    if shape.kind == "train":
        policy = opt_policy or ("bf16_mv" if cfg.name == "arctic-480b"
                                else "fp32")
        opt_cfg = adamw.AdamWConfig(state_policy=policy)
        step = api.make_train_step(model, opt_cfg, remat=remat,
                                   n_micro=n_micro,
                                   bf16_weight_gather=bf16_weight_gather,
                                   mesh=mesh)
        with mode:
            state = api.init_train_state(model, gen, opt_cfg, mesh=mesh)
        batch = shapes_lib.batch_specs(cfg, shape, mode)
        return Cell(arch, shape.name, cfg, "train",
                    lambda: run(lambda: step(state, batch),
                                [state, batch]))

    params = shapes_lib.abstract_params(model, mode)
    specs = sharding.param_specs(params, cfg,
                                 shard_experts=cfg.shard_experts, mesh=mesh)
    if shape.kind == "prefill":
        with mode:
            sharding.shard_params(params, specs, mesh)
        step = api.make_prefill_step(model, mesh=mesh)
        batch = shapes_lib.batch_specs(cfg, shape, mode)
        return Cell(arch, shape.name, cfg, "prefill",
                    lambda: run(lambda: step(params, batch),
                                [params, batch]))

    cache = shapes_lib.abstract_cache(model, cfg, shape, mode, params)
    cspecs = cache_specs(cfg, shape, mesh, cache, cache_shard)
    with mode:
        cache = shard_cache(cache, cspecs, mesh)
        sharding.shard_params(params, specs, mesh)
        tok = torch.empty((shape.global_batch,), dtype=torch.int32)
    step = api.make_serve_step(model, mesh=mesh, specs=cspecs)
    # the step that writes the cache's last slot: every slot is read
    pos = shape.seq_len - 1
    return Cell(arch, shape.name, cfg, "decode",
                lambda: run(lambda: step(params, cache, tok, pos),
                            [params, cache, tok]))
