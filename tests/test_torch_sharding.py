"""repro_torch's parameter specs (``dist/sharding.py``) against repro's
``param_specs``: every config of ``repro.configs`` at full size, model
axes of 1, 2, 4 and 16, ``shard_experts`` both ways.  repro's side is
``jax.eval_shape`` of its ``init_params``; the port's builds its model
from fake tensors (``abstract_params``: nothing allocated) and maps
each parameter to repro's stacked leaf (``lm.ref_path``), whose spec
has one more leading entry.  Also: a shard's blocks tile the whole
tensor back; the replicated leaves a tensor-parallel attention uses in
slices; the sharded step refuses a state that is not cut to its
shards."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jsharding
from repro.models import api as japi
from repro_torch import configs
from repro_torch.dist import parallel, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, blocks, lm
from repro_torch.optim import adamw

torch.set_num_threads(1)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_equal_repro_at_full_size(arch):
    cfg = configs.get(arch)
    abstract = jax.eval_shape(japi.build(jconfigs.get(arch)).init_params,
                              jax.random.PRNGKey(0))
    named = sharding.abstract_params(cfg)
    assert all(isinstance(p, torch.Tensor) for p in named.values())
    assert sum(p.numel() for p in named.values()) == sum(
        a.size for a in jax.tree.leaves(abstract))
    split = 0
    for tp in (1, 2, 4, 16):
        mesh = types.SimpleNamespace(shape={"data": 16, "model": tp})
        for experts in (False, True):
            want = jsharding.param_specs(abstract, shard_experts=experts,
                                         mesh=mesh)
            got = sharding.param_specs(named, cfg, shard_experts=experts,
                                       mesh=mesh)
            assert got.keys() == named.keys()
            for k, spec in got.items():
                path, layer = lm.ref_path(k, cfg)
                ref = tuple(_at(want, path))
                ndim = named[k].dim() + (layer is not None)
                ref += (None,) * (ndim - len(ref))
                assert spec == (ref[1:] if layer is not None else ref), (
                    k, tp, experts, spec, ref)
                split += "model" in spec
    # Mamba2's leaves are all replicated (no name of the rules)
    assert (split == 0) == (cfg.family == "ssm")
    assert sharding.param_specs(named, cfg) == {
        k: (None,) * p.dim() for k, p in named.items()}


def test_specs_of_a_built_model_equal_the_abstract_ones():
    cfg = configs.smoke("arctic_480b")
    built = api.build(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    mesh = types.SimpleNamespace(shape={"model": 2})
    assert sharding.param_specs(built, cfg, shard_experts=True, mesh=mesh) \
        == sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                shard_experts=True, mesh=mesh)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4), (4, 1)])
def test_shards_tile_the_whole_tensor(dims):
    t = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for spec, dim in (((None, None, "model"), 2), ((None, "model", None), 1),
                      (("model", None, None), 0)):
        parts = {}
        for r in range(4):
            m = mesh_lib.ProcessMesh(None, r, 4, torch.device("cpu"), "gloo",
                                     axes=("data", "model"), dims=dims)
            s = parallel.shard(t, spec, m)
            assert s.shape[dim] == t.shape[dim] // dims[1]
            parts.setdefault(m.coords["model"], s)
            assert torch.equal(parts[m.coords["model"]], s)
        assert torch.equal(torch.cat([parts[i] for i in range(dims[1])],
                                     dim), t)
    m = mesh_lib.ProcessMesh(None, 0, 1, torch.device("cpu"), "gloo",
                             axes=("data", "model"), dims=(1, 1))
    assert parallel.unshard(t, (None, None, "model"), m) is t
    assert parallel.shard(t, (None,) * 3, m) is t


def test_model_partial_leaves():
    """qwen's biases are used in slices under tensor parallelism; mixtral
    has none, nor any leaf at tp = 1 or where the heads do not split."""
    for arch, tp, want in (("qwen15_4b", 2, {"bq", "bk", "bv"}),
                           ("qwen15_4b", 1, set()),
                           ("mixtral_8x22b", 2, set()),
                           ("qwen15_4b", 8, set())):
        cfg = configs.smoke(arch)
        mesh = types.SimpleNamespace(shape={"model": tp})
        specs = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                     shard_experts=cfg.shard_experts,
                                     mesh=mesh)
        got = blocks.model_partial(specs, cfg, tp)
        assert {k.rsplit(".", 1)[1] for k in got} == want, (arch, tp)
        if want:
            assert len(got) == 3 * cfg.n_layers


def test_sharded_step_refuses_a_whole_state():
    cfg = dataclasses.replace(configs.smoke("qwen15_4b"), dtype="float32")
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    state = api.init_train_state(model, torch.Generator().manual_seed(0), opt)
    mesh = mesh_lib.ProcessMesh(None, 0, 2, torch.device("cpu"), "gloo",
                                axes=("data", "model"), dims=(1, 2))
    step = api.make_train_step(model, opt, mesh=mesh)
    tokens = torch.from_numpy(np.zeros((2, 8), np.int64))
    with pytest.raises(ValueError, match="shard_train_state"):
        step(state, {"tokens": tokens})
