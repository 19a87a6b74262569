"""repro_torch's dry-run tooling (``launch/{shapes,roofline,cells,
dryrun,report,hillclimb}.py``) against repro's ``repro.launch``: the
assigned shapes and the long-context policy for every arch x shape;
the batch, parameter and cache shapes and types leaf by leaf against
repro's ``jax.eval_shape`` (the port's on fake tensors, mapped through
``lm.ref_path``) for every config at full size; ``cache_specs`` for
every config x decode shape x (16, 16) and (2, 16, 16) x ``"w"`` and
``"hd"`` (repro's function on a mesh stand-in that has ``axis_names``
and ``devices``); ``collective_bytes`` of a ``RecordingMesh``'s ops
against repro's on HLO lines written for the same ops; ``model_flops``
and ``useful_ratio``; the report's tables; the hillclimb's variants.
All exact.  Port only: the depth-1/depth-2 extrapolation equals the
full-depth run's FLOPs, bytes, collective bytes and peak exactly on two
smoke configs, a train step under remat; the fake run counts
what ``FlopCounterMode`` counts on real CPU tensors, and the same bytes
(the MoE's within 1e-3); a production cell runs through
``dryrun.run_cell``; the production meshes fold "pod" into the data
axes; ``FAST_ATTN`` scores in bf16.  The sharded prefill and decode and
the recording mesh against gloo ranks are cases of
``tests/torch_mesh_ranks.py``."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses
import functools
import json
import types

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.models import api as japi
from repro_torch import configs
from repro_torch.launch import (cells, dryrun, hillclimb, report, roofline,
                                shapes)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, layers, lm, moe
from repro_torch.optim import adamw

torch.set_num_threads(1)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = ("decode_32k", "long_500k")


@pytest.fixture(autouse=True)
def _switches():
    """build_cell sets the reference's module switches; leave them off."""
    yield
    layers.FAST_ATTN = False
    moe.set_local_moe(None)


def _jmesh(name):
    dims, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(dims))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(port name -> fake tensor, repro's abstract pytree)."""
    model = api.build(configs.get(arch), "cpu")
    mine = dict(shapes.abstract_params(model, FakeTensorMode())
                .named_parameters())
    return mine, jshapes.abstract_params(japi.build(jconfigs.get(arch)))


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    """(the port's fake cache, repro's abstract cache)."""
    cfg, shape = configs.get(arch), shapes.SHAPES[shape_name]
    model = api.build(cfg, "cpu")
    mine = shapes.abstract_cache(model, cfg, shape, FakeTensorMode())
    jcfg = jconfigs.get(arch)
    return mine, jshapes.abstract_cache(japi.build(jcfg), jcfg,
                                        jshapes.SHAPES[shape_name])


def _layer_leaves(cfg, cache):
    """(port layer cache, repro path, index along repro's stacked axis or
    None) for every layer of the port's cache."""
    if cfg.family == "encdec":
        return [(c, (part,), i) for part in ("self", "cross")
                for i, c in enumerate(cache[part])]
    pat, n_super, _ = lm.structure(cfg)
    out = []
    for i, c in enumerate(cache):
        if i < n_super * len(pat):
            out.append((c, (f"p{i % len(pat)}",), i // len(pat)))
        else:
            out.append((c, ("rest", f"r{i - n_super * len(pat)}"), None))
    return out


def test_shapes_and_policy_match_repro():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_OK == jshapes.LONG_OK
    for arch in configs.ARCHS:
        for name in shapes.SHAPES:
            assert shapes.cell_supported(
                configs.get(arch), shapes.SHAPES[name]) == \
                jshapes.cell_supported(jconfigs.get(arch),
                                       jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_and_params_match_repro_eval_shape(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in ("train_4k", "prefill_32k"):
        mine = shapes.batch_specs(cfg, shapes.SHAPES[name], FakeTensorMode())
        want = jshapes.batch_specs(jcfg, jshapes.SHAPES[name])
        assert sorted(mine) == sorted(want)
        for k, t in mine.items():
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype)[6:] == str(want[k].dtype)
    mine, want = _params(arch)
    n_leaves = 0
    for name, p in mine.items():
        path, layer = lm.ref_path(name, cfg)
        leaf = _at(want, path)
        shp = leaf.shape if layer is None else leaf.shape[1:]
        assert tuple(p.shape) == shp, name
        assert str(p.dtype)[6:] == str(leaf.dtype), name
        n_leaves += 1 if layer is None else 1 / leaf.shape[0]
    assert round(n_leaves) == len(jax.tree.leaves(want))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_shapes_and_specs_match_repro(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in DECODE:
        if not shapes.cell_supported(cfg, shapes.SHAPES[name])[0]:
            continue
        mine, want = _caches(arch, name)
        leaves = _layer_leaves(cfg, mine)
        n = 0
        for c, path, i in leaves:
            for base, t in c.items():
                leaf = _at(want, path + (base,))
                shp = leaf.shape if i is None else leaf.shape[1:]
                assert tuple(t.shape) == shp, (path, base)
                assert str(t.dtype)[6:] == str(leaf.dtype), (path, base)
                n += 1 if i is None else 1 / leaf.shape[0]
        assert round(n) == len(jax.tree.leaves(want))
        for mesh_name in MESHES:
            mesh = mesh_lib.RecordingMesh.of(*MESHES[mesh_name])
            for shard in ("w", "hd"):
                got = cells.cache_specs(cfg, shapes.SHAPES[name], mesh,
                                        mine, shard)
                ref = jcells.cache_specs(jcfg, jshapes.SHAPES[name],
                                         _jmesh(mesh_name), want, shard)
                for (c, path, i), sp in zip(
                        leaves, _layer_leaves(cfg, got)):
                    for base in c:
                        js = tuple(_at(ref, path + (base,)))
                        assert sp[0][base] == (js if i is None else js[1:]), \
                            (mesh_name, shard, path, base)


def test_production_meshes_fold_pod_into_data():
    """``make_production_mesh``: rank 0 of (16, 16) or (2, 16, 16); the
    data axes are ("pod", "data") on the three-axis mesh, as the
    reference's ``dp_axes``; a recording collective returns the real
    one's shape and type."""
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (single.size, multi.size) == (256, 512)
    assert mesh_lib.dp_axes(single) == ("data",)
    assert mesh_lib.dp_axes(multi) == ("pod", "data")
    assert [mesh_lib.axis_size(multi, a) for a in ("pod", "data", "model",
                                                    "x")] == [2, 16, 16, 1]
    assert multi.coords == {"pod": 0, "data": 0, "model": 0}
    with FakeTensorMode():
        x = torch.empty((3, 8), dtype=torch.bfloat16)
        g = multi.all_gather(x, axis="pod", dim=1)
        r = multi.all_reduce(x, "mean", axis="data")
    assert (tuple(g.shape), g.dtype) == ((3, 16), torch.bfloat16)
    assert (tuple(r.shape), r.dtype) == ((3, 8), torch.bfloat16)
    assert multi.ops == [("all-gather", 96, 2), ("all-reduce", 48, 16)]


def test_fast_attn_gives_bf16_scores():
    """``FAST_ATTN`` (set by ``build_cell(fast_attn=True)``): the scores
    and probabilities meet in bf16, the carry stays float32; within
    bf16's rounding of the float32 form, and not equal to it."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, 4, 16), generator=g) for _ in range(3))
    want = layers.chunked_attention(q, k[:, :, :2], v[:, :, :2], chunk=16)
    mesh = mesh_lib.RecordingMesh.of((1, 1), ("data", "model"))
    cells.build_cell("qwen15_4b", shapes.ShapeSpec("d", 8, 1, "decode"),
                     mesh, cfg_override=configs.smoke("qwen15_4b"),
                     fast_attn=True)
    assert layers.FAST_ATTN
    got = layers.chunked_attention(q, k[:, :, :2], v[:, :, :2], chunk=16)
    assert got.dtype == torch.float32
    gap = (got - want).abs().max()
    assert 0 < gap < 2e-2 * want.abs().max()


@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_shardings_match_repro(mesh_name, monkeypatch):
    monkeypatch.setattr(jcells, "_ns", lambda mesh, spec: spec)
    mesh = mesh_lib.RecordingMesh.of(*MESHES[mesh_name])
    for arch in configs.ARCHS:
        for name, shape in shapes.SHAPES.items():
            got = cells.batch_shardings(configs.get(arch), shape, mesh)
            want = jcells.batch_shardings(jconfigs.get(arch),
                                          jshapes.SHAPES[name],
                                          _jmesh(mesh_name))
            assert got == {k: tuple(v) for k, v in want.items()}


_HLO = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int32: "s32"}


def _hlo(kind, shape, dtype, groups):
    dims = ",".join(map(str, shape))
    g = "" if groups is None else f", replica_groups=[{groups[0]},{groups[1]}]"
    return (f"  %op = {_HLO[dtype]}[{dims}]{{0}} {kind}(%x), "
            f"channel_id=1{g}, to_apply=%add")


def test_collective_bytes_match_repro_on_the_same_ops():
    mesh = mesh_lib.RecordingMesh.of((2, 16, 16), ("pod", "data", "model"))
    lines = []
    with FakeTensorMode():
        x = torch.empty((8, 1024), dtype=torch.float32)
        mesh.all_reduce(x, axis="model")
        lines.append(_hlo("all-reduce", (8, 1024), torch.float32, (32, 16)))
        mesh.all_reduce(x[:3], "max", axis="pod")
        lines.append(_hlo("all-reduce", (3, 1024), torch.float32, (256, 2)))
        y = torch.empty((4, 24, 7), dtype=torch.bfloat16)
        mesh.all_gather(y, axis="data", dim=1)
        lines.append(_hlo("all-gather", (4, 384, 7), torch.bfloat16,
                          (32, 16)))
        mesh.all_gather(y[0], axis="model")
        lines.append(_hlo("all-gather", (16, 24, 7), torch.bfloat16, None))
        z = torch.empty((512, 3), dtype=torch.int32)
        mesh.all_to_all(z)
        lines.append(_hlo("all-to-all", (512, 3), torch.int32, (1, 512)))
        mesh.barrier()
    lines.append("  %other = f32[4]{0} add(%a, %b)")
    got = roofline.collective_bytes(mesh.ops)
    assert got == jroofline.collective_bytes("\n".join(lines))
    assert got["ops"] == {"all-reduce": 2, "all-gather": 2, "all-to-all": 1}
    assert mesh.timers["calls"] == 6


@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_and_useful_ratio_match_repro(chips):
    for arch in configs.ARCHS:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        for name, shape in shapes.SHAPES.items():
            jshape = jshapes.SHAPES[name]
            assert roofline.model_flops(cfg, shape, chips) == \
                jroofline.model_flops(jcfg, jshape, chips)
            kw = dict(flops=3.5e14, hbm_bytes=2e12, coll_bytes=1e9,
                      coll_detail={}, t_compute=0.3, t_memory=0.5,
                      t_collective=0.02, bottleneck="memory",
                      peak_memory=7 * 10 ** 10)
            assert roofline.useful_ratio(cfg, shape, chips,
                                         roofline.Roofline(**kw)) == \
                jroofline.useful_ratio(jcfg, jshape, chips,
                                       jroofline.Roofline(**kw))


def _records():
    ok = dict(status="ok", kind="train", t_compute_s=0.4321, t_memory_s=1.5,
              t_collective_s=0.0, bottleneck="memory",
              useful_flop_ratio=0.1234, roofline_fraction=0.0567,
              peak_memory_bytes=2.5e10, fits_hbm=True)
    return [
        dict(arch="qwen15_4b", shape="train_4k", mesh="single", **ok),
        dict(arch="qwen15_4b", shape="decode_32k", mesh="single",
             **dict(ok, kind="decode", t_compute_s=3e-5, t_memory_s=0.025,
                    t_collective_s=0.0087, peak_memory_bytes=5e7,
                    fits_hbm=False)),
        dict(arch="qwen15_4b", shape="long_500k", mesh="single",
             status="skipped", why="pure full-attention arch"),
        dict(arch="arctic_480b", shape="train_4k", mesh="single",
             status="fail", error="RuntimeError: " + "x" * 200),
        dict(arch="arctic_480b", shape="train_4k", mesh="multi", **ok),
    ]


def test_report_renders_as_repro(tmp_path):
    recs = _records()
    for mesh in ("single", "multi"):
        assert report.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
    assert report.summary(recs) == jreport.summary(recs)
    path = tmp_path / "dry.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs + recs[:1]))
    assert report.load(str(path)) == jreport.load(str(path))
    assert report.main([str(path)]) == 0


def test_hillclimb_variants_match_repro():
    saved = os.environ.get("XLA_FLAGS")
    try:                 # repro's module sets XLA_FLAGS when imported
        from repro.launch import hillclimb as jhill
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert hillclimb.VARIANTS == jhill.VARIANTS
    for spec in ("baseline", "micro4+fast+bf16g", "moelocal+cachehd",
                 "dots", "noremat+micro8"):
        assert hillclimb.variant_kwargs(spec) == jhill.variant_kwargs(spec)
    with pytest.raises(KeyError):
        hillclimb.variant_kwargs("micro4+nope")


EXTRAPOLATED = [
    # (arch, shape, super-blocks of the full run): a train step on
    # (2, 2) with the batch split, under remat "full", and batch-1
    # flash-decode with a remainder layer
    ("qwen15_4b", shapes.ShapeSpec("t", 32, 4, "train"), 3),
    ("recurrentgemma_9b", shapes.ShapeSpec("d", 64, 1, "decode"), 3),
]


@pytest.mark.parametrize("arch,shape,n_super", EXTRAPOLATED)
def test_extrapolation_equals_the_full_depth(arch, shape, n_super):
    """FLOPs, bytes, collective bytes and the peak live bytes."""
    remat = "full" if shape.kind == "train" else "none"
    smoke = configs.smoke(arch)
    rest = lm.structure(smoke)[2]
    cfg = dataclasses.replace(smoke, n_layers=n_super * len(smoke.pattern)
                              + rest)
    mesh = mesh_lib.RecordingMesh.of((2, 2), ("data", "model"))
    _, full = dryrun.cell_counts(arch, shape, mesh, remat,
                                 extrapolate=False, cfg_override=cfg)
    _, ext = dryrun.cell_counts(arch, shape, mesh, remat, cfg_override=cfg)
    assert full.flops > 0 and full.coll["total"] > 0
    assert ext.flops == full.flops
    assert ext.hbm_bytes == full.hbm_bytes
    assert ext.coll == full.coll
    assert ext.peak_memory == full.peak_memory


def test_fake_counts_equal_the_real_cpu_step():
    """FLOPs exactly; bytes within 1e-3: a composite op's real CPU
    kernel is not always the ops its fake run sees.  ``F.one_hot``'s
    (the MoE's load-balance term) checks its input's range
    (``aminmax``) and scatters where the fake run decomposes, and the
    host scalars ``torch.tensor(...)`` reach the fake run as copies:
    14,800 bytes of 151.2 M apart in the mixtral smoke step at 2 x 16."""
    cfg = configs.smoke("mixtral_8x22b")
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    step = api.make_train_step(model, opt)
    state = api.init_train_state(model, torch.Generator().manual_seed(0),
                                 opt)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    real, _ = roofline.count(lambda: step(state, {"tokens": tokens}))
    with FakeTensorMode():
        fstate = api.init_train_state(model, torch.Generator(), opt)
        ftok = torch.empty((2, 16), dtype=torch.int64)
        fake, _ = roofline.count(lambda: step(fstate, {"tokens": ftok}))
    assert fake.flops == real.flops > 0
    assert abs(fake.hbm_bytes - real.hbm_bytes) < 1e-3 * real.hbm_bytes


def test_run_cell_record_and_skip():
    rec = dryrun.run_cell("mamba2_1p3b", "decode_32k", False, verbose=False)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["kind"] == "decode" and rec["chips"] == 256
    assert rec["flops_per_chip"] > 0 and rec["fits_hbm"]
    assert 0 < rec["decode_mem_fraction"] <= 1
    assert rec["t_compile_s"] == 0.0
    skip = dryrun.run_cell("qwen15_4b", "long_500k", True, verbose=False)
    assert skip == dict(arch="qwen15_4b", shape="long_500k", mesh="multi",
                        chips=512, n_micro=1, status="skipped",
                        why="pure full-attention arch: long_500k skipped")
    assert "skipped" in report.roofline_table([skip], "multi")
