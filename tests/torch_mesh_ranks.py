"""The cases of ``tests/test_torch_mesh.py``, run by each rank of a
4-rank gloo process mesh on the CPU and, with ``mesh=None``, by the
test process as the port's in-process simulation.

This module imports the port only (no JAX, no repro): the ranks are
spawned processes that unpickle ``main`` from here.  ``run_cases``
returns a dict of host values; the test compares the ranks' dicts with
each other, with the simulation's and with repro's answers.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.partition import api as tapi  # noqa: E402
from repro_torch.data import spatial_gen  # noqa: E402
from repro_torch.dist import compress, parallel, sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api, lm, moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.query import engine as tengine  # noqa: E402
from repro_torch.query import parallel_partition as tpp  # noqa: E402
from repro_torch.serve import PlacementPolicy, ServeConfig, SpatialServer  # noqa: E402,E501
from repro_torch.serve import frontend as tfe  # noqa: E402
from repro_torch.serve import router  # noqa: E402

RANKS, PAYLOAD, K, MAX_HITS = 4, 150, 5, 2048
TIMEOUT_S = 60.0
LOCAL_INDEXES = ("x", "hilbert", "off")


def host(x):
    """Tensors (in any nesting) -> numpy, for pickling and comparing."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(host(v) for v in x)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


def _parts(inp, method):
    return tapi.Partitioning.from_numpy(inp[f"{method}_boxes"],
                                        inp[f"{method}_valid"], "cpu")


def resident(srv) -> dict:
    """The shard rows this process holds: ``(1, T_rows, ...)`` on a
    rank, every owner's ``(D, T_rows, ...)`` in the simulation."""
    s = srv.slayout
    return dict(canon=s.canon_shards, ids=s.id_shards, alive=s.alive_shards,
                chunk=s.chunk_shards, extent=srv.tiles.extent,
                owner=s.owner, local=s.local, rep_owner=s.rep_owner,
                rep_local=s.rep_local)


def answers(srv, qb, pts, dense=True) -> dict:
    out = dict(counts=srv.range_counts(qb),
               ids=srv.range_ids(qb, max_hits=MAX_HITS),
               knn=srv.knn(pts, K))
    if dense:
        out.update(d_counts=srv.range_counts(qb, pruned=False),
                   d_ids=srv.range_ids(qb, max_hits=MAX_HITS, pruned=False),
                   d_knn=srv.knn(pts, K, pruned=False))
    return out


def sharded_cases(mesh, inp) -> dict:
    """Sharded bsp and hc at every local index; on bsp "x" the resident
    rows and the host plan of a counts batch and a kNN batch."""
    out = {}
    qb, pts = torch.from_numpy(inp["qb"]), torch.from_numpy(inp["pts"])
    for m in ("bsp", "hc"):
        for li in LOCAL_INDEXES:
            srv = SpatialServer(_parts(inp, m), inp["mbrs"], ServeConfig(
                placement="sharded", shards=RANKS, local_index=li),
                device="cpu", method=m, mesh=mesh)
            out[f"{m}/{li}"] = answers(srv, qb, pts)
            if li == "x":
                out[f"{m}/x/resident"] = resident(srv)
                out[f"{m}/x/stats"] = dict(srv.stats)
                hit = router.probe_overlap(srv.probe_boxes, qb)
                cand, _, _ = router.candidates_from_overlap(hit, 16)
                costs = hit.sum(1).numpy().astype(np.float64)
                out[f"{m}/x/plan_counts"] = srv.tiles._host_plan(
                    cand, costs)[:3]
                kc, _, _ = router.candidate_knn(srv.probe_boxes, pts, 8)
                out[f"{m}/x/plan_knn"] = srv.tiles._host_plan(
                    kc, np.ones(pts.shape[0]))[:3]
    return out


def replicated_cases(mesh, inp) -> dict:
    qb, pts = torch.from_numpy(inp["qb"]), torch.from_numpy(inp["pts"])
    srv = SpatialServer(_parts(inp, "bsp"), inp["mbrs"], ServeConfig(),
                        device="cpu", method="bsp", mesh=mesh)
    out = dict(answers=answers(srv, qb, pts))
    hit = router.probe_overlap(srv.probe_boxes, qb)
    out["fanout"] = hit.sum(1).numpy()
    return out


def heat_cases(mesh, inp) -> dict:
    """The reference's mesh heat case: hot counts batches, a rebalance
    (tiles change owner), answers, then append, delete and compact
    through the replicas."""
    qh, pts = torch.from_numpy(inp["qhot"]), torch.from_numpy(inp["pts"])
    cfg = ServeConfig(placement="heat", shards=RANKS, slack=64,
                      compact_dead_frac=None,
                      policy=PlacementPolicy(heat_decay=0.9, replicate_top=2))
    srv = SpatialServer(_parts(inp, "bsp"), inp["mbrs"], cfg, device="cpu",
                        method="bsp", mesh=mesh)
    out = dict(before=resident(srv))
    for _ in range(3):
        srv.range_counts(qh)
    out["rebalance"] = srv.rebalance()
    out["after"] = resident(srv)
    out["answers"] = answers(srv, qh, pts)
    out["append"] = srv.append(inp["heat_append"])
    out["delete"] = srv.delete(np.arange(0, 64, 4))
    out["compact"] = srv.compact()
    out["final"] = answers(srv, qh, pts)
    out["resident"] = resident(srv)
    out["stats"] = dict(srv.stats)
    # rebalance_every: the server re-plans itself every 2 routed batches
    srv = SpatialServer(_parts(inp, "bsp"), inp["mbrs"], ServeConfig(
        placement="sharded", shards=RANKS,
        policy=PlacementPolicy(rebalance_every=2)), device="cpu",
        method="bsp", mesh=mesh)
    out["every"] = dict(counts=[srv.range_counts(qh)[0] for _ in range(5)],
                        owner=srv.slayout.owner, stats=dict(srv.stats),
                        resident=resident(srv))
    return out


def ingest_cases(mesh, inp) -> dict:
    """A stream on a sharded server: append, delete, update, compact and
    an overflow re-stage; each rank's extent and alive rows after every
    command, and the answers at the end."""
    qb, pts = torch.from_numpy(inp["qb"]), torch.from_numpy(inp["pts"])
    srv = SpatialServer(_parts(inp, "bsp"), inp["mbrs"], ServeConfig(
        placement="sharded", shards=RANKS, slack=32), device="cpu",
        method="bsp", mesh=mesh)
    n = inp["mbrs"].shape[0]
    steps = [("append", lambda: srv.append(inp["stream_append"])),
             ("delete", lambda: srv.delete(inp["stream_delete"])),
             ("update", lambda: srv.update(inp["stream_update_ids"],
                                           inp["stream_update_boxes"])),
             ("compact", srv.compact),
             ("burst", lambda: srv.append(inp["stream_burst"]))]
    out = {}
    for name, fn in steps:
        rep = fn()
        out[name] = dict(report=rep, extent=srv.tiles.extent.clone(),
                         alive=srv.slayout.alive_shards.clone(),
                         stats={k: srv.stats[k] for k in (
                             "n", "n_total", "cap", "t_live", "restages",
                             "compactions", "shards", "t_local")})
    out["answers"] = answers(srv, qb, pts)
    out["n0"] = n
    return out


def frontend_cases(mesh, inp) -> dict:
    """Padded batches and a seeded open-loop run through a sharded
    server; the simulator is given a fixed service time, so the plane's
    decisions are the same on every rank."""
    qb, pts = inp["qb"], inp["pts"]
    srv = SpatialServer(_parts(inp, "bsp"), inp["mbrs"], ServeConfig(
        placement="sharded", shards=RANKS), device="cpu", method="bsp",
        mesh=mesh)
    nq = qb.shape[0]
    reqs = [tfe.Request("range_ids", qb[i], (256,)) for i in range(nq)]
    out = dict(batch=tfe.execute_batch(
        srv, tfe.Batch("range_ids", (256,), reqs, 32, 0.0)))
    rng = np.random.default_rng(9)
    arrivals, t = [], 0.0
    for i in range(48):
        t += float(rng.exponential(2e-3))
        u = rng.random()
        if u < 0.6:
            kind, q, params = "range_counts", qb[i % nq], ()
        elif u < 0.85:
            kind, q, params = "range_ids", qb[i % nq], (64,)
        else:
            kind, q, params = "knn", pts[i % nq], (3, 256)
        arrivals.append(tfe.Arrival(t, kind, q, params, f"t{i % 3}"))

    def execute(server, batch):
        return tfe.execute_batch(server, batch), 1e-3

    resp, metrics = tfe.simulate_open_loop(
        srv, arrivals, tfe.FrontendConfig(ladder=(4, 8, 16),
                                          max_delay=4e-3), execute=execute)
    out["open_loop"] = [(r.outcome.name, r.value, r.queue_s)
                        for r in resp]
    out["metrics"] = metrics.snapshot()
    return out


def join_cases(mesh, inp) -> dict:
    r, s = inp["join_r"], inp["join_s"]
    out = {}
    for m in ("bsp", "hc"):
        plan = tengine.plan_join(m, r, s, 200, RANKS, device="cpu")
        stats = {}
        rid, sid, uniq = tengine.masj_pairs(plan, mesh, stats=stats)
        out[m] = dict(
            rp=tengine.run_join_count(plan, mesh),
            raw=tengine.run_join_count(plan, mesh, dedup="none"),
            masj=tengine.run_join_pairs_masj(plan, mesh),
            spatial=tengine.spatial_join_count(plan, mesh),
            short=tengine.run_join_pairs_masj(plan, mesh,
                                              max_pairs_per_tile=16),
            pairs=(rid, sid, uniq), pair_stats=stats)
    return out


def partition_cases(mesh, inp) -> dict:
    mbrs = torch.from_numpy(inp["pp_mbrs"])
    out = {}
    for name, spl in (("given", torch.from_numpy(inp["pp_splitters"])),
                      ("own", None)):
        parts, stats = tpp.parallel_partition(mbrs, 100, RANKS, mesh,
                                              splitters=spl)
        out[name] = dict(boxes=parts.boxes, valid=parts.valid, stats=stats)
    return out


def compress_cases(mesh, inp) -> dict:
    """``compressed_psum`` with error feedback over the ranks: rank r
    reduces row r of ``compress_x`` a step (the simulation, one rank,
    row 0), each step's reduction and residual; and the reference's
    drift case, the same ``linspace`` on every rank for 20 steps."""
    xs = torch.from_numpy(inp["compress_x"][0 if mesh is None
                                            else mesh.rank])
    err = {"w": torch.zeros(xs.shape[1])}
    reds, errs = [], []
    for x in xs:
        red, err = compress.compressed_psum({"w": x}, mesh, err)
        reds.append(red["w"])
        errs.append(err["w"])
    g = {"w": torch.linspace(-1, 1, 64)}
    err = {"w": torch.zeros(64)}
    acc_true, acc_q = torch.zeros(64), torch.zeros(64)
    for _ in range(20):
        red, err = compress.compressed_psum(g, mesh, err)
        acc_true += g["w"]
        acc_q += red["w"]
    return dict(red=torch.stack(reds), err=torch.stack(errs),
                drift=float((acc_q - acc_true).abs().max()
                            / acc_true.abs().max()))


MODEL_ARCHS = ("mixtral_8x22b", "qwen15_4b")
MICRO_ARCH = "mixtral_8x22b"    # also stepped with n_micro 2 on (2, 2)
AXES = ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def model_cfg(arch: str):
    """The smoke config at vocab 512 in float32 (the sharded step's
    cases)."""
    return dataclasses.replace(configs.smoke(arch), vocab=512,
                               dtype="float32")


def initial_state(inp, arch: str):
    """The train state the test process carried across from repro's
    ``init_train_state`` (a checkpoint of step 0) -> (cfg, model, opt,
    state), the state whole on the CPU."""
    cfg = model_cfg(arch)
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    like = api.init_train_state(model, torch.Generator().manual_seed(0),
                                opt)
    state, _ = store.restore(os.path.join(str(inp["model_ckpt"]), arch),
                             like)
    return cfg, model, opt, state


def whole_state(state, specs: dict, mesh, cfg) -> dict:
    """Parameters and moments gathered to their logical shapes."""
    named = lm.named_leaves(state.params, cfg)

    def g(t, k):
        t = t.detach()
        return t if mesh is None else parallel.unshard(t, specs[k], mesh)

    return dict(params={k: g(p, k) for k, p in named.items()},
                m={k: g(state.opt.m[k], k) for k in named},
                v={k: g(state.opt.v[k], k) for k in named})


def _axes_case(meshes) -> dict:
    """Each mesh's coordinates, its collectives along each axis (a sum
    and a tiled gather of the global rank), and a mean."""
    out = {}
    for name, m in meshes.items():
        r = torch.tensor([float(m.rank)])
        out[name] = dict(
            coords=m.coords, shape=m.shape, dp=mesh_lib.dp_axes(m),
            **{f"sum_{a}": m.all_reduce(r, axis=a) for a in AXES},
            **{f"gather_{a}": m.all_gather(r, axis=a, dim=0) for a in AXES},
            mean_model=m.all_reduce(r, "mean", axis="model"))
    return out


def _local_moe_case(meshes, inp) -> dict:
    """Mixtral's layer-0 MoE on ``moe_x`` (4 rows): the local form and
    the GSPMD form on the (2, 2) mesh, each rank its data rows, forward
    and backward against ``moe_gy``; with ``meshes`` None the one-device
    math on each data shard and on the whole batch."""
    cfg, _, _, state = initial_state(inp, "mixtral_8x22b")
    whole = state.params.blocks[0].moe
    x, gy = (torch.from_numpy(inp[k]) for k in ("moe_x", "moe_gy"))
    named = dict(whole.named_parameters())

    def run(fn, xs, gys, p, lb_scale=1.0):
        xs = xs.clone().requires_grad_(True)
        y, aux = fn(xs, p)
        loss = (y * gys).sum() + lb_scale * aux["lb_loss"]
        leaves = [xs] + [getattr(p, k) for k in ("wr", "w1", "w2")]
        grads = torch.autograd.grad(loss, leaves)
        return dict(y=y.detach(), aux={k: v.detach() for k, v in aux.items()},
                    dx=grads[0], **{f"d{k}": g for k, g in zip(
                        ("wr", "w1", "w2"), grads[1:])})

    with torch.no_grad():
        for t in named.values():
            t.requires_grad_(True)
    if meshes is None:
        return dict(
            local=[run(lambda a, p: moe._moe_math(a, p, cfg), x[i:i + 2],
                       gy[i:i + 2], whole) for i in (0, 2)],
            gspmd=run(lambda a, p: moe.moe_ffn(a, p, cfg), x, gy, whole))
    m = meshes["2x2"]
    specs = sharding.param_specs(named, cfg, shard_experts=False, mesh=m)
    shard = types.SimpleNamespace(**{
        k: parallel.shard(t.detach(), specs[f"{k}"], m).requires_grad_(True)
        for k, t in named.items()})
    par = parallel.Parallel.of(m, x.shape[0])
    rows = slice(2 * m.coords["data"], 2 * m.coords["data"] + 2)
    moe.set_local_moe((m, ("data",), "model", "data"))
    try:
        local = run(lambda a, p: moe.moe_ffn(a, p, cfg), x[rows], gy[rows],
                    shard)
    finally:
        moe.set_local_moe(None)
    gspmd = run(lambda a, p: moe.moe_ffn(a, p, cfg, par), x[rows], gy[rows],
                shard, 0.5)
    return dict(local=local, gspmd=gspmd, specs=specs)


def model_cases(mesh, inp) -> dict:
    """The sharded train step of each ``MODEL_ARCHS`` on a (2, 2) and a
    (1, 4) ``("data", "model")`` mesh over the same ranks (one step on
    ``tokens_<arch>``, the state gathered after it; ``MICRO_ARCH`` on
    (2, 2) with ``n_micro`` 2 as well), mixtral's state
    saved from (2, 2) and restored onto (1, 4), and the MoE layer's two
    mesh forms; with ``mesh`` None the one-device step and math."""
    meshes = None if mesh is None else {
        name: mesh_lib.make_mesh(mesh, dims, AXES, timeout=TIMEOUT_S)
        for name, dims in MESHES.items()}
    out = {} if meshes is None else dict(axes=_axes_case(meshes))
    ckpt = os.path.join(str(inp["model_ckpt"]), "after_2x2")
    runs = [(arch, name, m, 1) for arch in MODEL_ARCHS
            for name, m in ({"one": None} if meshes is None
                            else meshes).items()]
    runs += [(MICRO_ARCH, name, m, 2) for arch, name, m, _ in runs
             if arch == MICRO_ARCH and name != "1x4"]
    for arch, name, m, n_micro in runs:
        cfg, model, opt, state = initial_state(inp, arch)
        specs = sharding.param_specs(state.params, cfg,
                                     shard_experts=cfg.shard_experts,
                                     mesh=m)
        if m is not None:
            state = sharding.shard_train_state(state, specs, m)
        step = api.make_train_step(model, opt, n_micro=n_micro, mesh=m)
        tokens = torch.from_numpy(inp[f"tokens_{arch}"])
        state, metrics = step(state, {"tokens": tokens})
        key = f"{arch}/{name}" + ("" if n_micro == 1 else "/micro2")
        out[key] = dict(metrics={k: float(v) for k, v in metrics.items()},
                        **whole_state(state, specs, m, cfg))
        if arch == "mixtral_8x22b" and name == "2x2" and n_micro == 1:
            store.save(ckpt, state, 1, parallel.StateSpecs(m, specs))
    if meshes is not None:
        m = meshes["1x4"]
        cfg, _, _, like = initial_state(inp, "mixtral_8x22b")
        specs = sharding.param_specs(like.params, cfg,
                                     shard_experts=cfg.shard_experts, mesh=m)
        like = sharding.shard_train_state(like, specs, m)
        state, step = store.restore(ckpt, like,
                                    shardings=parallel.StateSpecs(m, specs))
        out["restore"] = dict(
            step=step, local={k: tuple(p.shape) for k, p in
                              state.params.named_parameters()},
            **whole_state(state, specs, m, cfg))
    out["moe"] = _local_moe_case(meshes, inp)
    out["extra"] = _extra_step_cases(None if meshes is None
                                     else meshes["2x2"])
    out["ft"] = _ft_case(None if meshes is None else meshes["2x2"],
                         str(inp["model_ckpt"]))
    return out


# port-only cases of the (2, 2) step against one device: arch -> the
# step's options, the global batch's rows (3 does not split over 2 data
# ranks: the batch stays whole on every rank) and config changes (two
# super-blocks of two MoE layers and a `rest` one, whose unstacked
# experts the reference's rule splits on D)
EXTRA_STEPS = {
    "arctic_480b": ({}, 4, {}),        # E-split experts, dense residual
    "whisper_medium": ({}, 4, {}),     # encdec: weights gathered whole
    "internvl2_26b": ({}, 4, {}),      # the vlm's image prefix
    "gemma2_27b": ({}, 4, {}),         # softcaps, post-norms, local/global
    "mixtral_8x22b/rest": ({}, 4, dict(block_pattern=("moe", "moe"),
                                       n_layers=5, shard_experts=True)),
    "qwen15_4b/micro2": ({"n_micro": 2}, 4, {}),
    "qwen15_4b/bf16": ({"bf16_weight_gather": True}, 4, {}),
    "qwen15_4b/rows3": ({}, 3, {}),
}


def extra_batch(cfg, rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (rows, 16)).astype(np.int64))}
    if cfg.family == "vlm":
        out["img"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.vis_tokens, cfg.vis_dim)).astype(np.float32))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.src_len, cfg.d_model)).astype(np.float32))
    return out


def _extra_step_cases(mesh) -> dict:
    """Two steps of each ``EXTRA_STEPS`` case from the port's own seeded
    init, on ``mesh`` (None: one device) -> metrics and the gathered
    state."""
    out = {}
    for name, (kw, rows, change) in EXTRA_STEPS.items():
        cfg = dataclasses.replace(model_cfg(name.split("/")[0]), **change)
        model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
        state = api.init_train_state(model, torch.Generator().manual_seed(3),
                                     opt, mesh=mesh)
        specs = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                     shard_experts=cfg.shard_experts,
                                     mesh=mesh)
        step = api.make_train_step(model, opt, mesh=mesh, **kw)
        metrics = []
        for i in range(2):
            state, m = step(state, extra_batch(cfg, rows, 30 + i))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = dict(metrics=metrics,
                         **whole_state(state, specs, mesh, cfg))
    return out


def _ft_case(mesh, root: str) -> dict:
    """``ft.run_loop`` over 4 steps of the qwen smoke config, a
    checkpoint each step and a failure injected at step 2, on ``mesh``
    (its checkpoints written and restored through ``StateSpecs``) ->
    the restarts and the gathered state."""
    from repro_torch.ft import runtime
    cfg = model_cfg("qwen15_4b")
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    state = api.init_train_state(model, torch.Generator().manual_seed(5),
                                 opt, mesh=mesh)
    specs = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                 shard_experts=cfg.shard_experts, mesh=mesh)
    ft = runtime.FTConfig(os.path.join(
        root, "ft_" + ("one" if mesh is None else "2x2")), ckpt_every=1)
    batches = [extra_batch(cfg, 4, 40 + i) for i in range(4)]
    state, metrics, info = runtime.run_loop(
        api.make_train_step(model, opt, mesh=mesh), state, batches, ft,
        inject_failure_at=2, shardings=None if mesh is None
        else parallel.StateSpecs(mesh, specs))
    return dict(info={k: info[k] for k in ("restarts", "steps")},
                loss=float(metrics["loss"]), step=int(state.step),
                **whole_state(state, specs, mesh, cfg))


# the sharded serve steps' cases: arch -> layouts, a layout (global
# batch, cache length, cache_shard); a length of 4 puts one slot on
# each of 4 ranks; "b4kv"'s length 3 splits no slot axis, so its cache
# splits over the kv heads on (2, 2); mixtral's ring (its window cut to
# 4, SERVE_WINDOW) wraps in 6 steps
SERVE_LAYOUTS = {"b4w": (4, 4, "w"), "b1w": (1, 4, "w"),
                 "b1hd": (1, 4, "hd"), "b4kv": (4, 3, "w"),
                 "b1ring": (1, 6, "w")}
SERVE_WINDOW = 4
SERVE_CASES = {
    "2x2": {"qwen15_4b": ("b4w", "b1w", "b1hd", "b4kv"),
            "mamba2_1p3b": ("b4w",), "recurrentgemma_9b": ("b1w",),
            "mixtral_8x22b": ("b1ring",), "whisper_medium": ("b4w",)},
    "1x4": {"qwen15_4b": ("b1w", "b1hd")},
}
PREFILL_ARCHS = ("qwen15_4b", "whisper_medium")   # the sharded prefill's
PREFILL_LEN, GREEDY_STEPS = 16, 3


def serve_inputs(arch: str, batch: int, length: int) -> dict:
    """A serve case's seeded parameters (the port's own init), tokens
    (B, L) and, for the encoder-decoder, frames."""
    cfg = model_cfg(arch)
    if cfg.window:
        cfg = dataclasses.replace(cfg, window=SERVE_WINDOW)
    params = api.build(cfg, "cpu").init_params(
        torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    out = dict(cfg=cfg, params=params, tokens=torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, length)).astype(np.int64)))
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.src_len, cfg.d_model)).astype(np.float32))
    return out


def _serve_run(m, arch: str, layout: str) -> dict:
    """Decode every position of the layout's tokens on mesh ``m`` from a
    zero cache (teacher forcing) -> this rank's rows, their logits a
    step (B_rank, L, V), the cache specs, and the serve step's greedy
    tokens for the first ``GREEDY_STEPS`` positions."""
    from repro_torch.launch import cells, shapes
    from repro_torch.models import encdec
    batch, length, shard = SERVE_LAYOUTS[layout]
    inp = serve_inputs(arch, batch, length)
    cfg, params, tokens = inp["cfg"], inp["params"], inp["tokens"]
    family = encdec if cfg.family == "encdec" else lm

    def zero_cache():
        with torch.no_grad():
            return (encdec.init_cache(params, inp["frames"], cfg, length)
                    if cfg.family == "encdec"
                    else lm.init_cache(cfg, batch, length, "cpu"))

    cache = zero_cache()
    specs = cells.cache_specs(cfg, shapes.ShapeSpec(layout, length, batch,
                                                    "decode"),
                              m, cache, shard)
    fresh = cells.shard_cache(zero_cache(), specs, m)
    cache = cells.shard_cache(cache, specs, m)
    sharding.shard_params(params, sharding.param_specs(
        params, cfg, shard_experts=cfg.shard_experts, mesh=m), m)
    par = parallel.Parallel.of(m, batch)
    logits = []
    with torch.no_grad():
        for pos in range(length):
            lg, cache = family.decode_step(params, cache,
                                           par.rows(tokens[:, pos]), pos,
                                           cfg, par, specs)
            logits.append(lg)
    serve = api.make_serve_step(api.build(cfg, "cpu"), mesh=m, specs=specs)
    greedy = []
    for pos in range(GREEDY_STEPS):
        nxt, fresh = serve(params, fresh, tokens[:, pos], pos)
        greedy.append(nxt)
    return dict(rows=par.rows(torch.arange(batch)), specs=specs,
                logits=torch.stack(logits, 1), greedy=torch.stack(greedy, 1))


def _prefill_run(m, arch: str) -> torch.Tensor:
    """The sharded prefill's logits block on ``m`` (batch 4)."""
    inp = serve_inputs(arch, 4, PREFILL_LEN)
    cfg, params = inp["cfg"], inp["params"]
    batch = {k: inp[k] for k in ("tokens", "frames") if k in inp}
    sharding.shard_params(params, sharding.param_specs(
        params, cfg, shard_experts=cfg.shard_experts, mesh=m), m)
    return api.make_prefill_step(api.build(cfg, "cpu"), mesh=m)(params,
                                                                batch)


def _timed_train_step(m):
    """One sharded train step of the qwen smoke config (the port's own
    seeded init, ``extra_batch``) on ``m`` -> the calls and bytes its
    collectives sent (``mesh.timers``)."""
    cfg = model_cfg("qwen15_4b")
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    state = api.init_train_state(model, torch.Generator().manual_seed(3),
                                 opt, mesh=m)
    step = api.make_train_step(model, opt, mesh=m)
    m.reset_timers()
    step(state, extra_batch(cfg, 4, 30))
    return {k: m.timers[k] for k in ("calls", "bytes")}


def serve_cases(mesh, inp) -> dict:
    """The sharded prefill and decode of ``SERVE_CASES`` on their (2, 2)
    and (1, 4) meshes, and the (2, 2) train step's collective calls and
    bytes (held against a ``RecordingMesh`` in the test process); with
    ``mesh`` None nothing (the test holds the ranks to repro)."""
    if mesh is None:
        return {}
    out = {}
    for name, dims in MESHES.items():
        m = mesh_lib.make_mesh(mesh, dims, AXES, timeout=TIMEOUT_S)
        for arch, layouts in SERVE_CASES[name].items():
            if arch in PREFILL_ARCHS:
                out[f"{arch}/{name}/prefill"] = _prefill_run(m, arch)
            for layout in layouts:
                out[f"{arch}/{name}/{layout}"] = _serve_run(m, arch, layout)
        if name == "2x2":
            out["timers"] = _timed_train_step(m)
    return out


CASES = dict(sharded=sharded_cases, replicated=replicated_cases,
             heat=heat_cases, ingest=ingest_cases, frontend=frontend_cases,
             join=join_cases, partition=partition_cases,
             compress=compress_cases, model=model_cases, serve=serve_cases)


def run_cases(mesh, inp) -> dict:
    return {name: host(fn(mesh, inp)) for name, fn in CASES.items()}


def main(rank: int, size: int, path: str, fail_rank: int | None = None):
    """One rank: join the gloo mesh through the ``file://`` store under
    ``path``, run every case on ``path/inputs.npz`` and write
    ``path/rank{rank}.pkl``.  With ``fail_rank`` that rank raises after
    the join while the others wait in a collective."""
    torch.set_num_threads(1)
    mesh = mesh_lib.init_process_mesh("gloo", f"file://{path}/store", rank,
                                      size, "cpu", timeout=TIMEOUT_S)
    try:
        if fail_rank is not None:
            if rank == fail_rank:
                raise RuntimeError(f"rank {rank} fails on purpose")
            mesh.barrier()
            return
        with np.load(os.path.join(path, "inputs.npz")) as z:
            inp = {k: z[k] for k in z.files}
        out = run_cases(mesh, inp)
        with open(os.path.join(path, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        mesh_lib.close(mesh)


def cuda_inputs(n: int = 20_000, q: int = 64):
    """The card test's objects, bsp partition, query boxes and points,
    made on the card from fixed seeds (the same in every process)."""
    mbrs = spatial_gen.osm_like(n, seed=3, device="cuda")
    parts = tapi.partition("bsp", mbrs, PAYLOAD)
    g = torch.Generator(device="cuda").manual_seed(4)
    c = torch.rand(q, 2, generator=g, device="cuda")
    s = torch.rand(q, 2, generator=g, device="cuda") * 0.03
    pts = torch.rand(q, 2, generator=g, device="cuda")
    return mbrs, parts, torch.cat([c - s, c + s], 1), pts


def cuda_answers(mesh, shards: int) -> dict:
    mbrs, parts, qb, pts = cuda_inputs()
    srv = SpatialServer(parts, mbrs, ServeConfig(placement="sharded",
                                                 shards=shards),
                        device="cuda", method="bsp", mesh=mesh)
    out = dict(counts=srv.range_counts(qb)[0],
               ids=srv.range_ids(qb, max_hits=MAX_HITS)[:3],
               knn=srv.knn(pts, K)[:3], rows=srv.slayout.id_shards.shape[0])
    if mesh is not None:
        out["timers"] = dict(mesh.timers)
    return host(out)


def cuda_main(rank: int, size: int, path: str):
    """One CUDA rank on the one card over gloo: the sharded answers of
    ``cuda_answers`` -> ``path/cuda{rank}.pkl``."""
    mesh = mesh_lib.init_process_mesh("gloo", f"file://{path}/store", rank,
                                      size, "cuda", timeout=TIMEOUT_S)
    try:
        out = cuda_answers(mesh, size)
        with open(os.path.join(path, f"cuda{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        mesh_lib.close(mesh)
