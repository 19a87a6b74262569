"""repro_torch's mesh mode: four spawned ranks of a gloo process group
on the CPU (``launch.mesh``), spawned once for the file, each running
``tests/torch_mesh_ranks.py``'s cases and pickling its answers, held
against the port's in-process simulation (the same cases with
``mesh=None``, run here while the ranks run) and, for sharded serving,
against repro's ``mesh=None`` server with 4 shards, which the
reference's own mesh tests show equal to its mesh.  The cases follow
the reference's mesh tests (``tests/test_sharded_serving.py``,
``tests/test_local_index.py``, ``tests/test_heat_placement.py``,
``tests/test_ingest_streams.py``, ``tests/test_frontend.py``; osm,
2,000 objects, 32 queries, k = 5): sharded bsp and hc counts, ids and
kNN, pruned and dense, at local index "x", "hilbert" and "off"; the
replicated placement's query-sharded step and its skew; heat placement
and a rebalance that moves tiles between ranks, and ``rebalance_every``;
an ingest stream with
each rank's extent and alive rows after every command; the request
plane over a mesh server; the join's rp count and MASJ pairs on bsp
and hc plans; ``parallel_partition`` at D = 4; ``compressed_psum``'s
error feedback; that a rank holds only
its own rows; that the host plans agree on every rank; and that a rank
which raises fails the run within its deadline.  Only this process
imports repro; the ranks import only the port.  Tolerance: exact
equality throughout, but for ``compressed_psum``'s float32 sum over the
ranks (2 ulps: gloo's order of summation is its own).

The model side (the same four processes lay themselves out as a (2, 2)
and a (1, 4) ``("data", "model")`` mesh beside the "d" one): the port's
sharded train step of the mixtral and qwen1.5 smoke configs (vocab 512,
float32, 4 x 32 tokens, repro's ``init_train_state(PRNGKey(0))``
carried across; mixtral with ``n_micro`` 1 and 2) against repro's
sharded step on a (2, 2) host mesh
(``tests/test_multidevice.py``'s program, run in a subprocess with 4
host devices) and against the port's one-device step; the MoE layer's
local (``set_local_moe``) and GSPMD forms against repro's
``moe_ffn_local`` and the one-device math; a checkpoint saved on (2, 2)
and restored onto (1, 4) and onto one device.  Tolerances (float32;
the sums run in other orders across ranks and in XLA): loss and
``grad_norm`` within 1e-5 relative, ``lr`` 1e-6, the MoE payload stats
exact; each moment within 1e-5 of its leaf's largest |value| and each
parameter within 1e-7 (a step moves it by about ``lr``, 3e-6; the
measured gaps are stated at ``test_sharded_step_matches_repro``); the
MoE outputs and gradients within 1e-5 of their largest; the restore
bit for bit."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses
import pickle
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as tm
from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.models import api as jmapi
from repro.optim import adamw as jadamw
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.serve import layout as jlayout
from repro import configs as jconfigs
from repro_torch.checkpoint import store
from repro_torch.core import metrics
from repro_torch.core.partition import partition_counts
from repro_torch.dist import compress
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, lm
from repro_torch.optim import adamw
from repro_torch.query import parallel_partition as tpp

torch.set_num_threads(1)
N, NQ, DEADLINE_S = 2000, 32, 120.0
STEPS = ("append", "delete", "update", "compact", "burst")


def _inputs() -> dict:
    """repro's osm objects and bsp/hc partitions, numpy query streams,
    an ingest stream that ends in an overflow re-stage, join inputs and
    parallel-partition inputs (splitters drawn by the port)."""
    mbrs = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), N))
    inp = dict(mbrs=mbrs)
    for m in ("bsp", "hc"):
        p = japi.partition(m, jnp.asarray(mbrs), tm.PAYLOAD)
        inp[f"{m}_boxes"] = np.asarray(p.boxes)
        inp[f"{m}_valid"] = np.asarray(p.valid)
    rng = np.random.default_rng(1)
    c, s = rng.random((NQ, 2)), rng.random((NQ, 2)) * 0.05
    inp["qb"] = np.concatenate([c - s, c + s], -1).astype(np.float32)
    inp["pts"] = np.random.default_rng(2).random((NQ, 2)).astype(np.float32)
    rng = np.random.default_rng(3)
    n_hot = int(NQ * 0.8)
    ctr = rng.random(2) * 0.6 + 0.2
    c = np.concatenate([ctr + (rng.random((n_hot, 2)) - 0.5) * 0.2,
                        rng.random((NQ - n_hot, 2))])
    s = rng.random((NQ, 2)) * 0.05
    s[:n_hot] += 0.08
    inp["qhot"] = np.concatenate([c - s, c + s], -1).astype(np.float32)
    lo = rng.uniform(0.0, 1.0, (NQ, 2)).astype(np.float32)
    ex = rng.uniform(0.0, 0.02, (NQ, 2)).astype(np.float32)
    inp["heat_append"] = np.concatenate([lo, lo + ex], axis=1)
    inp["stream_append"] = (mbrs[rng.choice(N, 100, replace=False)]
                            + np.float32(1e-4))
    inp["stream_delete"] = rng.choice(N, 150, replace=False)
    inp["stream_update_ids"] = np.setdiff1d(np.arange(N),
                                            inp["stream_delete"])[:40]
    inp["stream_update_boxes"] = mbrs[rng.choice(N, 40)] + np.float32(2e-4)
    corner = np.repeat(mbrs[:1, :2], 300, axis=0)
    inp["stream_burst"] = np.concatenate([corner, corner + 1e-5], axis=1)
    inp["join_r"] = np.array(jgen.dataset("osm", jax.random.PRNGKey(4),
                                          3000))
    inp["join_s"] = np.array(jgen.dataset("osm", jax.random.PRNGKey(5),
                                          3000))
    inp["pp_mbrs"] = np.array(jgen.dataset("osm", jax.random.PRNGKey(6),
                                           4000))
    inp["compress_x"] = np.random.default_rng(12).standard_normal(
        (tm.RANKS, 20, 64)).astype(np.float32)
    inp["pp_splitters"] = tpp.coarse_splitters(
        torch.from_numpy(inp["pp_mbrs"]), tm.RANKS, seed=11).numpy()
    return inp


def _repro_sharded(inp) -> dict:
    """repro's ``mesh=None`` sharded "x" servers on bsp and hc."""
    qb, pts = jnp.asarray(inp["qb"]), jnp.asarray(inp["pts"])
    out = {}
    for m in ("bsp", "hc"):
        parts = japi.Partitioning(boxes=jnp.asarray(inp[f"{m}_boxes"]),
                                  valid=jnp.asarray(inp[f"{m}_valid"]))
        srv = JServer(parts, jnp.asarray(inp["mbrs"]), JConfig(
            placement="sharded", shards=tm.RANKS), method=m)
        out[m] = tm.host(jax.tree.map(np.asarray, dict(
            counts=srv.range_counts(qb)[0],
            ids=srv.range_ids(qb, max_hits=tm.MAX_HITS)[:3],
            knn=srv.knn(pts, tm.K)[:3],
            d_counts=srv.range_counts(qb, pruned=False)[0],
            d_ids=srv.range_ids(qb, max_hits=tm.MAX_HITS, pruned=False)[:3],
            d_knn=srv.knn(pts, tm.K, pruned=False)[:3])))
    return out


ROOT = os.path.join(os.path.dirname(__file__), "..")

# repro's sharded train step on a (2, 2) host mesh (the program of
# tests/test_multidevice.py), and its shard_map MoE form
_REF_PROG = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist import sharding as rules
from repro.models import api, lm, moe
from repro.optim import adamw
path = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('data', 'model'))
for arch in sys.argv[2].split(','):
    cfg = dataclasses.replace(configs.smoke(arch), vocab=512,
                              dtype='float32')
    model, opt = api.build(cfg), adamw.AdamWConfig()
    like = jax.eval_shape(lambda k: api.init_train_state(model, k, opt),
                          jax.random.PRNGKey(0))
    z = np.load(f'{path}/ref_in_{arch}.npz')
    n = sum(f.startswith('leaf') for f in z.files)
    state = jax.tree.unflatten(jax.tree.structure(like),
                               [jnp.asarray(z[f'leaf{i}']) for i in range(n)])
    lm.set_activation_spec(P('data', None, None))
    pspecs = rules.param_specs(state.params, shard_experts=cfg.shard_experts,
                               mesh=mesh)
    ps = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                      is_leaf=lambda x: isinstance(x, P))
    ss = api.TrainState(params=ps, opt=adamw.OptState(
        m=ps, v=ps, step=NamedSharding(mesh, P())),
        step=NamedSharding(mesh, P()))
    bs = {'tokens': NamedSharding(mesh, P('data', None))}
    outs = {}
    for nm in (1, 2) if 'moe_x' in z.files else (1,):
        step = jax.jit(api.make_train_step(model, opt, n_micro=nm),
                       in_shardings=(ss, bs), out_shardings=(ss, None))
        with mesh:
            new, metrics = step(state, {'tokens': jnp.asarray(z['tokens'])})
        outs[nm] = {f'leaf{i}': np.asarray(a)
                    for i, a in enumerate(jax.tree.leaves(new))}
        outs[nm].update({f'metric_{k}': np.asarray(v)
                         for k, v in metrics.items()})
    lm.set_activation_spec(None)
    if 2 in outs:
        np.savez(f'{path}/ref_out_{arch}_micro2.npz', **outs[2])
    out = outs[1]
    if 'moe_x' in z.files:
        moe.set_local_moe((mesh, ('data',), 'model', 'data'))
        p0 = jax.tree.map(lambda a: a[0], state.params['blocks']['p0']['moe'])
        with mesh:
            y, aux = jax.jit(lambda x, p: moe.moe_ffn(x, p, cfg))(
                jnp.asarray(z['moe_x']), p0)
        moe.set_local_moe(None)
        out['moe_y'] = np.asarray(y)
        out.update({f'moe_{k}': np.asarray(v) for k, v in aux.items()})
    np.savez(f'{path}/ref_out_{arch}.npz', **out)
"""


def _jcfg(arch):
    return dataclasses.replace(jconfigs.smoke(arch), vocab=512,
                               dtype="float32")


def _model_inputs(path) -> dict:
    """repro's ``init_train_state(PRNGKey(0))`` of each model arch,
    written as the reference subprocess's input and, carried across, as
    the port's step-0 checkpoint; numpy tokens and MoE inputs."""
    ckpt = os.path.join(path, "model")
    inp = dict(model_ckpt=ckpt)
    rng = np.random.default_rng(21)
    treedefs = {}
    for arch in tm.MODEL_ARCHS:
        jcfg = _jcfg(arch)
        jstate = jax.tree.map(np.asarray, jmapi.init_train_state(
            jmapi.build(jcfg), jax.random.PRNGKey(0), jadamw.AdamWConfig()))
        treedefs[arch] = jax.tree.structure(jstate)
        inp[f"tokens_{arch}"] = rng.integers(0, 512, (4, 32)).astype(np.int32)
        ref_in = {f"leaf{i}": a for i, a in enumerate(jax.tree.leaves(jstate))}
        ref_in["tokens"] = inp[f"tokens_{arch}"]
        if arch == "mixtral_8x22b":
            for k in ("moe_x", "moe_gy"):
                inp[k] = rng.standard_normal(
                    (4, 16, jcfg.d_model)).astype(np.float32)
            ref_in["moe_x"] = inp["moe_x"]
        np.savez(os.path.join(path, f"ref_in_{arch}.npz"), **ref_in)
        state = convert.train_state_from_numpy(
            jstate, tm.model_cfg(arch), adamw.AdamWConfig(), "cpu")
        store.save(os.path.join(ckpt, arch), state, 0)
    return inp, treedefs


def _reference(path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, path, ",".join(tm.MODEL_ARCHS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _repro_serve() -> dict:
    """repro's one-device prefill logits (batch 4) and teacher-forced
    decode logits of every serve case (``tm.SERVE_CASES``), jitted, on
    the port's seeded weights carried across."""
    from repro.models import encdec as jencdec
    out = {}
    cases = {}
    for per_mesh in tm.SERVE_CASES.values():
        for arch, layouts in per_mesh.items():
            cases.setdefault(arch, set()).update(layouts)
    for arch, layouts in cases.items():
        # one run a (batch, length): the layouts differ only in the
        # port's cache split
        runs = {tm.SERVE_LAYOUTS[lay][:2]: lay for lay in sorted(layouts)}
        prefill = ["prefill"] if arch in tm.PREFILL_ARCHS else []
        for layout in list(runs.values()) + prefill:
            b, length = ((4, tm.PREFILL_LEN) if layout == "prefill"
                         else tm.SERVE_LAYOUTS[layout][:2])
            inp = tm.serve_inputs(arch, b, length)
            cfg = inp["cfg"]
            jcfg = dataclasses.replace(_jcfg(arch), window=cfg.window)
            jmodel = jmapi.build(jcfg)
            params = jax.tree.map(jnp.asarray, convert.params_to_numpy(
                inp["params"], cfg))
            tokens = jnp.asarray(inp["tokens"].numpy().astype(np.int32))
            frames = (jnp.asarray(inp["frames"].numpy())
                      if "frames" in inp else None)
            if layout == "prefill":
                batch = {"tokens": tokens}
                if frames is not None:
                    batch["frames"] = frames
                out[f"{arch}/prefill"] = np.asarray(jax.jit(
                    jmapi.make_prefill_step(jmodel))(params, batch))
                continue
            cache = (jencdec.init_cache(params, frames, jcfg, length)
                     if frames is not None
                     else jmodel.init_cache(b, length))
            step = jax.jit(jmodel.decode_step)
            logits = []
            for pos in range(length):
                lg, cache = step(params, cache, tokens[:, pos],
                                 jnp.int32(pos))
                logits.append(np.asarray(lg))
            for lay in layouts:
                if tm.SERVE_LAYOUTS[lay][:2] == (b, length):
                    out[f"{arch}/{lay}"] = np.stack(logits, 1)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the four ranks once and repro's 4-device subprocess;
    meanwhile compute the simulation and repro's answers here ->
    ``(ranks, sim, repro, inputs)``; repro's model-side answers are
    ``repro["model"]``."""
    path = str(tmp_path_factory.mktemp("mesh"))
    inp = _inputs()
    model_inp, treedefs = _model_inputs(path)
    inp.update(model_inp)
    np.savez(os.path.join(path, "inputs.npz"), **inp)
    proc = _reference(path)
    failed = []

    def ranks():
        try:
            mesh_lib.spawn(tm.main, (tm.RANKS, path), tm.RANKS, DEADLINE_S)
        except Exception as e:   # noqa: BLE001 - re-raised below
            failed.append(e)

    serve = {}

    def repro_serve():
        try:
            serve.update(_repro_serve())
        except Exception as e:   # noqa: BLE001 - re-raised below
            failed.append(e)

    threads = [threading.Thread(target=ranks),
               threading.Thread(target=repro_serve)]
    for th in threads:
        th.start()
    try:
        sim = tm.run_cases(None, inp)
        ref = _repro_sharded(inp)
        for th in threads:
            th.join()
        ref["serve"] = serve
        _, err = proc.communicate(timeout=DEADLINE_S)
    finally:
        proc.kill()
    if failed:
        raise failed[0]
    assert proc.returncode == 0, err[-3000:]
    ref["model"] = {}
    for arch in tm.MODEL_ARCHS + (f"{tm.MICRO_ARCH}/micro2",):
        name = arch.replace("/", "_")
        with np.load(os.path.join(path, f"ref_out_{name}.npz")) as z:
            n = sum(f.startswith("leaf") for f in z.files)
            ref["model"][arch] = dict(
                state=jax.tree.unflatten(treedefs[arch.split("/")[0]],
                                         [z[f"leaf{i}"] for i in range(n)]),
                **{f: z[f] for f in z.files if not f.startswith("leaf")})
    got = []
    for r in range(tm.RANKS):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got, sim, ref, inp


def _eq(a, b, path=""):
    """Exact equality of nested answers (arrays, tuples, dicts)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


def _row(x, r):
    """Owner ``r``'s rows of a simulation shard array, as a rank's."""
    return None if x is None else x[r:r + 1]


@pytest.mark.parametrize("li", tm.LOCAL_INDEXES)
@pytest.mark.parametrize("m", ["bsp", "hc"])
def test_sharded_answers_equal_repro_and_the_simulation(run, m, li):
    got, sim, ref, _ = run
    want = sim["sharded"][f"{m}/{li}"]
    for r in range(tm.RANKS):
        _eq(got[r]["sharded"][f"{m}/{li}"], want, f"rank {r}")
    # every answer, pruned and dense, is repro's "x" server's
    for key, val in ref[m].items():
        ans = want[key]
        if key.endswith("counts"):
            ans = ans[0]
        else:
            ans = ans[:3]
        _eq(ans, val, key)


@pytest.mark.parametrize("m", ["bsp", "hc"])
def test_a_rank_holds_only_its_own_rows(run, m):
    got, sim, _, _ = run
    want = sim["sharded"][f"{m}/x/resident"]
    assert want["canon"].shape[0] == tm.RANKS
    for r in range(tm.RANKS):
        mine = got[r]["sharded"][f"{m}/x/resident"]
        for key in ("canon", "ids", "alive", "chunk", "extent"):
            assert mine[key].shape[0] == 1, key
            _eq(mine[key], _row(want[key], r), f"rank {r} {key}")
        _eq(got[r]["sharded"][f"{m}/x/stats"], sim["sharded"][f"{m}/x/stats"])
    # every object's canonical copy lives on exactly one rank
    live = np.concatenate([
        got[r]["sharded"][f"{m}/x/resident"]["ids"][
            got[r]["sharded"][f"{m}/x/resident"]["alive"]]
        for r in range(tm.RANKS)])
    _eq(np.sort(live), np.arange(N, dtype=np.int32))


def test_host_plans_agree_on_every_rank(run):
    got, sim, _, _ = run
    for m in ("bsp", "hc"):
        for key in ("plan_counts", "plan_knn"):
            want = sim["sharded"][f"{m}/x/{key}"]
            for r in range(tm.RANKS):
                _eq(got[r]["sharded"][f"{m}/x/{key}"], want, f"{m} {key}")
        for r in range(tm.RANKS):
            res = got[r]["sharded"][f"{m}/x/resident"]
            for key in ("owner", "local", "rep_owner", "rep_local"):
                _eq(res[key], sim["sharded"][f"{m}/x/resident"][key], key)


def test_replicated_step_is_query_sharded_with_repro_skew(run):
    got, sim, _, _ = run
    want = sim["replicated"]["answers"]
    costs = sim["replicated"]["fanout"].astype(np.float64)
    pack = dict(jlayout.pack_queries(costs, tm.RANKS)[1])
    dense = dict(jlayout.pack_queries(np.ones(NQ), tm.RANKS)[1])
    for r in range(tm.RANKS):
        ans = got[r]["replicated"]["answers"]
        _eq(ans["counts"][0], want["counts"][0])
        _eq(ans["ids"][:3], want["ids"][:3])
        _eq(ans["knn"][:3], want["knn"][:3])
        for key in ("d_counts", "d_ids", "d_knn"):
            a, w = ans[key], want[key]
            _eq(a[0] if key == "d_counts" else a[:3],
                w[0] if key == "d_counts" else w[:3], key)
        for stats, w in ((ans["counts"][1], pack), (ans["ids"][3], pack),
                         (ans["d_counts"][1], dense),
                         (ans["d_ids"][3], dense), (ans["d_knn"][3], dense)):
            assert {k: stats[k] for k in w} == w
        assert ans["knn"][3]["skew"] >= 1.0 and "makespan" in ans["knn"][3]
    assert want["counts"][1]["skew"] == 1.0
    assert "makespan" not in want["counts"][1]


def test_heat_rebalance_moves_rows_between_ranks(run):
    got, sim, _, _ = run
    want = sim["heat"]
    assert want["rebalance"]["moved_tiles"] > 0
    assert not np.array_equal(want["before"]["owner"], want["after"]["owner"])
    for r in range(tm.RANKS):
        mine = got[r]["heat"]
        for key in ("rebalance", "answers", "append", "delete", "compact",
                    "final", "stats"):
            _eq(mine[key], want[key], f"rank {r} {key}")
        for when in ("before", "after", "resident"):
            for key in ("canon", "ids", "alive", "chunk", "extent"):
                _eq(mine[when][key], _row(want[when][key], r),
                    f"rank {r} {when} {key}")


def test_rebalance_every_runs_on_every_rank_alike(run):
    got, sim, _, _ = run
    want = sim["heat"]["every"]
    assert "cut_after" in want["stats"]        # a rebalance re-planned it
    for c in want["counts"][1:]:
        _eq(c, want["counts"][0])
    for r in range(tm.RANKS):
        mine = got[r]["heat"]["every"]
        for key in ("counts", "owner", "stats"):
            _eq(mine[key], want[key], f"rank {r} {key}")
        for key in ("canon", "ids", "alive", "extent"):
            _eq(mine["resident"][key], _row(want["resident"][key], r), key)


@pytest.mark.parametrize("step", STEPS)
def test_ingest_stream_keeps_each_ranks_rows(run, step):
    got, sim, _, _ = run
    want = sim["ingest"][step]
    for r in range(tm.RANKS):
        mine = got[r]["ingest"][step]
        _eq(mine["report"], want["report"], f"rank {r}")
        _eq(mine["stats"], want["stats"], f"rank {r}")
        _eq(mine["extent"], _row(want["extent"], r), f"rank {r} extent")
        _eq(mine["alive"], _row(want["alive"], r), f"rank {r} alive")
    if step == "burst":
        assert want["report"]["restaged"]
    if step == "compact":
        assert want["report"]["compacted_tiles"] > 0


def test_ingest_stream_answers(run):
    got, sim, _, _ = run
    for r in range(tm.RANKS):
        _eq(got[r]["ingest"]["answers"], sim["ingest"]["answers"])
    ans = sim["ingest"]["answers"]
    _eq(ans["counts"][0], ans["d_counts"][0])
    _eq(ans["ids"][:3], ans["d_ids"][:3])


def test_request_plane_over_a_mesh_server(run):
    got, sim, _, _ = run
    for r in range(tm.RANKS):
        _eq(got[r]["frontend"], sim["frontend"], f"rank {r}")
    ids = sim["sharded"]["bsp/x"]["ids"]
    for i, (hid, cnt, ovf) in enumerate(sim["frontend"]["batch"]):
        _eq(hid, ids[0][i][:256])
        assert cnt == int(ids[1][i])
    assert all(o == "OK" for o, _, _ in sim["frontend"]["open_loop"])


@pytest.mark.parametrize("m", ["bsp", "hc"])
def test_join_over_ranks(run, m):
    got, sim, _, _ = run
    want = sim["join"][m]
    for r in range(tm.RANKS):
        _eq(got[r]["join"][m], want, f"rank {r}")
    assert want["short"] <= want["masj"] <= want["raw"]
    if m == "bsp":
        assert want["rp"] == want["masj"] == want["spatial"]
    else:
        assert want["spatial"] == want["masj"]


@pytest.mark.parametrize("which", ["given", "own"])
def test_parallel_partition_over_ranks(run, which):
    got, sim, _, inp = run
    want = sim["partition"][which]
    for r in range(tm.RANKS):
        _eq(got[r]["partition"][which], want, f"rank {r}")
    assert want["stats"]["dropped"] == 0
    parts = tpp.Partitioning(boxes=torch.from_numpy(want["boxes"]),
                             valid=torch.from_numpy(want["valid"]))
    _, copies = partition_counts(torch.from_numpy(inp["pp_mbrs"]), parts)
    assert float(metrics.coverage(copies)) == 1.0


def test_compressed_psum_over_ranks(run):
    """``compressed_psum`` on 4 gloo ranks, each its own gradients for 20
    steps: every rank's residuals equal the in-process computation of
    its own (quantise, dequantise, keep the error) bit for bit, and the
    reduction, the same on every rank, equals the in-process mean of the
    4 dequantised values within 2 float32 ulps of its largest (gloo sums
    the ranks in an order of its own); the reference's drift case stays
    under 1% (``tests/test_multidevice.py``).  Without a mesh the
    reduction is the rank's own dequantised value."""
    got, sim, _, inp = run
    xs = torch.from_numpy(inp["compress_x"])
    err = torch.zeros(xs.shape[0], xs.shape[2])
    for s in range(xs.shape[1]):
        y = xs[:, s] + err
        deq = torch.stack([compress.dequantize(*compress.quantize(y[r]))
                           for r in range(tm.RANKS)])
        err = y - deq
        mean = deq.sum(0) / tm.RANKS
        for r in range(tm.RANKS):
            red = torch.from_numpy(got[r]["compress"]["red"][s])
            np.testing.assert_array_equal(got[r]["compress"]["err"][s],
                                          err[r].numpy())
            _eq(red.numpy(), got[0]["compress"]["red"][s], f"rank {r}")
            ulp = float(torch.finfo(torch.float32).eps * mean.abs().max())
            assert float((red - mean).abs().max()) <= 2 * ulp
        if s == 0:
            np.testing.assert_array_equal(sim["compress"]["red"][0],
                                          deq[0].numpy())
    for r in range(tm.RANKS):
        assert got[r]["compress"]["drift"] < 0.01
    assert sim["compress"]["drift"] < 0.01


def test_a_failing_rank_fails_the_run_within_its_deadline(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the run fails
    (with the raising rank's error, or its peer's broken collective)
    well before the deadline, and no rank is left running."""
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        mesh_lib.spawn(tm.main, (2, str(tmp_path), 1), 2, 60.0)
    assert not isinstance(err.value, TimeoutError)
    assert time.monotonic() - t0 < 60.0


def test_mesh_axis_helpers():
    mesh = mesh_lib.ProcessMesh(None, 1, 4, torch.device("cpu"), "gloo")
    assert mesh.shape == {"d": 4} and mesh.axis_names == ("d",)
    assert mesh_lib.axis_size(mesh, "d") == 4
    assert mesh_lib.axis_size(mesh, "model") == 1
    assert mesh_lib.axis_size(None, "d") == 1
    assert mesh_lib.dp_axes(mesh) == () and mesh_lib.dp_axes(None) == ()
    assert not mesh.host_staging
    assert mesh_lib.in_turns(None, lambda: 7) == 7


def test_two_axis_mesh_helpers():
    mesh = mesh_lib.ProcessMesh(None, 3, 4, torch.device("cpu"), "gloo",
                                axes=("data", "model"), dims=(2, 2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert mesh.coords == {"data": 1, "model": 1}
    assert mesh_lib.dp_axes(mesh) == ("data",)
    assert mesh_lib.axis_size(mesh, "model") == 2
    assert mesh_lib.axis_size(mesh, "pod") == 1
    flat = mesh_lib.ProcessMesh(None, 2, 4, torch.device("cpu"), "gloo",
                                axes=("data", "model"), dims=(1, 4))
    assert flat.coords == {"data": 0, "model": 2}


# ------------------------------ model side --------------------------------

def test_two_axis_meshes_place_ranks_row_major(run):
    """Rank = data index x model size + model index; each axis's
    collectives run over this rank's row or column only."""
    got, _, _, _ = run
    for r in range(tm.RANKS):
        ax = got[r]["model"]["axes"]
        for name, (nd, nm) in tm.MESHES.items():
            a = ax[name]
            assert a["shape"] == {"data": nd, "model": nm}
            assert a["coords"] == {"data": r // nm, "model": r % nm}
            assert a["dp"] == ("data",)
            col = [r % nm + nm * i for i in range(nd)]
            row = [nm * (r // nm) + i for i in range(nm)]
            _eq(a["gather_data"], np.array(col, np.float32))
            _eq(a["gather_model"], np.array(row, np.float32))
            _eq(a["sum_data"], np.array([sum(col)], np.float32))
            _eq(a["sum_model"], np.array([sum(row)], np.float32))
            _eq(a["mean_model"], np.array([sum(row) / nm], np.float32))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _close_state(got: dict, want_tree, cfg, param_tol: float, arch: str):
    """The gathered params and moments against repro's trees: moments
    within 1e-5 of their leaf's largest, params within ``param_tol``;
    returns the largest gaps seen."""
    gaps = dict(params=0.0, m=0.0, v=0.0)
    for part in ("params", "m", "v"):
        tree = convert.tree_to_numpy(
            {k: torch.from_numpy(v) for k, v in got[part].items()}, cfg)
        want = (want_tree.params if part == "params"
                else getattr(want_tree.opt, part))
        assert jax.tree.structure(tree) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
            gap = float(np.abs(a - np.asarray(b)).max())
            if part == "params":
                assert gap <= param_tol, (arch, part, gap)
                gaps[part] = max(gaps[part], gap)
            else:
                scale = float(np.abs(np.asarray(b)).max())
                assert gap <= 1e-5 * scale + 1e-30, (arch, part, gap, scale)
                gaps[part] = max(gaps[part], gap / max(scale, 1e-30))
    return gaps


def _metrics_match(m, want):
    assert sorted(m) == sorted(want)
    assert _rel(m["loss"], want["loss"]) < 1e-5
    assert _rel(m["grad_norm"], want["grad_norm"]) < 1e-5
    assert _rel(m["lr"], want["lr"]) < 1e-6
    for k in m:
        if "skew" in k or "drop" in k:
            assert m[k] == float(want[k]), k


@pytest.mark.parametrize("arch", tm.MODEL_ARCHS)
def test_sharded_step_matches_repro(run, arch):
    """The port's (2, 2) step on every rank: the same metrics and the
    same gathered state everywhere, equal to repro's (2, 2) GSPMD step
    and to the port's one-device step.  Measured: parameters within
    4.1e-8, moments within 1.4e-6 of their leaf's largest.  (A relative
    bound on the parameters would fail on the zero-initialised norms and
    biases: qwen's ``bk`` has a gradient that is zero but for rounding,
    so its update is noise of size ``lr``.)"""
    got, sim, ref, _ = run
    cfg = tm.model_cfg(arch)
    want = ref["model"][arch]
    jm = {k[len("metric_"):]: want[k] for k in want if k.startswith(
        "metric_")}
    one = sim["model"][f"{arch}/one"]
    for r in range(tm.RANKS):
        mine = got[r]["model"][f"{arch}/2x2"]
        _eq(mine, got[0]["model"][f"{arch}/2x2"], f"rank {r}")
    mine = got[0]["model"][f"{arch}/2x2"]
    _metrics_match(mine["metrics"], jm)
    _metrics_match(one["metrics"], jm)
    _close_state(mine, want["state"], cfg, 1e-7, arch)
    _close_state(one, want["state"], cfg, 1e-7, arch)


def test_sharded_step_with_two_microbatches_matches_repro(run):
    """Mixtral with ``n_micro`` 2 on (2, 2): microbatch i is the global
    batch's i-th slice and each data rank takes its rows of it, so the
    MoE routes the same groups of tokens into the same capacity as
    repro's (2, 2) step; the port's one-device step too.  Tolerances as
    in ``test_sharded_step_matches_repro``."""
    got, sim, ref, _ = run
    arch = tm.MICRO_ARCH
    cfg = tm.model_cfg(arch)
    want = ref["model"][f"{arch}/micro2"]
    jm = {k[len("metric_"):]: want[k] for k in want if k.startswith(
        "metric_")}
    for r in range(tm.RANKS):
        _eq(got[r]["model"][f"{arch}/2x2/micro2"],
            got[0]["model"][f"{arch}/2x2/micro2"], f"rank {r}")
    for mine in (got[0]["model"][f"{arch}/2x2/micro2"],
                 sim["model"][f"{arch}/one/micro2"]):
        _metrics_match(mine["metrics"], jm)
        _close_state(mine, want["state"], cfg, 1e-7, arch)


@pytest.mark.parametrize("arch", tm.MODEL_ARCHS)
def test_sharded_step_on_1x4_matches_one_device(run, arch):
    """Four model ranks (mixtral's two kv heads then split across ranks:
    each rank gathers ``wk`` and ``wv`` and takes its query head's kv
    head): the one-device step's metrics and state."""
    got, sim, ref, _ = run
    cfg = tm.model_cfg(arch)
    one = sim["model"][f"{arch}/one"]
    for r in range(tm.RANKS):
        mine = got[r]["model"][f"{arch}/1x4"]
        _eq(mine, got[0]["model"][f"{arch}/1x4"], f"rank {r}")
    mine = got[0]["model"][f"{arch}/1x4"]
    _metrics_match(mine["metrics"], one["metrics"])
    want = ref["model"][arch]["state"]
    _close_state(mine, want, cfg, 1e-7, arch)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), (
        np.abs(a - b).max(), np.abs(b).max())


def test_local_moe_matches_repro_and_each_data_shard(run):
    """``moe_ffn_local`` on (2, 2): each data rank's rows of repro's
    ``shard_map`` output, its aux (``pmean``'d over "model", then
    "data"), and the one-device math on its own rows, forward and
    backward (each rank's expert gradients are its F columns or rows)."""
    got, sim, ref, _ = run
    want = ref["model"]["mixtral_8x22b"]
    shards = sim["model"]["moe"]["local"]
    for r in range(tm.RANKS):
        d, mi = divmod(r, 2)
        mine = got[r]["model"]["moe"]["local"]
        _close(mine["y"], want["moe_y"][2 * d:2 * d + 2])
        for k in ("lb_loss", "expert_skew", "drop_frac"):
            assert _rel(mine["aux"][k], want[f"moe_{k}"]) < 1e-6, k
            mean = np.mean([s["aux"][k] for s in shards])
            assert _rel(mine["aux"][k], mean) < 1e-6, k
        one = shards[d]
        _close(mine["y"], one["y"])
        _close(mine["dx"], one["dx"])
        _close(mine["dwr"], one["dwr"])
        f = mine["dw1"].shape[-1]
        _close(mine["dw1"], one["dw1"][..., mi * f:(mi + 1) * f])
        _close(mine["dw2"], one["dw2"][:, mi * f:(mi + 1) * f])


def test_gspmd_moe_is_the_one_device_math_over_the_global_batch(run):
    """``moe_ffn`` under a mesh: each data rank's rows of the one-device
    output over all 4 rows (capacity from the global token count), the
    global aux, and the gradients: the input's rows, the router's and
    the experts' (summed over the data ranks) equal the one-device
    gradients of ``sum(y * gy) + lb_loss``."""
    got, sim, _, _ = run
    one = sim["model"]["moe"]["gspmd"]
    dw = {k: sum(got[r]["model"]["moe"]["gspmd"][k] for r in (0, 2))
          for k in ("dwr", "dw1", "dw2")}
    for r in range(tm.RANKS):
        d, mi = divmod(r, 2)
        mine = got[r]["model"]["moe"]["gspmd"]
        rows = slice(2 * d, 2 * d + 2)
        _close(mine["y"], one["y"][rows])
        _close(mine["dx"], one["dx"][rows])
        for k in ("lb_loss", "expert_skew", "drop_frac"):
            assert _rel(mine["aux"][k], one["aux"][k]) < 1e-6, k
    _close(dw["dwr"], one["dwr"])
    f = dw["dw1"].shape[-1]
    _close(dw["dw1"], one["dw1"][..., :f])
    _close(dw["dw2"], one["dw2"][:, :f])


def test_elastic_restore_onto_1x4_and_one_device(run):
    """mixtral's state after its (2, 2) step, saved from (2, 2): restored
    onto (1, 4) each rank holds its blocks of the new specs, and the
    gathered state, and a one-device restore, equal the (2, 2) state
    gathered, bit for bit."""
    got, _, _, inp = run
    saved = got[0]["model"]["mixtral_8x22b/2x2"]
    cfg, model, opt, like = tm.initial_state(inp, "mixtral_8x22b")
    for r in range(tm.RANKS):
        mine = got[r]["model"]["restore"]
        assert mine["step"] == 1
        for part in ("params", "m", "v"):
            _eq(mine[part], saved[part], f"rank {r} {part}")
        assert mine["local"]["blocks.0.attn.wq"] == (cfg.d_model,
                                                     cfg.n_heads * cfg.hd // 4)
        assert mine["local"]["blocks.0.moe.w1"][-1] == cfg.moe_ff // 4
    state, step = store.restore(os.path.join(inp["model_ckpt"], "after_2x2"),
                                like)
    assert step == 1
    for k, p in lm.named_leaves(state.params, cfg).items():
        _eq(p.detach().numpy(), saved["params"][k], k)
        _eq(state.opt.m[k].numpy(), saved["m"][k], k)
        _eq(state.opt.v[k].numpy(), saved["v"][k], k)


@pytest.mark.parametrize("case", list(tm.EXTRA_STEPS))
def test_sharded_step_matches_one_device_across_families_and_options(
        run, case):
    """Two (2, 2) steps against two one-device steps from the same
    seeded init: arctic's E-split experts and dense residual, whisper
    (its split weights gathered whole for the forward), internvl2's
    image prefix, gemma2's softcaps and post-norms, mixtral with E-split
    experts and a ``rest`` MoE layer (its experts split on D, gathered
    whole), and qwen with
    ``n_micro`` 2 (each data rank's rows in two), the bf16 weight
    gather (``grad_norm`` within 1e-3, as one device's against repro's)
    and a global batch of 3 that does not split over the data ranks.
    Every rank holds the same; loss within 1e-5 relative (measured at
    most 1.6e-7), ``grad_norm`` 1e-5 (1.4e-5 with the bf16 gather,
    against 1e-3); parameters within 1e-6 after two steps (measured at
    most 1.8e-7; the bf16 gather within ``2 * lr`` a step, 1.8e-5,
    measured 4.3e-6), moments within 1e-5 of their leaf's largest
    (1.8e-6; the bf16 gather 2e-2, measured 8.8e-3: its gradients
    round to bf16 in other places on a model rank's slices)."""
    got, sim, _, _ = run
    one = sim["model"]["extra"][case]
    for r in range(tm.RANKS):
        _eq(got[r]["model"]["extra"][case], got[0]["model"]["extra"][case],
            f"rank {r}")
    mine = got[0]["model"]["extra"][case]
    bf16 = case.endswith("bf16")
    for m, w in zip(mine["metrics"], one["metrics"]):
        assert sorted(m) == sorted(w)
        assert _rel(m["loss"], w["loss"]) < 1e-5
        assert _rel(m["grad_norm"], w["grad_norm"]) < (1e-3 if bf16
                                                       else 1e-5)
        assert _rel(m["lr"], w["lr"]) < 1e-6
        for k in m:
            if "skew" in k or "drop" in k:
                assert m[k] == w[k], k
    moved = 2 * sum(w["lr"] for w in one["metrics"])
    for k, p in one["params"].items():
        assert np.abs(mine["params"][k] - p).max() <= (
            moved if bf16 else 1e-6), k
        for part in ("m", "v"):
            want = one[part][k]
            tol = (2e-2 if bf16 else 1e-5) * np.abs(want).max() + 1e-30
            assert np.abs(mine[part][k] - want).max() <= tol, (k, part)


def test_run_loop_restarts_under_the_mesh(run):
    """``ft.run_loop`` on (2, 2) with a checkpoint a step (written
    through ``StateSpecs``) and a failure at step 2: one restart, the
    state restored onto the mesh, and the same state as the one-device
    loop."""
    got, sim, _, _ = run
    one = sim["model"]["ft"]
    assert one["info"] == {"restarts": 1, "steps": 4} and one["step"] == 4
    for r in range(tm.RANKS):
        mine = got[r]["model"]["ft"]
        assert mine["info"] == one["info"] and mine["step"] == 4
        assert _rel(mine["loss"], one["loss"]) < 1e-5
        for k, p in one["params"].items():
            assert np.abs(mine["params"][k] - p).max() <= 1e-7, k


def _serve_keys():
    return [(name, arch, layout) for name, per in tm.SERVE_CASES.items()
            for arch, layouts in per.items() for layout in layouts]


def _coords(name, r):
    return dict(zip(tm.AXES, divmod(r, tm.MESHES[name][1])))


@pytest.mark.parametrize("name,arch", sorted(
    {(n, a) for n, a, _ in _serve_keys() if a in tm.PREFILL_ARCHS}))
def test_sharded_prefill_matches_repro(run, name, arch):
    """The prefill on each rank of (2, 2) and (1, 4): its block of the
    (B, V) logits, the batch's rows over "data" and the padded
    vocabulary's columns over "model" (the reference's prefill cell's
    output sharding), against repro's one-device prefill within 1e-5
    (float32; sums in other orders and the gathered weights)."""
    got, _, ref, _ = run
    want = ref["serve"][f"{arch}/prefill"]
    d, m = tm.MESHES[name]
    for r in range(tm.RANKS):
        c = _coords(name, r)
        rows = want.shape[0] // d
        cols = want.shape[1] // m
        block = want[c["data"] * rows:(c["data"] + 1) * rows,
                     c["model"] * cols:(c["model"] + 1) * cols]
        mine = got[r]["serve"][f"{arch}/{name}/prefill"]
        assert mine.shape == block.shape
        assert np.abs(mine - block).max() <= 1e-5 * max(
            1.0, np.abs(block).max()), (name, arch, r)


@pytest.mark.parametrize("name,arch,layout", _serve_keys())
def test_sharded_decode_matches_repro(run, name, arch, layout):
    """Teacher-forced decode from a zero cache on each rank, the cache
    laid out by ``cache_specs`` (batch 4 over "data" with the slots over
    "model"; batch 1 with the slots over every rank: the distributed
    flash-decode; ``"hd"``: the head dimension over "model"; a cache
    length that splits no slot axis: the kv heads over "model"; a ring
    that wraps), against repro's one-device ``decode_step`` within 1e-5
    of max(1, |logit|) (float32), every position.  The serve step's
    greedy tokens equal repro's argmax wherever its top two are more
    than 1e-4 apart."""
    got, _, ref, _ = run
    want = ref["serve"][f"{arch}/{layout}"]
    for r in range(tm.RANKS):
        mine = got[r]["serve"][f"{arch}/{name}/{layout}"]
        rows = np.asarray(mine["rows"])
        w = want[rows]
        assert mine["logits"].shape == w.shape
        assert np.abs(mine["logits"] - w).max() <= 1e-5 * max(
            1.0, np.abs(w).max()), (name, arch, layout, r)
        top2 = np.sort(w[:, :tm.GREEDY_STEPS], -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-4
        greedy = w[:, :tm.GREEDY_STEPS].argmax(-1)
        assert clear.any()
        assert (mine["greedy"][clear] == greedy[clear]).all()
    specs = got[0]["serve"][f"{arch}/{name}/{layout}"]["specs"]
    flat = [e for layer in (specs if isinstance(specs, list) else
                            specs["self"]) for sp in layer.values()
            for e in sp]
    assert any(e is not None for e in flat)


def test_recording_mesh_records_what_the_ranks_send(run):
    """The qwen smoke train step on a (2, 2) ``RecordingMesh`` from fake
    tensors makes the collectives, and sends the bytes, that each gloo
    rank's ``mesh.timers`` count for the same step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import api
    got, _, _, _ = run
    cfg = tm.model_cfg("qwen15_4b")
    model, opt = api.build(cfg, "cpu"), adamw.AdamWConfig()
    rec = mesh_lib.RecordingMesh.of((2, 2), tm.AXES)
    with FakeTensorMode():
        state = api.init_train_state(model, torch.Generator(), opt,
                                     mesh=rec)
        batch = {"tokens": torch.empty((4, 16), dtype=torch.int64)}
        step = api.make_train_step(model, opt, mesh=rec)
        rec.reset_timers()
        step(state, batch)
    for r in range(tm.RANKS):
        assert got[r]["serve"]["timers"] == {
            k: rec.timers[k] for k in ("calls", "bytes")}
    assert rec.timers["calls"] == len(rec.ops) > 0
