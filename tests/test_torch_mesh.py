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
ranks (2 ulps: gloo's order of summation is its own)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import pickle
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
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.serve import layout as jlayout
from repro_torch.core import metrics
from repro_torch.core.partition import partition_counts
from repro_torch.dist import compress
from repro_torch.launch import mesh as mesh_lib
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the four ranks once; meanwhile compute the simulation and
    repro's answers here -> ``(ranks, sim, repro, inputs)``."""
    path = str(tmp_path_factory.mktemp("mesh"))
    inp = _inputs()
    np.savez(os.path.join(path, "inputs.npz"), **inp)
    failed = []

    def ranks():
        try:
            mesh_lib.spawn(tm.main, (tm.RANKS, path), tm.RANKS, DEADLINE_S)
        except Exception as e:   # noqa: BLE001 - re-raised below
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    sim = tm.run_cases(None, inp)
    ref = _repro_sharded(inp)
    th.join()
    if failed:
        raise failed[0]
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
