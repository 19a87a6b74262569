"""repro_torch's spatial join against repro's on the same numpy inputs:
the ``mbr_join`` ops (repro's Pallas kernels in interpret mode) on
``tests/test_kernels_mbr.py``'s shapes; ``rp_own_mask``,
``tile_join_count`` and ``tile_join_pairs`` (truncation included) on
repro's planned tiles; ``unique_pairs``; the LPT packers;
``plan_join``'s arrays and stats for the six layouts on 1 and 4
devices; and the engine's counts on a 1-device mesh, at the sizes of
``tests/test_join_engine.py`` and on a denser box set.  Hit tables in
row blocks give the same answers, and the ETL command runs on the CPU
(the mesh mode: tests/test_torch_mesh.py).  repro's engine side runs
ahead, every case's in threads (``torch_refs``).  Tolerance: exact
equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.kernels  # noqa: F401  (wires repro's Hilbert kernel into hc)
from repro.data import spatial_gen as jgen
from repro.kernels.mbr_join import kernel as jmk, ops as jmops
from repro.kernels.mbr_join import ref as jmref
from repro.query import balance as jbalance, dedup as jdedup
from repro.query import engine as jengine, join as jjoin
from repro_torch.kernels.mbr_join import kernel as tmk, ops as tmops
from repro_torch.kernels.mbr_join import ref as tmref
from repro_torch.launch import partition_etl
from repro_torch.query import balance as tbalance, dedup as tdedup
from repro_torch.query import engine as tengine, join as tjoin
from torch_refs import References

torch.set_num_threads(1)
METHODS = ["fg", "bsp", "slc", "bos", "str", "hc"]


def _boxes(n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("d",))


# -- mbr_join kernels ------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (7, 5), (128, 128), (300, 257),
                                 (1024, 513)])
def test_join_count_matches_repro(n, m):
    r, s = _boxes(n, n), _boxes(m, m + 1)
    want = int(jmops.join_count(jnp.asarray(r), jnp.asarray(s)))
    assert int(tmops.join_count(_t(r), _t(s))) == want
    assert want == int(jmref.intersect_count(jnp.asarray(r), jnp.asarray(s)))
    assert int(tmref.intersect_count(_t(r), _t(s))) == want


@pytest.mark.parametrize("n,m", [(5, 9), (130, 260), (511, 140)])
def test_join_mask_matches_repro(n, m):
    r, s = _boxes(n, n), _boxes(m, m)
    got = tmops.join_mask(_t(r), _t(s))
    assert got.shape == (n, m) and got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmops.join_mask(jnp.asarray(r),
                                                jnp.asarray(s))))


@pytest.mark.parametrize("br,bs", [(128, 128), (256, 128), (512, 256)])
def test_block_counts_match_repro_block_by_block(br, bs):
    """The count kernel's (N/br, M/bs) output against repro's Pallas
    kernel on the same sentinel-padded component-major inputs."""
    r, s = _boxes(700, 0), _boxes(300, 1)
    r4, s4 = tmops.pad_cm(_t(r), br), tmops.pad_cm(_t(s), bs)
    want = jmk.count_pallas(jnp.asarray(r4.numpy()), jnp.asarray(s4.numpy()),
                            br, bs, interpret=True)
    got = tmops.count_blocks(r4, s4, br, bs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tmops.join_count(_t(r), _t(s), br=br, bs=bs)) == int(
        jmops.join_count(jnp.asarray(r), jnp.asarray(s), br=br, bs=bs))


def test_padded_mask_matches_repro_kernel():
    r4 = tmops.pad_cm(_t(_boxes(3, 4)), 256)
    s4 = tmops.pad_cm(_t(_boxes(2, 5)), 128)
    want = jmk.mask_pallas(jnp.asarray(r4.numpy()), jnp.asarray(s4.numpy()),
                           interpret=True)
    np.testing.assert_array_equal(tmops.mask_cm(r4, s4).numpy(),
                                  np.asarray(want))


def test_bfloat16_inputs_are_cast_to_float32():
    r = _boxes(256, 2)
    s = _boxes(256, 3)
    jr = jnp.asarray(r).astype(jnp.bfloat16)
    js = jnp.asarray(s).astype(jnp.bfloat16)
    tr = torch.from_numpy(np.array(jr.astype(jnp.float32))).bfloat16()
    ts = torch.from_numpy(np.array(js.astype(jnp.float32))).bfloat16()
    assert int(tmops.join_count(tr, ts)) == int(jmops.join_count(jr, js))


def test_touching_boxes_intersect_and_sentinels_never_match():
    r = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    s = torch.tensor([[1.0, 1.0, 2.0, 2.0]])     # one shared corner
    assert int(tmops.join_count(r, s)) == 1
    r3, s2 = _boxes(3, 4), _boxes(2, 5)           # heavy padding to 256
    assert int(tmops.join_count(_t(r3), _t(s2))) == int(
        jmref.intersect_count(jnp.asarray(r3), jnp.asarray(s2)))
    assert int(tmops.join_count(torch.tensor([[9e9, 9e9, -9e9, -9e9]]),
                                torch.tensor([[-1e9, -1e9, 1e9, 1e9]]))) == 0


def test_kernel_wrappers_need_cuda_tensors():
    x = tmops.pad_cm(_t(_boxes(4, 0)), 128)
    for call in (lambda: tmk.count(x, x, 128, 128), lambda: tmk.mask(x, x)):
        with pytest.raises(ValueError, match="cuda"):
            call()


# -- tile joins ------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_plan():
    """repro's plan of a dense join (many pairs per tile)."""
    r, s = _boxes(600, 10, 0.04), _boxes(500, 11, 0.04)
    return r, s, jengine.plan_join("bsp", jnp.asarray(r), jnp.asarray(s),
                                   150, 1)


def _tile(plan, j):
    return [plan.r_tiles[0, j], plan.s_tiles[0, j], plan.r_ids[0, j],
            plan.s_ids[0, j], plan.tile_boxes[0, j]]


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_rp_own_mask_and_tile_counts_match_repro(dense_plan, j):
    _, _, plan = dense_plan
    rt, st, _, _, tb = _tile(plan, j)
    uni = plan.universe
    args = [jnp.asarray(a) for a in (rt, st, tb, uni)]
    targs = [_t(a) for a in (rt, st, tb, uni)]
    np.testing.assert_array_equal(tjoin.rp_own_mask(*targs).numpy(),
                                  np.asarray(jjoin.rp_own_mask(*args)))
    for dedup in ("rp", "none"):
        want = int(jjoin.tile_join_count(*args, dedup=dedup))
        assert int(tjoin.tile_join_count(*targs, dedup=dedup)) == want
    assert want > 0


@pytest.mark.parametrize("max_pairs", [1, 37, 100_000])
@pytest.mark.parametrize("dedup", ["none", "rp"])
def test_tile_join_pairs_match_repro(dense_plan, dedup, max_pairs):
    """Row-major pairs padded with -1, truncated at max_pairs, and n
    counting every hit."""
    _, _, plan = dense_plan
    rt, st, rid, sid, tb = _tile(plan, 0)
    want = jjoin.tile_join_pairs(
        *(jnp.asarray(a) for a in (rt, st, rid, sid, tb, plan.universe)),
        max_pairs, dedup=dedup)
    got = tjoin.tile_join_pairs(
        *(_t(a) for a in (rt, st, rid, sid, tb, plan.universe)),
        max_pairs, dedup=dedup)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(want[2]) > 37


def test_tile_joins_in_row_blocks_match_repro(dense_plan, monkeypatch):
    """Hit tables built a few rows at a time: same counts, same pairs,
    same truncation point."""
    _, _, plan = dense_plan
    rt, st, rid, sid, tb = _tile(plan, 1)
    jargs = [jnp.asarray(a) for a in (rt, st, rid, sid, tb, plan.universe)]
    targs = [_t(a) for a in (rt, st, rid, sid, tb, plan.universe)]
    monkeypatch.setattr(tjoin, "TABLE_BYTES", 5 * st.shape[0])
    assert int(tjoin.tile_join_count(targs[0], targs[1], targs[4], targs[5])
               ) == int(jjoin.tile_join_count(jargs[0], jargs[1], jargs[4],
                                              jargs[5]))
    for max_pairs in (13, 10_000):
        want = jjoin.tile_join_pairs(*jargs, max_pairs)
        got = tjoin.tile_join_pairs(*targs, max_pairs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unique_pairs_match_repro():
    rng = np.random.default_rng(0)
    rid = rng.integers(0, 50, 500).astype(np.int32)
    sid = rng.integers(0, 50, 500).astype(np.int32)
    pad = rng.random(500) < 0.2
    rid[pad], sid[pad] = -1, -1
    want_n, want_u = jdedup.unique_pairs(jnp.asarray(rid), jnp.asarray(sid))
    got_n, got_u = tdedup.unique_pairs(_t(rid), _t(sid))
    assert int(got_n) == int(want_n) == len(set(zip(rid[~pad], sid[~pad])))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(
        tdedup.lexsort_pairs(_t(rid), _t(sid)).numpy(),
        np.asarray(jdedup.lexsort_pairs(jnp.asarray(rid), jnp.asarray(sid))))


@pytest.mark.parametrize("n_devices", [1, 4, 16])
def test_packers_match_repro(n_devices):
    rng = np.random.default_rng(n_devices)
    costs = rng.pareto(1.3, 300) + 1.0
    costs[::7] = costs[0]                       # ties
    for name in ("lpt_pack", "round_robin_pack"):
        want = getattr(jbalance, name)(costs, n_devices)
        got = getattr(tbalance, name)(costs, n_devices)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    np.testing.assert_array_equal(
        tbalance.tile_costs(np.arange(5), np.arange(5) + 1),
        jbalance.tile_costs(np.arange(5), np.arange(5) + 1))


# -- the engine ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rs():
    r = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), 1200))
    s = np.array(jgen.dataset("osm", jax.random.PRNGKey(9), 900))
    return r, s


@pytest.fixture(scope="module")
def rs():
    return _rs()


_PLAN_ARRAYS = ("r_tiles", "r_ids", "s_tiles", "s_ids", "tile_boxes",
                "universe")


@functools.lru_cache(maxsize=None)
def _tplan(method, n_devices):
    """The port's plan of ``_rs()``, made once a module."""
    r, s = _rs()
    return tengine.plan_join(method, r, s, 200, n_devices, device="cpu")


def _dense_rs():
    return _boxes(700, 20, 0.03), _boxes(600, 21, 0.03)


def _engine_reference(method):
    """repro's side of the engine cases for ``method``: its plans of
    ``_rs()`` on 1 and 4 devices (arrays and stats), the 1-device
    plan's counts, and the dense join's counts."""
    r, s = _rs()
    out = {"plans": {}}
    for n in (1, 4):
        plan = jengine.plan_join(method, jnp.asarray(r), jnp.asarray(s), 200,
                                 n)
        out["plans"][n] = ({k: np.asarray(getattr(plan, k))
                            for k in _PLAN_ARRAYS}, copy.deepcopy(plan.stats))
        if n == 1:
            out["counts"] = dict(
                join=jengine.spatial_join_count(plan, _mesh(), "d",
                                                max_pairs_per_tile=8192),
                **{d: jengine.run_join_count(plan, _mesh(), "d", dedup=d)
                   for d in ("rp", "none")},
                masj=jengine.run_join_pairs_masj(plan, _mesh(), "d",
                                                 max_pairs_per_tile=8192))
    r, s = _dense_rs()
    plan = jengine.plan_join(method, jnp.asarray(r), jnp.asarray(s), 150, 1)
    out["dense"] = dict(
        none=jengine.run_join_count(plan, _mesh(), "d", dedup="none"),
        masj16=jengine.run_join_pairs_masj(plan, _mesh(), "d",
                                           max_pairs_per_tile=16))
    return out


def _oracles():
    return {name: int(jmref.intersect_count(jnp.asarray(r), jnp.asarray(s)))
            for name, (r, s) in (("rs", _rs()), ("dense", _dense_rs()))}


REFS = References({**{("engine", m): functools.partial(_engine_reference, m)
                      for m in METHODS}, "oracles": _oracles})


@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("method", METHODS)
def test_plan_join_matches_repro(method, n_devices):
    arrays, stats = REFS["engine", method]["plans"][n_devices]
    got = _tplan(method, n_devices)
    for name in _PLAN_ARRAYS:
        w = arrays[name]
        g = getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.stats == stats
    np.testing.assert_array_equal(got.live_r, (got.r_ids >= 0).sum(-1))


@pytest.mark.parametrize("method", METHODS)
def test_join_counts_match_repro(method):
    want, got = REFS["engine", method]["counts"], _tplan(method, 1)
    oracle = REFS["oracles"]["rs"]
    assert tengine.spatial_join_count(got, max_pairs_per_tile=8192) == \
        want["join"] == oracle
    for dedup in ("rp", "none"):
        assert tengine.run_join_count(got, dedup=dedup) == want[dedup]
    assert tengine.run_join_pairs_masj(got, max_pairs_per_tile=8192) == \
        want["masj"]


@pytest.mark.parametrize("method", METHODS)
def test_dense_join_counts_and_truncation_match_repro(method):
    """Many pairs per tile: exact counts, and the MASJ path truncated
    at 16 pairs a tile drops what repro drops."""
    r, s = _dense_rs()
    want = REFS["engine", method]["dense"]
    got = tengine.plan_join(method, r, s, 150, 1, device="cpu")
    oracle = REFS["oracles"]["dense"]
    assert tengine.spatial_join_count(got, max_pairs_per_tile=100_000) == \
        oracle
    assert tengine.run_join_count(got, dedup="none") == \
        want["none"] >= oracle
    stats = {}
    short = tengine.run_join_pairs_masj(got, max_pairs_per_tile=16,
                                        stats=stats)
    assert short == want["masj16"]
    assert stats["truncated_tiles"] > 0 and short < oracle
    per_tile = tengine.tile_counts(got, dedup="none")
    assert stats["max_tile_pairs"] == int(per_tile.max())


def test_plan_join_defaults_to_cuda(rs):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.plan_join("bsp", *rs, 200, 1)


@pytest.mark.parametrize("method", ["bos", "hc"])
def test_etl_partitions_and_joins_on_the_cpu(method, capsys):
    assert partition_etl.main(["--device", "cpu", "--n", "3000", "--method",
                               method, "--payload", "300", "--join"]) == 0
    out = capsys.readouterr().out
    assert f"method={method} n=3000" in out and "coverage          = 1.0000" \
        in out and "join: |R⋈S| =" in out
    assert partition_etl.main(["--device", "cpu", "--n", "3000", "--method",
                               method, "--payload", "300", "--parallel"]) == 0
    assert "parallel partition stats: {'dropped': 0" in \
        capsys.readouterr().out
