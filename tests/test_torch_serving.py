"""repro_torch's SpatialServer against repro's and the numpy brute
force on the same osm- and pi-like data: range counts, id lists with
overflow flags and the fan-out stats for local_index "x" and "off";
the replicated executors fed a staging carried across from repro; the
device rule and the unported features; and the generators' distribution
against repro's.  Tolerance: exact equality for every answer and stat;
the distribution checks state theirs."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.serve import router as jrouter
from repro_torch.core.partition import api as tapi
from repro_torch.data import spatial_gen as tgen
from repro_torch.query import range as trange
from repro_torch.serve import PlacementPolicy
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve import layout as tlayout

torch.set_num_threads(1)
N, NQ = 3000, 40


def _qboxes(seed, q, scale=0.06):
    rng = np.random.default_rng(seed)
    c = rng.random((q, 2))
    s = rng.random((q, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    return np.array(jgen.dataset(request.param, jax.random.PRNGKey(0), N))


@pytest.fixture(scope="module")
def servers(data):
    out = {}
    for li in ("x", "off"):
        out[li] = (JServer.from_method("bsp", jnp.asarray(data), 120,
                                       JConfig(local_index=li)),
                   TServer.from_method("bsp", data, 120,
                                       TConfig(local_index=li),
                                       device="cpu"))
    return out


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_range_counts_match_repro_and_bruteforce(data, servers, local_index):
    js, ts = servers[local_index]
    qb = _qboxes(1, NQ)
    want, jstats = js.range_counts(jnp.asarray(qb))
    got, tstats = ts.range_counts(qb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [int(c) for c in got] == [
        len(r) for r in trange.range_query_ref(data, qb)]
    assert tstats == jstats          # fanout_mean/max, mode, f_max, skew
    assert ts.stats["t_live"] == js.stats["t_live"]
    assert ts.widths._w == js.widths._w


@pytest.mark.parametrize("max_hits", [4, 64, 4096])
@pytest.mark.parametrize("local_index", ["x", "off"])
def test_range_ids_match_repro_and_bruteforce(data, servers, local_index,
                                              max_hits):
    """Ascending ids, -1 padding, overflow flagged past max_hits (4
    overflows on most queries, 4096 on none)."""
    js, ts = servers[local_index]
    qb = _qboxes(2, NQ)
    want = js.range_ids(jnp.asarray(qb), max_hits=max_hits)
    got = ts.range_ids(qb, max_hits=max_hits)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]
    for row, ref in zip(got[0].numpy(), trange.range_query_ref(data, qb)):
        np.testing.assert_array_equal(row[row >= 0], ref[:max_hits])


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_range_ids_in_small_hit_table_blocks_match_repro(
        data, servers, local_index, monkeypatch):
    """Hit tables built a few queries at a time, trimmed to each block's
    live candidate columns, give repro's answer bit for bit."""
    js, ts = servers[local_index]
    cap = ts.stats["cap"]
    monkeypatch.setattr(trange, "_HIT_TABLE_BYTES", 3 * 2 * cap)
    qb = _qboxes(6, NQ, 0.02)
    want = js.range_ids(jnp.asarray(qb), max_hits=8)
    got = ts.range_ids(qb, max_hits=8)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hit_table_blocks_cover_live_candidates_within_budget(monkeypatch):
    monkeypatch.setattr(trange, "_HIT_TABLE_BYTES", 1000)
    rng = np.random.default_rng(7)
    cand = np.where(rng.random((50, 12)) < 0.3,
                    rng.integers(0, 9, (50, 12)), -1).astype(np.int32)
    cand[5] = -1                                   # a query with no tile
    blocks = trange.hit_table_blocks(torch.from_numpy(cand), cap=40)
    seen = np.zeros(50, bool)
    for rows, w in blocks:
        seen[rows] = True
        assert (cand[rows, w:] < 0).all() and (cand[rows, :w] >= 0).any()
        assert (rows.stop - rows.start) * w * 40 <= 1000 or \
            rows.stop - rows.start == 1
    assert seen[(cand >= 0).any(1)].all()


def test_x_and_off_agree_and_skip_rate_matches(data, servers):
    qb = _qboxes(3, NQ, 0.03)
    answers = []
    for li in ("x", "off"):
        js, ts = servers[li]
        assert ts.chunk_skip_rate(qb) == js.chunk_skip_rate(jnp.asarray(qb))
        assert ts.resident_tile_bytes() == js.resident_tile_bytes()
        answers += [ts.range_counts(qb)[0].numpy(),
                    np.asarray(js.range_counts(jnp.asarray(qb))[0])]
    for a in answers[1:]:
        np.testing.assert_array_equal(a, answers[0])


def test_heat_tracker_follows_repro_through_serving(data, servers):
    js, ts = servers["x"]
    for seed in (10, 11):
        qb = _qboxes(seed, NQ)
        js.range_counts(jnp.asarray(qb))
        ts.range_counts(qb)
    for got, want in zip(ts.heat.snapshot(), js.heat.snapshot()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_executors_on_a_staging_carried_from_repro(data, servers,
                                                   local_index):
    """repro's staged arrays, carried across with staged_from_numpy,
    serve the same answers through the port's executors."""
    js, _ = servers[local_index]
    lay = tlayout.staged_from_numpy(js.layout, "cpu")
    parts = tapi.Partitioning.from_numpy(js.parts.boxes, js.parts.valid,
                                         "cpu")
    tiles = tlayout.ReplicatedTiles(parts, lay, js.stats,
                                    TConfig(local_index=local_index))
    qb = _qboxes(4, NQ)
    cand, _, _ = jrouter.candidate_range(js.probe_boxes, jnp.asarray(qb), 16)
    costs = np.ones(NQ)
    want = js.tiles.range_counts(jnp.asarray(qb), cand, costs)[0]
    got = tiles.range_counts(torch.from_numpy(qb),
                             torch.from_numpy(np.array(cand)), costs)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = js.tiles.range_ids(jnp.asarray(qb), cand, costs, 32)
    got = tiles.range_ids(torch.from_numpy(qb),
                          torch.from_numpy(np.array(cand)), costs, 32)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_default_device_is_cuda_and_never_falls_back(data):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TServer.from_method("bsp", data, 120)
    with pytest.raises(RuntimeError, match="cuda"):
        tgen.osm_like(100)


@pytest.mark.parametrize("make", [
    lambda d: TServer.from_method("bsp", d, 120, TConfig(probe="dense"),
                                  device="cpu"),
    lambda d: TServer.from_method("bsp", d, 120,
                                  TConfig(placement="sharded"), device="cpu"),
    lambda d: TServer.from_method("bsp", d, 120, TConfig(placement="heat"),
                                  device="cpu"),
    lambda d: TServer.from_method("bsp", d, 120,
                                  TConfig(local_index="hilbert"),
                                  device="cpu"),
    lambda d: TServer.from_method(
        "bsp", d, 120, TConfig(policy=PlacementPolicy(rebalance_every=2)),
        device="cpu"),
    lambda d: TServer.from_method("str", d, 120, device="cpu"),
    lambda d: TServer(tapi.partition("bsp", torch.from_numpy(d), 120), d,
                      device="cpu", mesh=object()),
], ids=["dense", "sharded", "heat", "hilbert", "rebalance_every", "str",
        "mesh"])
def test_unported_configurations_raise(data, make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make(data)


@pytest.mark.parametrize("call", [
    lambda s, q: s.range_counts(q, pruned=False),
    lambda s, q: s.range_ids(q, pruned=False),
    lambda s, q: s.knn(q[:, :2], 4), lambda s, q: s.append(q),
    lambda s, q: s.delete([0]), lambda s, q: s.update([0], q[:1]),
    lambda s, q: s.compact(), lambda s, q: s.rebalance(),
], ids=["dense_counts", "dense_ids", "knn", "append", "delete", "update",
        "compact", "rebalance"])
def test_unported_server_methods_raise(servers, call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(servers["x"][1], _qboxes(5, 4))


def _log_half_extent_quantiles(mbrs):
    half = (mbrs[:, 2:] - mbrs[:, :2]).reshape(-1) / 2
    return np.quantile(np.log10(half), [0.1, 0.5, 0.9])


@pytest.mark.parametrize("name", ["osm", "pi"])
def test_generators_follow_repro_distributions(name):
    """Same distributions, not the same bits, at 20k objects.  Half-extent
    log10 quantiles (10/50/90%) agree within 0.05 decades (sampling sd
    about 0.01); centres' means agree within 0.03 (pi: sd 0.002)."""
    n = 20_000
    want = np.asarray(jgen.dataset(name, jax.random.PRNGKey(0), n))
    got = tgen.dataset(name, n, seed=0, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(_log_half_extent_quantiles(got),
                               _log_half_extent_quantiles(want), atol=0.05)
    centre = lambda m: ((m[:, :2] + m[:, 2:]) / 2).clip(0, 1)  # noqa: E731
    if name == "pi":
        np.testing.assert_allclose(centre(got).mean(0), centre(want).mean(0),
                                   atol=0.03)


def test_osm_background_share_matches_repro():
    """5% of osm centres are uniform background.  repro's share is read
    off its own key stream (the draw that decides background); both
    agree with 0.05 within 0.008 (binomial sd at 20k: 0.0015)."""
    n = 20_000
    k6 = jax.random.split(jax.random.PRNGKey(0), 6)[5]
    want = float(np.mean(np.asarray(jax.random.uniform(k6, (n, 3)))[:, 0]
                         < 0.05))
    g = torch.Generator().manual_seed(0)
    _, background = tgen.osm_points(n, g)
    got = float(background.float().mean())
    assert abs(want - 0.05) < 0.008 and abs(got - 0.05) < 0.008
