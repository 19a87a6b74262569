"""repro_torch's sharded placement against repro's with ``mesh=None``
(the exchange simulated on one device) and the numpy brute force, at
``tests/test_sharded_serving.py``'s sizes (N = 1200, NQ = 24, K = 4,
4 shards) on osm- and pi-like data and all six layouts, repro's data
and ``Partitioning`` carried across: range counts, id lists (with
overflow) and kNN (ids, ``d2`` bit for bit, flags) of the port's
``"x"``, ``"hilbert"`` and ``"off"`` servers equal repro's ``"x"``
server's, and every stat (the packing, ``m_per_pair``, ``f_local``,
``messages``, ``probe_rows``, ``exchange_bytes``, kNN rounds); the
owner and local maps, ``t_local``, the shard arrays and the staging
stats equal repro's (5 shards show the padding rows: sentinel, id -1,
dead, extent 0); the dense oracle of a sharded server; the widen and
retry ladder; and the owner-folded launch of every move against a
loop over the owners on the CPU's plain versions.  The mesh mode:
tests/test_torch_mesh.py.
Tolerance: exact equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.query import knn as jknn
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro_torch.core.partition import api as tapi
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve import exchange as texchange
from repro_torch.serve import layout as tlayout
from torch_refs import THREADS

torch.set_num_threads(1)
LAYOUTS = ["hc", "str", "fg", "bsp", "slc", "bos"]
N, NQ, K, SHARDS, PAYLOAD = 1200, 24, 4, 4, 120
SHARD_FIELDS = ("canon_shards", "id_shards", "alive_shards", "chunk_shards",
                "probe_boxes", "chunk_boxes", "uni")


def _qboxes(seed, q, scale=0.06):
    rng = np.random.default_rng(seed)
    c = rng.random((q, 2))
    s = rng.random((q, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


def _pts(seed, q):
    return np.random.default_rng(seed).random((q, 2)).astype(np.float32)


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    return np.array(jgen.dataset(request.param, jax.random.PRNGKey(0), N))


def _port(data, method, jparts, shards=SHARDS, local_index="x"):
    """The port's sharded server on repro's partitioning."""
    tparts = tapi.Partitioning.from_numpy(jparts.boxes, jparts.valid, "cpu")
    return TServer(tparts, data, TConfig(placement="sharded", shards=shards,
                                         local_index=local_index),
                   device="cpu", method=method)


def _pair(data, method, shards=SHARDS, local_index="x", parts=None):
    """repro's sharded server and the port's on repro's partitioning."""
    jparts = parts or japi.partition(method, jnp.asarray(data), PAYLOAD)
    cfg = dict(placement="sharded", shards=shards, local_index=local_index)
    return (JServer(jparts, jnp.asarray(data), JConfig(**cfg), method=method),
            _port(data, method, jparts, shards, local_index))


@pytest.fixture(scope="module")
def servers(data):
    """Per layout: repro's "x" server and the port's three stagings
    (repro's "x" answers stand for its other two, which its own tests
    hold equal).  repro's servers are built in threads (``torch_refs``),
    the port's as each arrives."""
    def jserver(m):
        parts = japi.partition(m, jnp.asarray(data), PAYLOAD)
        cfg = JConfig(placement="sharded", shards=SHARDS, local_index="x")
        return JServer(parts, jnp.asarray(data), cfg, method=m)

    out = {}
    with ThreadPoolExecutor(THREADS) as pool:      # repro's, ahead
        for m, js in zip(LAYOUTS, pool.map(jserver, LAYOUTS)):
            out[m] = (js, {li: _port(data, m, js.parts, local_index=li)
                           for li in ("x", "hilbert", "off")})
    return out


def _assert_shards(ts, js):
    s, w = ts.slayout, js.slayout
    np.testing.assert_array_equal(s.owner, w.owner)
    np.testing.assert_array_equal(s.local, w.local)
    for name in SHARD_FIELDS:
        got, want = getattr(s, name), getattr(w, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    assert ts.stats == js.stats
    assert ts.resident_tile_bytes() == js.resident_tile_bytes()
    ext = ts.tiles.extent
    assert torch.equal(ext, tops.live_extent(
        s.alive_shards.flatten(0, 1)).view(ext.shape))


@pytest.mark.parametrize("method", LAYOUTS)
def test_sharded_range_matches_repro(data, servers, method):
    js, ts = servers[method]
    qb = _qboxes(1, NQ)
    ref = trange.range_query_ref(data, qb)
    want, wstats = js.range_counts(jnp.asarray(qb))
    assert [int(c) for c in np.asarray(want)] == [len(r) for r in ref]
    for li, srv in ts.items():
        got, stats = srv.range_counts(qb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats == wstats and stats["mode"] == "sharded", li
    for max_hits in (8, 2048):
        want = js.range_ids(jnp.asarray(qb), max_hits=max_hits)
        for li, srv in ts.items():
            got = srv.range_ids(qb, max_hits=max_hits)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert got[3] == want[3], li
    for row, r in zip(got[0].numpy(), ref):
        np.testing.assert_array_equal(row[row >= 0], r)


@pytest.mark.parametrize("method", LAYOUTS)
def test_sharded_knn_matches_repro(data, servers, method):
    js, ts = servers[method]
    pts = _pts(2, NQ)
    want = js.knn(jnp.asarray(pts), K)
    ref_ids, _ = jknn.knn_ref(data, pts, K)
    np.testing.assert_array_equal(np.asarray(want[0]), ref_ids)
    for li, srv in ts.items():
        got = srv.knn(pts, K)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == want[3], li           # rounds, retries, exchange


@pytest.mark.parametrize("method", LAYOUTS)
def test_shards_maps_and_stats_match_repro(servers, method):
    js, ts = servers[method]
    _assert_shards(ts["x"], js)
    assert ts["x"].stats["t_local"] == -(-js.stats["t"] // SHARDS)
    assert ts["x"].shards == SHARDS and ts["x"].n_devices == 1
    assert ts["x"].layout is None and js.layout is None
    # the unsharded staging behind the shards: scatter-back inverts
    for got, want in zip(ts["x"]._oracle_np, js._oracle_np):
        np.testing.assert_array_equal(got, want)
    s = ts["x"].slayout
    np.testing.assert_array_equal(
        s.canon_shards.numpy()[s.owner, s.local], js._oracle_np[0])


@pytest.mark.parametrize("local_index", ["hilbert", "off"])
def test_unindexed_and_hilbert_shards_match_repro(data, local_index):
    js, ts = _pair(data, "bsp", local_index=local_index)
    _assert_shards(ts, js)


def test_five_shards_show_padding_rows(data):
    """T not divisible by 5: the padding rows past an owner's tiles are
    sentinel boxes, id -1, dead and extent 0, as repro's, and every
    owner holds at most ceil(T/D) tiles."""
    padded = 0
    for m in LAYOUTS:
        js, ts = _pair(data, m, shards=5)
        _assert_shards(ts, js)
        s = ts.slayout
        used = np.zeros(s.id_shards.shape[:2], bool)
        used[s.owner, s.local] = True
        if used.all():
            continue
        padded += 1
        pad = torch.from_numpy(~used)
        assert (s.canon_shards[pad] == torch.tensor(
            [9e9, 9e9, -9e9, -9e9])).all()
        assert (s.id_shards[pad] == -1).all()
        assert not s.alive_shards[pad].any()
        assert (ts.tiles.extent[pad] == 0).all()
        assert s.id_shards.shape[1] == -(-ts.stats["t"] // 5)
    assert padded


@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_dense_oracle_of_a_sharded_server_matches_repro(data, servers,
                                                        method):
    js, ts = servers[method]
    qb, pts = _qboxes(3, NQ), _pts(4, NQ)
    for li, srv in ts.items():
        want = js.range_counts(jnp.asarray(qb), pruned=False)
        got = srv.range_counts(qb, pruned=False)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1] == want[1] and got[1]["mode"] == "dense"
        want = js.range_ids(jnp.asarray(qb), max_hits=64, pruned=False)
        got = srv.range_ids(qb, max_hits=64, pruned=False)
        for g, w in zip(got, want):
            g = g if isinstance(g, dict) else g.numpy()
            np.testing.assert_array_equal(g, w if isinstance(w, dict)
                                          else np.asarray(w))
        want = js.knn(jnp.asarray(pts), K, pruned=False)
        got = srv.knn(pts, K, pruned=False)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == want[3], li


def test_sharded_knn_widen_retry_matches_repro(data, caplog):
    """A seeded narrow frontier is widened exactly once (logged once),
    as repro's, with the same answers."""
    jparts = japi.partition("bsp", jnp.asarray(data), 80)
    tparts = tapi.Partitioning.from_numpy(jparts.boxes, jparts.valid, "cpu")
    cfg = dict(placement="sharded", shards=3)
    js = JServer(jparts, jnp.asarray(data), JConfig(**cfg))
    ts = TServer(tparts, data, TConfig(**cfg), device="cpu")
    t_live, k = ts.stats["t_live"], N
    seed = t_live // 2 + 1
    js.widths._w[("knn", k, 2048)] = seed
    ts.widths._w[("knn", k, 2048)] = seed
    pts = _pts(5, 4)
    want = js.knn(jnp.asarray(pts), k, max_cand=2048)
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.engine"):
        got = ts.knn(pts, k, max_cand=2048)
    assert got[3]["retries"] == 1 and got[3] == want[3]
    assert sum("widening" in r.message for r in caplog.records
               if r.name == "repro_torch.serve.engine") == 1
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the owner-folded launch against a loop over owners ------------------------

def _owner_loop(srv, qr, cr, fn):
    """``fn(q, tiles, ids, cand, cboxes, alive, extent)`` owner by owner
    on each owner's own shard: the reference's per-device map."""
    s = srv.slayout
    ext = srv.tiles.extent
    out = []
    for o in range(srv.shards):
        out.append(fn(qr[o].reshape((-1,) + qr.shape[3:]), s.canon_shards[o],
                      s.id_shards[o], cr[o].reshape(-1, cr.shape[-1]),
                      None if s.chunk_shards is None else s.chunk_shards[o],
                      s.alive_shards[o], ext[o]))
    return out


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_folded_launch_equals_a_loop_over_owners(data, servers, local_index):
    """Every move of the exchange over the flat (D·T_rows) shards, with
    owner o's local candidate c at row o·T_rows + c, equals probing each
    owner's shard on its own: counts, id lists and kNN refinements."""
    srv = servers["bsp"][1][local_index]
    comm = texchange._Comm(None)
    sh = srv.tiles._shards()
    qb = _qboxes(6, NQ)
    cand, costs, _ = srv._route_batch(torch.from_numpy(qb))
    slots, ss, sc, _ = srv.tiles._exchange_plan(cand, costs)
    d, m = ss.shape[0], ss.shape[-1]
    qp = tlayout._pack_rows(torch.from_numpy(qb), slots, tlayout._SENTINEL)
    qr = comm.exchange(texchange._gather_send(
        qp, ss, torch.from_numpy(tlayout._SENTINEL)))
    cr = comm.exchange(sc)
    flat_c = comm.fold(cr, sh.t_rows)
    # counts
    folded = trange.pruned_range_counts(qr.reshape(-1, 4), sh.tiles, flat_c,
                                        chunk_boxes=sh.cboxes, alive=sh.alive,
                                        extent=sh.extent)
    loop = _owner_loop(srv, qr, cr, lambda q, t, i, c, cb, al, ex:
                       trange.pruned_range_counts(q, t, c, chunk_boxes=cb,
                                                  alive=al, extent=ex))
    assert torch.equal(folded, torch.cat(loop))
    # id lists
    folded = trange.pruned_range_ids(qr.reshape(-1, 4), sh.tiles, sh.ids,
                                     flat_c, 16, chunk_boxes=sh.cboxes,
                                     alive=sh.alive, extent=sh.extent)
    loop = _owner_loop(srv, qr, cr, lambda q, t, i, c, cb, al, ex:
                       trange.pruned_range_ids(q, t, i, c, 16, chunk_boxes=cb,
                                               alive=al, extent=ex))
    for j in range(3):
        assert torch.equal(folded[j], torch.cat([x[j] for x in loop]))
    # kNN refinement at each message's own radius
    pts = (qr[..., :2] + qr[..., 2:]) * 0.5
    re = (torch.arange(d * d * m, dtype=torch.float32) % 7) * 0.01
    folded = tknn.knn_partial(pts.reshape(-1, 2), sh.tiles, sh.ids, flat_c,
                              re, K, chunk_boxes=sh.cboxes, alive=sh.alive,
                              extent=sh.extent)
    re_o = re.view(d, -1)
    loop = [tknn.knn_partial(pts[o].reshape(-1, 2), srv.slayout.canon_shards[o],
                             srv.slayout.id_shards[o],
                             cr[o].reshape(-1, cr.shape[-1]), re_o[o], K,
                             chunk_boxes=None if sh.cboxes is None
                             else srv.slayout.chunk_shards[o],
                             alive=srv.slayout.alive_shards[o],
                             extent=srv.tiles.extent[o])
            for o in range(d)]
    for j in range(3):
        assert torch.equal(folded[j], torch.cat([x[j] for x in loop]))
    # and the whole counts move through the orchestration
    got = texchange.serve_range_counts(comm, qp, ss, sc, sh)
    assert torch.equal(got.reshape(-1)[torch.from_numpy(slots.ravel() >= 0)],
                       srv.range_counts(qb)[0][torch.from_numpy(
                           slots.ravel()[slots.ravel() >= 0]).long()])
