"""repro_torch's SpatialServer against repro's and the numpy brute
force on the same osm- and pi-like data: range counts, id lists with
overflow flags, kNN (pruned with its widen-and-retry ladder, and the
dense oracle) and every stat for local_index "x" and "off"; the six
Table-1 layouts x local_index "off"/"x"/"hilbert"; the dense
range oracle through ``pruned=False`` and ``probe="dense"``; the
replicated executors fed a staging carried across from repro; the
ingest methods, the replicated rebalance, ``WidthPolicy.reset`` and
explicit staging ids against repro's; the device rule; and the
generators' distribution against repro's.  Tolerance: exact equality
for every answer and stat,
float32 kNN distances bit for bit; the distribution checks state
theirs."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.query import knn as jknn
from repro.serve import router as jrouter
from repro_torch.core.partition import api as tapi
from repro_torch.data import spatial_gen as tgen
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import range as trange
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve import layout as tlayout
from repro_torch.serve import router as trouter
from torch_refs import References

torch.set_num_threads(1)
N, NQ = 3000, 40


def _qboxes(seed, q, scale=0.06):
    rng = np.random.default_rng(seed)
    c = rng.random((q, 2))
    s = rng.random((q, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


DATASETS = ["osm", "pi"]
METHODS = ["fg", "bsp", "slc", "bos", "str", "hc"]
LOCAL_INDEXES = ["off", "x", "hilbert"]


@functools.cache
def _data(name):
    return np.array(jgen.dataset(name, jax.random.PRNGKey(0), N))


def _name(data):
    """The dataset's name of a ``data`` fixture's array."""
    return next(n for n in DATASETS if _data(n) is data)


def _copied(answer):
    """An answer's arrays as numpy, its stats copied."""
    return tuple(copy.deepcopy(a) if isinstance(a, dict) else np.array(a)
                 for a in answer)


@pytest.fixture(scope="module", params=DATASETS)
def data(request):
    return _data(request.param)


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
    monkeypatch.setattr(tops, "_HIT_TABLE_BYTES", 3 * 2 * cap)
    qb = _qboxes(6, NQ, 0.02)
    want = js.range_ids(jnp.asarray(qb), max_hits=8)
    got = ts.range_ids(qb, max_hits=8)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hit_table_blocks_cover_live_candidates_within_budget(monkeypatch):
    monkeypatch.setattr(tops, "_HIT_TABLE_BYTES", 1000)
    rng = np.random.default_rng(7)
    cand = np.where(rng.random((50, 12)) < 0.3,
                    rng.integers(0, 9, (50, 12)), -1).astype(np.int32)
    cand[5] = -1                                   # a query with no tile
    blocks = tops.hit_table_blocks(torch.from_numpy(cand), cap=40)
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


N_LAYOUTS = 2500     # objects per dataset in the six-layout parity test


@functools.cache
def _layout_data(name):
    return np.array(jgen.dataset(name, jax.random.PRNGKey(3), N_LAYOUTS))


@pytest.fixture(scope="module", params=DATASETS)
def layout_data(request):
    return request.param, _layout_data(request.param)


def _six_reference(dataset, method, local_index):
    """repro's side of ``test_six_layouts_and_local_indexes_match_repro``:
    the staged slots and stats, then the range counts, range ids and
    kNN answers."""
    data = _layout_data(dataset)
    js = JServer.from_method(method, jnp.asarray(data), 120,
                             JConfig(local_index=local_index))
    out = dict(layout={n: np.array(getattr(js.layout, n)) for n in (
        "ids", "canon_tiles", "probe_boxes", "alive")},
        stats=copy.deepcopy(js.stats))
    qb = jnp.asarray(_qboxes(30, NQ))
    out["counts"] = _copied(js.range_counts(qb))
    out["ids"] = _copied(js.range_ids(qb, max_hits=16))
    out["knn"] = _copied(js.knn(jnp.asarray(_pts(31, 24)), 5))
    return out


@pytest.mark.parametrize("local_index", LOCAL_INDEXES)
@pytest.mark.parametrize("method", METHODS)
def test_six_layouts_and_local_indexes_match_repro(layout_data, method,
                                                   local_index):
    """Every Table-1 layout partitioned by each package itself, staged
    with every local index: the staged slots, range counts, range ids
    (with overflow) and kNN answer bit for bit as repro's, stats
    included."""
    dataset, data = layout_data
    ref = REFS["six", dataset, method, local_index]
    ts = TServer.from_method(method, data, 120,
                             TConfig(local_index=local_index), device="cpu")
    for name in ("ids", "canon_tiles", "probe_boxes", "alive"):
        np.testing.assert_array_equal(getattr(ts.layout, name).numpy(),
                                      ref["layout"][name])
    assert ts.stats == ref["stats"]
    qb = _qboxes(30, NQ)
    want, got = ref["counts"], ts.range_counts(qb)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert got[1] == want[1]
    want = ref["ids"]
    got = ts.range_ids(qb, max_hits=16)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3] == want[3]
    _assert_knn_equal(ts.knn(_pts(31, 24), 5), ref["knn"])


@pytest.mark.parametrize("make", [
    lambda d: TServer.from_method("bsp", d, 120),
    lambda d: tgen.osm_like(100),
    lambda d: trouter.HeatTracker(8),
], ids=["server", "generator", "heat_tracker"])
def test_default_device_is_cuda_and_never_falls_back(data, make):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        make(data)


N_FRESH = 1000       # objects of the servers the ingest cases mutate


def _fresh_servers(data, **cfg):
    """A repro and a port server of their own (the module's ``servers``
    are shared and must not be mutated), on repro's partitioning."""
    mbrs = data[:N_FRESH]
    js = JServer.from_method("bsp", jnp.asarray(mbrs), 120, JConfig(**cfg))
    parts = tapi.Partitioning.from_numpy(js.parts.boxes, js.parts.valid,
                                         "cpu")
    return js, TServer(parts, mbrs, TConfig(**cfg), device="cpu",
                       method="bsp")


INGEST_CALLS = {
    "append": lambda s, q: s.append(q),
    "delete": lambda s, q: s.delete(np.array([0, 17, 300])),
    "update": lambda s, q: s.update(np.array([5, 6]), q[:2]),
    "compact": lambda s, q: s.compact(),
}
LAYOUT_FIELDS = ("ids", "canon_tiles", "probe_boxes", "chunk_boxes",
                 "alive", "uni")


def _ingest_reference(dataset, call):
    """repro's side of ``test_ingest_methods_match_repro_on_a_fresh_server``:
    its partitioning, and its report, stats, staging and cap after
    ``call``."""
    js = JServer.from_method("bsp", jnp.asarray(_data(dataset)[:N_FRESH]),
                             120, JConfig(slack=64))
    parts = (np.asarray(js.parts.boxes), np.asarray(js.parts.valid))
    rep = INGEST_CALLS[call](js, jnp.asarray(_qboxes(5, 4) * 0.5))
    return dict(parts=parts, report=copy.deepcopy(rep),
                stats=copy.deepcopy(js.stats), cap=js.widths.cap,
                layout={n: np.array(getattr(js.layout, n))
                        for n in LAYOUT_FIELDS})


@pytest.mark.parametrize("call", list(INGEST_CALLS))
def test_ingest_methods_match_repro_on_a_fresh_server(data, call):
    """append, delete, update and compact run under the replicated
    placement: the same report (but the bytes each uploads), stats and
    staging as repro's."""
    ref = REFS["ingest", _name(data), call]
    parts = tapi.Partitioning.from_numpy(*ref["parts"], "cpu")
    ts = TServer(parts, data[:N_FRESH], TConfig(slack=64), device="cpu",
                 method="bsp")
    want, got = dict(ref["report"]), INGEST_CALLS[call](
        ts, _qboxes(5, 4) * 0.5)
    want.pop("bytes_transferred"), got.pop("bytes_transferred")
    assert got == want and ts.stats == ref["stats"]
    for name in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(ts.layout, name).numpy(),
                                      ref["layout"][name], err_msg=name)
    assert ts.widths.cap == ref["cap"]


def test_replicated_rebalance_is_repros_noop_report(data):
    """Under the replicated placement rebalance reports no move, as
    repro's does, and leaves the answers and the heat as they were."""
    js, ts = _fresh_servers(data)
    qb = _qboxes(12, NQ)
    js.range_counts(jnp.asarray(qb))
    before = ts.range_counts(qb)[0]
    assert ts.rebalance() == js.rebalance() == dict(
        placement="replicated", moved_tiles=0, replicated_tiles=0,
        bytes_transferred=0)
    js.range_counts(jnp.asarray(qb))
    assert torch.equal(ts.range_counts(qb)[0], before)
    for got, want in zip(ts.heat.snapshot(), js.heat.snapshot()):
        np.testing.assert_array_equal(got, want)


def test_width_policy_reset_matches_repro():
    from repro.serve.engine import WidthPolicy as JWidths
    from repro_torch.serve import WidthPolicy as TWidths
    policies = (JWidths(cap=40), TWidths(cap=40))
    for w in policies:
        w.observe("range", 16)
        w.observe(("knn", 4, 64), 72)          # clamped to the cap
        w.at_least("range", 8)
        w.reset()
        w.start(("knn", 4, 64), 12)
        w.observe("range", 24)
    jw, tw = policies
    assert tw._w == jw._w == {"range": 24}
    assert (tw.hits, tw.misses) == (jw.hits, jw.misses)


@pytest.mark.parametrize("local_index", ["x", "hilbert", "off"])
def test_stage_tiles_with_explicit_ids_matches_repro(data, local_index):
    """Explicit object ids (a re-stage's surviving ids, with holes)
    replace 0..N-1 before the canonical mark: the same staging and stats
    as repro's."""
    from repro.serve import stage_tiles as jstage
    mbrs = data[:N_FRESH]
    ids = np.sort(np.random.default_rng(13).choice(
        10 * N_FRESH, N_FRESH, replace=False)).astype(np.int32)
    jparts = japi.partition("bsp", jnp.asarray(mbrs), 120)
    cfg = dict(local_index=local_index, slack=32)
    jlay, jstats = jstage(jparts, jnp.asarray(mbrs), JConfig(**cfg),
                          ids=jnp.asarray(ids))
    tparts = tapi.Partitioning.from_numpy(jparts.boxes, jparts.valid, "cpu")
    tlay, tstats = tlayout.stage_tiles(tparts, torch.from_numpy(mbrs),
                                       TConfig(**cfg),
                                       ids=torch.from_numpy(ids))
    assert tstats == jstats
    for name in ("ids", "tiles", "canon_tiles", "probe_boxes",
                 "chunk_boxes", "alive", "uni"):
        want = getattr(jlay, name)
        if want is None:
            assert getattr(tlay, name) is None
            continue
        np.testing.assert_array_equal(getattr(tlay, name).numpy(),
                                      np.asarray(want), err_msg=name)
    assert set(tlay.ids[tlay.alive].tolist()) == set(ids.tolist())


def _pts(seed, q=NQ):
    return np.random.default_rng(seed).random((q, 2)).astype(np.float32)


def _assert_knn_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3] == want[3]


@pytest.mark.parametrize("pruned", [None, False])
@pytest.mark.parametrize("local_index", ["x", "off"])
def test_knn_matches_repro_and_bruteforce(data, servers, local_index,
                                          pruned):
    """Pruned (the ladder, its f_max, retries and rounds) and dense:
    ids, d2 and overflow bit for bit, every stat and the width cache.
    Unflagged answers equal the numpy brute force's ids."""
    js, ts = servers[local_index]
    for k, seed in [(4, 20), (10, 21), (4, 22)]:
        pts = _pts(seed)
        want = js.knn(jnp.asarray(pts), k, pruned=pruned)
        got = ts.knn(pts, k, pruned=pruned)
        _assert_knn_equal(got, want)
        ref_ids, _ = jknn.knn_ref(data, pts, k)
        ok = ~got[2].numpy()
        np.testing.assert_array_equal(got[0].numpy()[ok], ref_ids[ok])
    assert ts.widths._w == js.widths._w
    assert (ts.widths.hits, ts.widths.misses) == (js.widths.hits,
                                                  js.widths.misses)


@pytest.mark.parametrize("pruned", [None, False])
def test_knn_overflow_keeps_repro_candidates(data, servers, pruned):
    """max_cand 6 < the refinement box's hits: the truncated candidate
    sets, and so the flagged answers, are repro's."""
    js, ts = servers["x"]
    pts = _pts(23)
    want = js.knn(jnp.asarray(pts), 3, max_cand=6, pruned=pruned)
    got = ts.knn(pts, 3, max_cand=6, pruned=pruned)
    _assert_knn_equal(got, want)
    assert got[2].any()


def _widening_reference(dataset):
    """repro's side of ``test_knn_widening_ladder_and_heat_match_repro``:
    a cold server's answers to two batches, then its heat."""
    js = JServer.from_method("bsp", jnp.asarray(_data(dataset)), 60)
    answers = [_copied(js.knn(jnp.asarray(_pts(seed)), 8))
               for seed in (24, 25)]
    return answers, [np.array(a) for a in js.heat.snapshot()]


def test_knn_widening_ladder_and_heat_match_repro(data):
    """A cold server per package: the first batch climbs the ladder from
    the density start, later batches start at the cached width; the heat
    tracker sees each converged frontier."""
    answers, heat = REFS["widening", _name(data)]
    ts = TServer.from_method("bsp", data, 60, device="cpu")
    retries = []
    for seed, want in zip((24, 25), answers):
        _assert_knn_equal(ts.knn(_pts(seed), 8), want)
        retries.append(want[3]["retries"])
    assert retries[0] > 0 and retries[1] == 0
    for got, want in zip(ts.heat.snapshot(), heat):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_dense_range_oracle_matches_repro(data, servers, local_index):
    """pruned=False on a pruned server, and a server built with
    probe="dense", answer as repro's dense oracle, stats included."""
    js, ts = servers[local_index]
    dense = TServer.from_method("bsp", data, 120,
                                TConfig(local_index=local_index,
                                        probe="dense"), device="cpu")
    qb = _qboxes(26, NQ)
    want = js.range_counts(jnp.asarray(qb), pruned=False)
    for got in (ts.range_counts(qb, pruned=False), dense.range_counts(qb)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1] == want[1] and got[1]["mode"] == "dense"
    want = js.range_ids(jnp.asarray(qb), max_hits=8, pruned=False)
    for got in (ts.range_ids(qb, max_hits=8, pruned=False),
                dense.range_ids(qb, max_hits=8)):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == want[3]
    got = dense.knn(_pts(27), 4)
    _assert_knn_equal(got, js.knn(jnp.asarray(_pts(27)), 4, pruned=False))
    assert dense.widths._w == {}


def test_dense_executors_in_small_blocks_match_repro(data, servers,
                                                     monkeypatch):
    """Dense id and kNN hit tables built two queries at a time."""
    js, ts = servers["off"]
    monkeypatch.setattr(tops, "_HIT_TABLE_BYTES",
                        2 * ts.layout.ids.numel())
    qb = _qboxes(28, NQ)
    want = js.range_ids(jnp.asarray(qb), max_hits=16, pruned=False)
    got = ts.range_ids(qb, max_hits=16, pruned=False)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts = _pts(29)
    _assert_knn_equal(ts.knn(pts, 5, pruned=False),
                      js.knn(jnp.asarray(pts), 5, pruned=False))


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


REFS = References({
    **{key: job for d in DATASETS for key, job in [
        *((("ingest", d, c), functools.partial(_ingest_reference, d, c))
          for c in INGEST_CALLS),
        (("widening", d), functools.partial(_widening_reference, d))]},
    **{("six", d, m, li): functools.partial(_six_reference, d, m, li)
       for d in DATASETS for m in METHODS for li in LOCAL_INDEXES},
})
