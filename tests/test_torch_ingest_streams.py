"""repro_torch's ingest lifecycle on the CPU, held against a numpy
brute force of the live object set and against a fresh port staging of
that set, without running repro: the replicated cases of repro's
``test_ingest_streams.py`` (the fixed command stream on all six layouts
x osm and pi, automatic compaction, the restage threshold, hypothesis
interleavings) and of its ``test_streaming.py`` (append equal to
re-staging, overflow re-stages, staging invariants, incremental boxes,
id numbering, capacity headroom, the empty append).  The sharded and
mesh cases wait for the sharded placement.

After every command every test asserts that the live extent covers
every alive slot (``extent >= live_extent(alive)``), and after
``compact`` and every re-stage that it is tight: on the CPU the plain
versions ignore the extent, so this is the only CPU guard against a
stale one.  Tolerance: exact equality for every count, id list and kNN
id, ``d2`` bit for bit against the fresh staging (within 1e-6 relative
against the numpy brute force, which sums in another order)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.core.partition import api
from repro_torch.data import spatial_gen
from repro_torch.kernels.range_probe import ops
from repro_torch.query import knn as knn_mod
from repro_torch.query import range as range_mod
from repro_torch.serve import ServeConfig, SpatialServer

torch.set_num_threads(1)
LAYOUTS = ["hc", "str", "fg", "bsp", "slc", "bos"]
N_BASE, PAYLOAD, K = 400, 64, 3
MAX_HITS = 4096


# -- the extent invariant ---------------------------------------------------

def _assert_extent(srv, tight: bool = False) -> None:
    """No alive slot lies at or past its tile's (or shard row's)
    extent; ``tight``: the extent is exactly 1 + each row's last alive
    slot."""
    if srv.slayout is None:
        want = ops.live_extent(srv.layout.alive)
    else:
        alive = srv.slayout.alive_shards
        want = ops.live_extent(alive.flatten(0, 1)).view(alive.shape[:2])
    ext = srv.tiles.extent
    assert ext.dtype == torch.int32 and ext.shape == want.shape
    assert bool((ext >= want).all()), "an alive slot lies past the extent"
    if tight:
        assert torch.equal(ext, want)


# -- the numpy oracle -------------------------------------------------------

class LiveSet:
    """Brute-force model: the set of live (id, box) pairs."""

    def __init__(self, mbrs):
        mbrs = np.asarray(mbrs, np.float32)
        self.boxes = {i: mbrs[i] for i in range(len(mbrs))}
        self.n_total = len(mbrs)

    def append(self, mbrs):
        for b in np.asarray(mbrs, np.float32):
            self.boxes[self.n_total] = b
            self.n_total += 1

    def delete(self, ids):
        for i in ids:
            del self.boxes[int(i)]

    def update(self, ids, mbrs):
        for i, b in zip(ids, np.asarray(mbrs, np.float32)):
            self.boxes[int(i)] = b

    def live(self):
        """-> (ids ascending (m,) int64, boxes (m, 4) f32)."""
        ids = np.array(sorted(self.boxes), np.int64)
        return ids, np.stack([self.boxes[int(i)] for i in ids])


# -- the command interpreter ------------------------------------------------

def _boxes(rng, m, scale=0.01):
    lo = rng.uniform(0.0, 1.0, (m, 2)).astype(np.float32)
    ex = rng.uniform(0.0, scale, (m, 2)).astype(np.float32)
    return np.concatenate([lo, lo + ex], axis=1)


def _qboxes(rng, q, scale=0.08):
    c = rng.uniform(0.0, 1.0, (q, 2)).astype(np.float32)
    s = rng.uniform(0.0, scale, (q, 2)).astype(np.float32)
    return np.concatenate([c - s, c + s], axis=1)


def _pick_live(model, rng, count):
    ids, _ = model.live()
    count = min(count, max(ids.size - 60, 0))   # keep the live set big
    return rng.choice(ids, size=count, replace=False) if count else \
        np.zeros(0, np.int64)


def _burst(srv):
    """cap + 1 coincident objects at the centre of tile 0's region: an
    overflow is certain."""
    tb = srv.parts.boxes[0].numpy()
    ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
    return np.tile(np.asarray(ctr + ctr, np.float32),
                   (srv.stats["cap"] + 1, 1))


def _apply(srv, model, op, rng):
    """Run one command on both implementations, then hold the extent."""
    kind = op[0]
    rep = {}
    if kind == "append":
        nb = _boxes(rng, op[1])
        rep = srv.append(nb)
        model.append(nb)
    elif kind == "delete":
        ids = _pick_live(model, rng, max(1, int(op[1] * len(model.boxes))))
        if ids.size:
            rep = srv.delete(ids)
            model.delete(ids)
    elif kind == "update":
        ids = _pick_live(model, rng, op[1])
        if ids.size:
            nb = _boxes(rng, ids.size)
            rep = srv.update(ids, nb)
            model.update(ids, nb)
    elif kind == "compact":
        rep = srv.compact()
        assert rep["dead_frac"] == 0.0
    elif kind == "burst":
        nb = _burst(srv)
        rep = srv.append(nb)
        assert rep["restaged"]
        model.append(nb)
    elif kind == "check":
        _check(srv, model, rng)
    else:                                              # pragma: no cover
        raise ValueError(op)
    _assert_extent(srv, tight=kind == "compact" or bool(rep.get("restaged")))


def _check(srv, model, rng, nq=10, npts=6):
    """Server answers == brute force on the live set, ids remapped
    through the ascending live ids (the remap keeps sort and tie
    order)."""
    ids_live, lb = model.live()
    assert srv.stats["n"] == ids_live.size
    qb = _qboxes(rng, nq)
    ref = range_mod.range_query_ref(lb, qb)
    counts, _ = srv.range_counts(qb)
    assert counts.tolist() == [len(r) for r in ref]
    hid, _, ovf, _ = srv.range_ids(qb, max_hits=MAX_HITS)
    assert not ovf.any()
    want = np.full((nq, MAX_HITS), -1, np.int32)
    for i, r in enumerate(ref):
        v = np.sort(ids_live[r]).astype(np.int32)
        want[i, :v.size] = v
    np.testing.assert_array_equal(hid.numpy(), want)
    pts = rng.uniform(0.0, 1.0, (npts, 2)).astype(np.float32)
    nn, d2, ovk, _ = srv.knn(pts, K, max_cand=MAX_HITS)
    assert not ovk.any()
    want_nn, want_d2 = knn_mod.knn_ref(lb, pts, K)
    want_nn = np.where(want_nn >= 0,
                       ids_live[np.clip(want_nn, 0, None)], -1)
    np.testing.assert_array_equal(nn.numpy(), want_nn)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-6, atol=1e-9)


def _check_vs_fresh_staging(srv, model, cfg, rng, nq=10, npts=6):
    """Answers equal a fresh staging of the live set (same
    partitioning and config, its ids remapped), and the dense oracle."""
    ids_live, lb = model.live()
    fresh = SpatialServer(srv.parts, lb, cfg, device="cpu")
    qb = _qboxes(rng, nq)
    got, _ = srv.range_counts(qb)
    assert torch.equal(got, fresh.range_counts(qb)[0])
    assert torch.equal(got, srv.range_counts(qb, pruned=False)[0])
    hid = srv.range_ids(qb, max_hits=MAX_HITS)[0].numpy()
    fhid = fresh.range_ids(qb, max_hits=MAX_HITS)[0].numpy()
    fhid = np.where(fhid >= 0, ids_live[np.clip(fhid, 0, None)], -1)
    np.testing.assert_array_equal(hid, fhid)
    pts = rng.uniform(0.0, 1.0, (npts, 2)).astype(np.float32)
    nn, d2, _, _ = srv.knn(pts, K, max_cand=MAX_HITS)
    fnn, fd2, _, _ = fresh.knn(pts, K, max_cand=MAX_HITS)
    fnn = np.where(fnn.numpy() >= 0, ids_live[np.clip(fnn.numpy(), 0, None)],
                   -1)
    np.testing.assert_array_equal(nn.numpy(), fnn)
    np.testing.assert_array_equal(d2.numpy(), fd2.numpy())


def _run_stream(method, dataset, commands, seed, *, compact_dead_frac=0.5,
                restage_dead_frac=None, local_index="x",
                placement="replicated"):
    rng = np.random.default_rng(seed)
    full = spatial_gen.dataset(dataset, N_BASE, seed=seed, device="cpu")
    parts = api.partition(method, full, PAYLOAD)
    cfg = ServeConfig(placement=placement,
                      shards=None if placement == "replicated" else 4,
                      slack=256, compact_dead_frac=compact_dead_frac,
                      restage_dead_frac=restage_dead_frac,
                      local_index=local_index)
    srv = SpatialServer(parts, full, cfg, device="cpu")
    _assert_extent(srv, tight=True)
    model = LiveSet(full.numpy())
    for op in commands:
        _apply(srv, model, op, rng)
    _check(srv, model, rng)
    _check_vs_fresh_staging(srv, model, cfg, rng)
    return srv


# -- the fixed corpus -------------------------------------------------------

FIXED_STREAM = [
    ("append", 80), ("delete", 0.10), ("check",),
    ("update", 25), ("append", 60), ("delete", 0.25),
    ("compact",), ("check",),
    ("burst",), ("delete", 0.15), ("update", 10),
]


@pytest.mark.parametrize("dataset", ["osm", "pi"])
@pytest.mark.parametrize("method", LAYOUTS)
def test_fixed_stream_differential(method, dataset):
    srv = _run_stream(method, dataset, FIXED_STREAM, seed=7)
    assert srv.stats["restages"] == 1          # the burst re-staged
    assert srv.stats["compactions"] >= 1       # the forced compact ran


def test_auto_compaction_stream():
    """The thresholds fire on their own under heavy churn, and answers
    stay exact without an explicit ``compact``."""
    stream = [("append", 60), ("delete", 0.4), ("check",),
              ("delete", 0.3), ("update", 20), ("check",)]
    srv = _run_stream("bsp", "osm", stream, seed=11, compact_dead_frac=0.25)
    assert srv.stats["compactions"] >= 1


def test_restage_threshold_stream():
    """``restage_dead_frac`` escalates churn to a full re-stage (the
    reference runs this stream sharded; here replicated)."""
    stream = [("delete", 0.35), ("check",), ("delete", 0.3), ("check",)]
    srv = _run_stream("str", "osm", stream, seed=13,
                      compact_dead_frac=None, restage_dead_frac=0.3)
    assert srv.stats["restages"] >= 1


_op = st.one_of(
    st.tuples(st.just("append"), st.integers(1, 60)),
    st.tuples(st.just("delete"), st.floats(0.05, 0.35)),
    st.tuples(st.just("update"), st.integers(1, 30)),
    st.tuples(st.just("compact")),
    st.tuples(st.just("check")),
)


@settings(max_examples=30, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(commands=st.lists(_op, min_size=3, max_size=8),
       seed=st.integers(0, 2 ** 16), method=st.sampled_from(LAYOUTS),
       local_index=st.sampled_from(["x", "hilbert", "off"]))
def test_generated_stream_differential(commands, seed, method, local_index):
    _run_stream(method, "osm", commands, seed, compact_dead_frac=0.4,
                local_index=local_index)


# -- test_streaming.py's replicated cases -----------------------------------

N, N_SPLIT, NQ, KS = 1500, 1000, 20, 4


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    full = spatial_gen.dataset(request.param, N, seed=0, device="cpu")
    return full, full.numpy()


def _queries(seed):
    rng = np.random.default_rng(seed)
    return _qboxes(rng, NQ, 0.06), rng.random((NQ, 2)).astype(np.float32)


def _assert_same_answers(srv, osrv, mbrs_np, qb, pts):
    """``srv`` (ingested) and ``osrv`` (staged from scratch on the whole
    data) answer bit for bit alike and as the brute force."""
    ref = range_mod.range_query_ref(mbrs_np, qb)
    counts, _ = srv.range_counts(qb)
    assert torch.equal(counts, osrv.range_counts(qb)[0])
    assert counts.tolist() == [len(r) for r in ref]
    hid, _, ovf, _ = srv.range_ids(qb, max_hits=2048)
    ohid, _, oovf, _ = osrv.range_ids(qb, max_hits=2048)
    assert not ovf.any() and not oovf.any()
    assert torch.equal(hid, ohid)
    # max_cand covers the coincident bursts a refinement box may hold
    nn, d2, ovk, _ = srv.knn(pts, KS, max_cand=4096)
    onn, od2, oovk, _ = osrv.knn(pts, KS, max_cand=4096)
    assert not ovk.any() and torch.equal(ovk, oovk)
    assert torch.equal(nn, onn) and torch.equal(d2, od2)
    want_ids, _ = knn_mod.knn_ref(mbrs_np, pts, KS)
    np.testing.assert_array_equal(nn.numpy(), want_ids)
    dn, _, _, _ = srv.knn(pts, KS, max_cand=4096, pruned=False)
    assert torch.equal(nn, dn)


@pytest.mark.parametrize("method", LAYOUTS)
def test_append_bit_identical_to_restage(data, method):
    """Slack appends (no overflow) answer as a fresh staging of the
    whole dataset."""
    full, mbrs_np = data
    base, extra = full[:N_SPLIT], full[N_SPLIT:]
    parts = api.partition(method, base, 120)
    cfg = ServeConfig(slack=600)
    srv = SpatialServer(parts, base, cfg, device="cpu")
    for i in range(0, N - N_SPLIT, 125):
        assert not srv.append(extra[i:i + 125])["restaged"]
        _assert_extent(srv)
    assert srv.stats["n"] == N
    osrv = SpatialServer(parts, full, cfg, device="cpu")
    _assert_same_answers(srv, osrv, mbrs_np, *_queries(1))


@pytest.mark.parametrize("method", ["bsp", "hc", "fg"])
def test_overflow_restage_bit_identical(data, method):
    """A forced tile overflow re-stages at a grown capacity, resets the
    width cache, and answers stay those of a fresh staging."""
    full, _ = data
    base, extra = full[:N_SPLIT], full[N_SPLIT:]
    parts = api.partition(method, base, 120)
    srv = SpatialServer(parts, base, device="cpu")           # slack 0
    qb, pts = _queries(3)
    srv.range_counts(qb)                                     # warm the cache
    assert srv.widths._w
    cap = srv.stats["cap"]
    burst = _burst(srv)
    rep = srv.append(burst)
    assert rep["restaged"] and srv.stats["restages"] == 1
    assert srv.stats["cap"] > cap
    assert not srv.widths._w                                 # reset
    _assert_extent(srv, tight=True)
    srv.append(extra)                                        # keep growing
    _assert_extent(srv)
    every = np.concatenate([base.numpy(), burst, extra.numpy()])
    osrv = SpatialServer(parts, every, device="cpu")
    _assert_same_answers(srv, osrv, every, qb, pts)


@pytest.mark.parametrize("method", ["bsp", "str"])
def test_restage_preserves_staging_invariants(data, method):
    """After an overflow re-stage: one canonical slot an object, chunk
    boxes bound their chunks' canonical members, probe boxes bound
    every canonical member."""
    full, _ = data
    base = full[:N_SPLIT]
    parts = api.partition(method, base, 120)
    srv = SpatialServer(parts, base, device="cpu")
    srv.append(_burst(srv))
    assert srv.stats["restages"] == 1
    _assert_extent(srv, tight=True)
    lay = srv.layout
    ct, ids = lay.canon_tiles.numpy(), lay.ids.numpy()
    canon = ct[..., 0] < 1e9
    n = srv.stats["n"]
    np.testing.assert_array_equal(
        np.bincount(ids[canon].ravel(), minlength=n), np.ones(n))
    _assert_boxes_bound(lay, canon)
    cb = lay.chunk_boxes.numpy()
    for t in range(ct.shape[0]):                 # empty chunks are sentinel
        for c in range(cb.shape[1]):
            if not canon[t, c * ops.CHUNK:(c + 1) * ops.CHUNK].any():
                assert cb[t, c, 0] > cb[t, c, 2]


def _assert_boxes_bound(lay, live):
    ct, cb, pb = (lay.canon_tiles.numpy(), lay.chunk_boxes.numpy(),
                  lay.probe_boxes.numpy())
    for t in range(ct.shape[0]):
        if live[t].any():
            mine = ct[t][live[t]]
            assert np.all(pb[t, :2] <= mine[:, :2].min(0))
            assert np.all(pb[t, 2:] >= mine[:, 2:].max(0))
        for c in range(cb.shape[1]):
            sl = slice(c * ops.CHUNK, (c + 1) * ops.CHUNK)
            boxes = ct[t, sl][live[t, sl]]
            if boxes.size:
                assert np.all(cb[t, c, :2] <= boxes[:, :2].min(0))
                assert np.all(cb[t, c, 2:] >= boxes[:, 2:].max(0))


def test_incremental_boxes_bound_after_append(data):
    """Slack appends refresh probe and chunk boxes in place: both still
    bound every canonical member they summarise."""
    full, _ = data
    base, extra = full[:N_SPLIT], full[N_SPLIT:]
    parts = api.partition("bsp", base, 120)
    srv = SpatialServer(parts, base, ServeConfig(slack=600), device="cpu")
    assert not srv.append(extra)["restaged"]
    _assert_extent(srv)
    _assert_boxes_bound(srv.layout, srv.layout.canon_tiles.numpy()[..., 0]
                        < 1e9)


def test_append_ids_continue_numbering(data):
    full, _ = data
    base, extra = full[:N_SPLIT], full[N_SPLIT:]
    parts = api.partition("fg", base, 120)
    srv = SpatialServer(parts, base, ServeConfig(slack=600), device="cpu")
    srv.append(extra[:100])
    _assert_extent(srv)
    assert int(srv.layout.ids.max()) == N_SPLIT + 99
    # a query box equal to an appended object's MBR finds its id
    hid, _, _, _ = srv.range_ids(extra[7:8].numpy(), max_hits=2048)
    assert (N_SPLIT + 7) in set(hid[0].tolist())


def test_restage_preserves_capacity_headroom(data):
    """An explicit capacity's headroom over the hottest tile is the
    user's slack: a re-stage re-reserves at least that much."""
    full, _ = data
    base = full[:N_SPLIT]
    parts = api.partition("bsp", base, 120)
    srv = SpatialServer(parts, base, ServeConfig(capacity=1024),
                        device="cpu")
    empty = np.zeros((0, 4), np.float32)
    headroom = srv.append(empty)["free_slots_min"]
    tb = srv.parts.boxes[0].numpy()
    ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
    assert srv.append(np.tile(np.asarray(ctr + ctr, np.float32),
                              (1025, 1)))["restaged"]
    _assert_extent(srv, tight=True)
    assert srv.append(empty)["free_slots_min"] >= headroom - 127


def test_empty_append_is_a_noop(data):
    full, _ = data
    parts = api.partition("bsp", full, 120)
    srv = SpatialServer(parts, full, device="cpu")
    before = dict(srv.stats)
    ext = srv.tiles.extent.clone()
    rep = srv.append(np.zeros((0, 4), np.float32))
    assert rep["appended"] == 0 and not rep["restaged"]
    assert rep["bytes_transferred"] == 0
    assert srv.stats == before and torch.equal(srv.tiles.extent, ext)
