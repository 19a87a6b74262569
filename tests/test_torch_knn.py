"""repro_torch's kNN pieces against repro's, on the same numpy inputs:
the distance functions, kNN routing, the initial radius and its
correctly rounded float32 square root (``sqrt32``), and the three
executors (dense ``batched_knn``, routed ``pruned_knn`` and its
refinement ``knn_partial``) over stagings carried across from repro,
with and without chunk boxes and alive masks, and with ``max_cand``
small enough that queries overflow.  Tolerance: exact equality for
every output, float32 ``d2`` and radii bit for bit."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.query import knn as jknn
from repro.serve import router as jrouter, stage_tiles as jstage
from repro.serve import ServeConfig as JConfig
from repro_torch.core.fma import sqrt32
from repro_torch.core.partition import api as tapi
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve import router as trouter
from repro_torch.serve.layout import staged_from_numpy

torch.set_num_threads(1)
N, NQ, K = 2500, 30, 5


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == getattr(torch, str(want.dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def _pts(seed, q=NQ):
    return np.random.default_rng(seed).random((q, 2)).astype(np.float32)


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    return np.array(jgen.dataset(request.param, jax.random.PRNGKey(0), N))


@pytest.fixture(scope="module")
def staged(data):
    """repro's stagings (bsp and the overlapping hc layout), indexed and
    not, each carried across to the port."""
    out = {}
    for method in ("bsp", "hc"):
        parts = japi.partition(method, jnp.asarray(data), 150)
        for li in ("x", "off"):
            lay, stats = jstage(parts, jnp.asarray(data),
                                JConfig(local_index=li))
            out[method, li] = (parts, lay, stats,
                               staged_from_numpy(lay, "cpu"))
    return out


def _alive(lay, kind, seed=3):
    if kind is None:
        return None, None
    a = np.asarray(lay.alive) & (
        np.random.default_rng(seed).random(lay.alive.shape) < 0.8)
    return jnp.asarray(a), torch.from_numpy(a)


def _boxes(rng, n, scale):
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


def test_mindist2_rounds_as_repro_eager_and_jitted():
    """Eager repro rounds dx*dx + dy*dy as three ops; under jit XLA
    contracts it to fma(dx, dx, dy*dy).  Point-in-box, far and
    sub-ulp distances included."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.random((300, 2)),
                          rng.random((20, 2)) * 1e-3]).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 400, 0.01),
                            _boxes(rng, 40, 1e-4) * 1e-3]).astype(np.float32)
    jp, jb = jnp.asarray(pts), jnp.asarray(boxes)
    tp, tb = torch.from_numpy(pts), torch.from_numpy(boxes)
    _eq(tknn.mindist2(tp, tb), jknn.mindist2(jp, jb))
    _eq(tknn.mindist2_fused(tp, tb), jax.jit(jknn.mindist2)(jp, jb))


def test_linf_dist_and_candidate_knn_match_repro_with_ties():
    """Duplicated boxes, points inside boxes (distance 0) and sentinel
    boxes: the frontier's order, distances and excluded distance."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 30, 0.2)
    boxes = np.concatenate([boxes, boxes[:10], np.broadcast_to(
        np.float32([9e9, 9e9, -9e9, -9e9]), (5, 4))]).astype(np.float32)
    pts = np.concatenate([rng.random((20, 2)),
                          boxes[:5, :2] + 0.001]).astype(np.float32)
    jp, jb = jnp.asarray(pts), jnp.asarray(boxes)
    tp, tb = torch.from_numpy(pts), torch.from_numpy(boxes)
    _eq(trouter.linf_dist(tp, tb), jrouter.linf_dist(jp, jb))
    for f in (1, 8, 40, 45, 60):
        for got, want in zip(trouter.candidate_knn(tb, tp, f),
                             jrouter.candidate_knn(jb, jp, f)):
            _eq(got, want)


def test_route_knn_matches_repro(data, staged):
    parts = staged["bsp", "x"][0]
    tp = tapi.Partitioning.from_numpy(parts.boxes, parts.valid, "cpu")
    pts = _pts(8)
    for got, want in zip(trouter.route_knn(tp, torch.from_numpy(pts)),
                         jrouter.route_knn(parts, jnp.asarray(pts))):
        _eq(got, want)


def test_sqrt32_is_correctly_rounded():
    """``sqrt32`` against numpy's correctly rounded float32 root, bit for
    bit: 2**20 seeded values (half uniform in [0, 1), half random bit
    patterns over every finite positive float32, subnormals included),
    0-d tensors, and the special values."""
    rng = np.random.default_rng(0)
    half = 1 << 19
    x = np.concatenate([
        rng.random(half, dtype=np.float32),
        rng.integers(0, 0x7F800000, half, dtype=np.uint32).view(np.float32)])
    got = sqrt32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.sqrt(x).view(np.uint32))
    for v in x[:64]:
        assert sqrt32(torch.tensor(v)).numpy().view(np.uint32) == \
            np.sqrt(v).view(np.uint32)
    special = np.float32([0.0, -0.0, np.inf, np.nan, -1.0, -np.inf])
    with np.errstate(invalid="ignore"):
        want = np.sqrt(special)
    np.testing.assert_array_equal(sqrt32(torch.from_numpy(special)).numpy(),
                                  want)


@pytest.mark.parametrize("n", [0, 1, 7, 2500, 8_000_000, 123_456_789])
def test_initial_radius_matches_repro(n):
    uni = np.float32([0.013, -0.2, 1.07, 0.9])
    jdiag = jnp.sqrt(jnp.sum((jnp.asarray(uni)[2:] - jnp.asarray(uni)[:2])
                             ** 2))
    tdiag = torch.sqrt(torch.sum((torch.from_numpy(uni)[2:]
                                  - torch.from_numpy(uni)[:2]) ** 2))
    _eq(tdiag, jdiag)
    for k in (1, 3, 10, 64):
        _eq(tknn.initial_radius(tdiag, k, n),
            jknn.initial_radius(jdiag, k, jnp.int32(n)))


def test_knn_ref_matches_repro(data):
    pts = _pts(9)
    for got, want in zip(tknn.knn_ref(data, pts, K),
                         jknn.knn_ref(data, pts, K)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_cand", [1024, 8])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_batched_knn_matches_repro(data, staged, method, alive, max_cand):
    """The dense oracle; max_cand 8 overflows most queries, so the kept
    candidates must be the reference's first 8 in (tile, slot) order."""
    _, jl, stats, tl = staged[method, "off"]
    ja, ta = _alive(jl, alive)
    pts = _pts(10)
    want = jknn.batched_knn(jnp.asarray(pts), K, jl.canon_tiles, jl.ids,
                            jl.uni, max_cand=max_cand, n_live=stats["n"],
                            alive=ja)
    got = tknn.batched_knn(torch.from_numpy(pts), K, tl.canon_tiles, tl.ids,
                           tl.uni, max_cand=max_cand, n_live=stats["n"],
                           alive=ta)
    for g, w in zip(got, want):
        _eq(g, w)
    if max_cand == 8:
        assert got[3].any()


@pytest.mark.parametrize("r0,max_rounds", [(None, 32), (1e-4, 32),
                                           (1e-4, 2)])
def test_batched_knn_deepening_options_match_repro(data, staged, r0,
                                                   max_rounds):
    """A fixed first radius, the padded-slot density (n_live None), and
    a round cap that stops the deepening early."""
    _, jl, _, tl = staged["bsp", "x"]
    pts = _pts(11)
    want = jknn.batched_knn(jnp.asarray(pts), K, jl.canon_tiles, jl.ids,
                            jl.uni, r0=r0, max_rounds=max_rounds)
    got = tknn.batched_knn(torch.from_numpy(pts), K, tl.canon_tiles, tl.ids,
                           tl.uni, r0=r0, max_rounds=max_rounds)
    for g, w in zip(got, want):
        _eq(g, w)


def _frontier(jl, pts, f):
    cand, _, excl = jrouter.candidate_knn(jl.probe_boxes, jnp.asarray(pts), f)
    return (cand, excl), (torch.from_numpy(np.array(cand)),
                          torch.from_numpy(np.array(excl)))


@pytest.mark.parametrize("max_cand", [1024, 8])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("li", ["x", "off"])
@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_pruned_knn_matches_repro(data, staged, method, li, alive, max_cand):
    """Frontier of 4 tiles: some queries reach an excluded tile, and an
    all -1 candidate row starts at the covering radius."""
    _, jl, stats, tl = staged[method, li]
    ja, ta = _alive(jl, alive)
    pts = _pts(12)
    (jc, je), (tc, te) = _frontier(jl, pts, 4)
    jc, tc = jc.at[3].set(-1), tc.clone()
    tc[3] = -1
    want = jknn.pruned_knn(jnp.asarray(pts), K, jl.canon_tiles, jl.ids,
                           jl.uni, jc, je, max_cand=max_cand,
                           n_live=stats["n"], chunk_boxes=jl.chunk_boxes,
                           alive=ja)
    got = tknn.pruned_knn(torch.from_numpy(pts), K, tl.canon_tiles, tl.ids,
                          tl.uni, tc, te, max_cand=max_cand,
                          n_live=stats["n"], chunk_boxes=tl.chunk_boxes,
                          alive=ta)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[3].any()


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("li", ["x", "off"])
def test_knn_partial_matches_repro(data, staged, li, blocked, monkeypatch):
    """The refinement over a frontier, its gathered hit table built in
    one block or a few queries at a time."""
    _, jl, _, tl = staged["bsp", li]
    ja, ta = _alive(jl, "random")
    if blocked:
        monkeypatch.setattr(tops, "_HIT_TABLE_BYTES",
                            3 * 2 * tl.ids.shape[1])
    pts = _pts(13)
    (jc, _), (tc, _) = _frontier(jl, pts, 6)
    re = np.random.default_rng(4).random(NQ).astype(np.float32) * 0.08
    for mc in (1024, 6):
        want = jknn.knn_partial(jnp.asarray(pts), jl.canon_tiles, jl.ids, jc,
                                jnp.asarray(re), K, max_cand=mc,
                                chunk_boxes=jl.chunk_boxes, alive=ja)
        got = tknn.knn_partial(torch.from_numpy(pts), tl.canon_tiles, tl.ids,
                               tc, torch.from_numpy(re), K, max_cand=mc,
                               chunk_boxes=tl.chunk_boxes, alive=ta)
        for g, w in zip(got, want):
            _eq(g, w)


def test_blocked_dense_knn_equals_unblocked(data, staged, monkeypatch):
    _, jl, stats, tl = staged["bsp", "off"]
    pts = torch.from_numpy(_pts(14))
    args = (pts, K, tl.canon_tiles, tl.ids, tl.uni)
    want = tknn.batched_knn(*args, max_cand=16, n_live=stats["n"])
    monkeypatch.setattr(trange, "_HIT_TABLE_BYTES",
                        2 * tl.ids.numel() + 1)
    assert len(trange.dense_blocks(NQ, tl.ids.numel())) == NQ // 2
    got = tknn.batched_knn(*args, max_cand=16, n_live=stats["n"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_knn_fanout_matches_repro(data, staged):
    parts = staged["bsp", "x"][0]
    pts = _pts(15)
    kth = np.random.default_rng(5).random(NQ).astype(np.float32) * 0.01
    want = jknn.knn_fanout(jnp.asarray(pts), jnp.asarray(kth), parts.boxes,
                           parts.valid)
    got = tknn.knn_fanout(torch.from_numpy(pts), torch.from_numpy(kth),
                          torch.from_numpy(np.array(parts.boxes)),
                          torch.from_numpy(np.array(parts.valid)))
    _eq(got, want)


def test_knn_tie_break_by_id():
    """Coincident objects (repro's tests/test_range_knn.py case): the k
    reported neighbours are the lowest ids, through both executors."""
    mbrs = jnp.broadcast_to(jnp.array([0.5, 0.5, 0.6, 0.6]), (8, 4))
    parts = japi.partition("fg", mbrs, 4)
    jl, _ = jstage(parts, mbrs)
    tl = staged_from_numpy(jl, "cpu")
    pts = np.float32([[0.1, 0.1]])
    want = jknn.batched_knn(jnp.asarray(pts), 3, jl.canon_tiles, jl.ids,
                            jl.uni)
    got = tknn.batched_knn(torch.from_numpy(pts), 3, tl.canon_tiles, tl.ids,
                           tl.uni)
    np.testing.assert_array_equal(got[0].numpy()[0], [0, 1, 2])
    for g, w in zip(got, want):
        _eq(g, w)
    (jc, je), (tc, te) = _frontier(jl, pts, 2)
    got = tknn.pruned_knn(torch.from_numpy(pts), 3, tl.canon_tiles, tl.ids,
                          tl.uni, tc, te)
    np.testing.assert_array_equal(got[0].numpy()[0], [0, 1, 2])
