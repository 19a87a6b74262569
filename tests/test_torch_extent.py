"""The live extent (``ops.live_extent``: 1 + each tile's last alive
slot, 0 for none) against a numpy brute force, and the routed count
paths that carry it (``pruned_range_counts``, ``pruned_knn`` and the
``SpatialServer``) against repro's on the same inputs.  On the CPU the
plain versions ignore the extent, so these hold the plumbing and the
helper; the card's kernels are held to the plain versions with and
without it in ``tests/test_torch_cuda.py``.  Tolerance: exact equality
for every output."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.query import knn as jknn, range as jrange
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.serve import router as jrouter, stage_tiles as jstage
from repro_torch.kernels.range_probe import ops
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve.layout import staged_from_numpy

torch.set_num_threads(1)
N, NQ, K = 2500, 30, 5


def _extent_brute(alive: np.ndarray) -> np.ndarray:
    return np.array([np.flatnonzero(row).max() + 1 if row.any() else 0
                     for row in alive], dtype=np.int32)


def _alive_case(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "empty_tile":          # tile 1 has no alive slot
        a = rng.random((4, 300)) < 0.3
        a[1] = False
    elif kind == "full":              # extent == cap on every tile
        a = rng.random((3, 256)) < 0.5
        a[:, -1] = True
    elif kind == "past_prefix":       # a canonical prefix, then stragglers
        a = np.zeros((5, 1000), dtype=bool)
        for t, (n, extra) in enumerate([(10, 700), (0, 3), (200, 999),
                                        (128, 129), (0, 0)]):
            a[t, :n] = True
            a[t, extra] = extra > 0
    elif kind == "one_tile":          # T = 1
        a = np.zeros((1, 135), dtype=bool)
        a[0, [4, 77]] = True
    else:                             # the tests' random 70% mask
        a = rng.random((6, 257)) < 0.7
    return a


@pytest.mark.parametrize("kind", ["empty_tile", "full", "past_prefix",
                                  "one_tile", "random"])
def test_live_extent_matches_brute_force(kind):
    a = _alive_case(kind)
    got = ops.live_extent(torch.from_numpy(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _extent_brute(a))
    # no alive slot lies at or past the extent
    assert not any(row[e:].any() for row, e in zip(a, got.tolist()))


@pytest.fixture(scope="module")
def data():
    return np.array(jgen.dataset("osm", jax.random.PRNGKey(0), N))


@pytest.fixture(scope="module")
def staged(data):
    parts = japi.partition("bsp", jnp.asarray(data), 150)
    out = {}
    for li in ("x", "off"):
        lay, stats = jstage(parts, jnp.asarray(data), JConfig(local_index=li))
        out[li] = (parts, lay, stats, staged_from_numpy(lay, "cpu"))
    return out


def _boxes(seed, q, scale=0.06):
    rng = np.random.default_rng(seed)
    c = rng.random((q, 2))
    s = rng.random((q, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


@pytest.mark.parametrize("alive", ["staged", "random"])
@pytest.mark.parametrize("li", ["x", "off"])
def test_pruned_counts_and_knn_with_extent_match_repro(staged, li, alive):
    """The routed counts and kNN executors given the extent of their alive
    mask (the staging's, or a random 70% of it) equal repro's."""
    _, jl, stats, tl = staged[li]
    a = np.array(jl.alive)
    if alive == "random":
        a = a & (np.random.default_rng(4).random(a.shape) < 0.7)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ext = ops.live_extent(ta)
    np.testing.assert_array_equal(ext.numpy(), _extent_brute(a))
    cb_j = jl.chunk_boxes
    cb_t = tl.chunk_boxes

    qb = _boxes(1, NQ)
    cand = jrouter.candidate_range(jl.probe_boxes, jnp.asarray(qb), 8)[0]
    want = jrange.pruned_range_counts(jnp.asarray(qb), jl.canon_tiles, cand,
                                      chunk_boxes=cb_j, alive=ja)
    got = trange.pruned_range_counts(torch.from_numpy(qb), tl.canon_tiles,
                                     torch.from_numpy(np.array(cand)),
                                     chunk_boxes=cb_t, alive=ta, extent=ext)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pts = np.random.default_rng(2).random((NQ, 2)).astype(np.float32)
    kc, _, excl = jrouter.candidate_knn(jl.probe_boxes, jnp.asarray(pts), 8)
    want = jknn.pruned_knn(jnp.asarray(pts), K, jl.canon_tiles, jl.ids,
                           jl.uni, kc, excl, n_live=stats["n"],
                           chunk_boxes=cb_j, alive=ja)
    got = tknn.pruned_knn(torch.from_numpy(pts), K, tl.canon_tiles, tl.ids,
                          tl.uni, torch.from_numpy(np.array(kc)),
                          torch.from_numpy(np.array(excl)),
                          n_live=stats["n"], chunk_boxes=cb_t, alive=ta,
                          extent=ext)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("li", ["x", "off"])
def test_server_keeps_extent_and_matches_repro(data, li):
    """The server computes its extent once from the staged alive mask and
    passes it on every routed count; range counts and kNN equal repro's."""
    js = JServer.from_method("bsp", jnp.asarray(data), 120,
                             JConfig(local_index=li))
    ts = TServer.from_method("bsp", data, 120, TConfig(local_index=li),
                             device="cpu")
    alive = ts.layout.alive.numpy()
    np.testing.assert_array_equal(ts.tiles.extent.numpy(),
                                  _extent_brute(alive))
    if li == "x":    # canonical members lead each tile under the index
        assert int(ts.tiles.extent.sum()) == int(alive.sum())
    qb = _boxes(3, NQ)
    want, _ = js.range_counts(jnp.asarray(qb))
    got, _ = ts.range_counts(qb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pts = np.random.default_rng(6).random((NQ, 2)).astype(np.float32)
    want = js.knn(jnp.asarray(pts), K)
    got = ts.knn(pts, K)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]
