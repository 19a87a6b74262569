"""repro_torch's geometry helpers (``areas``, ``contains_point``,
``box_union``, ``clip_box``, ``universe``'s ``valid`` mask) and the
reference-point range paths (``range_counts_rp``,
``routed_range_counts``) against repro's, bit for bit: the helpers on
random, degenerate and inverted float32 boxes; the rp counts on repro's
fg and bsp stagings of osm and pi objects, as
``tests/test_range_knn.py`` holds repro's (and against its brute
force), the routed form with the router's fan-out and with an
undersized one (flagged, never silent)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.query import range as jrange
from repro.serve import router as jrouter, stage_tiles
from repro_torch.core import geometry
from repro_torch.query import range as trange

torch.set_num_threads(1)


def _boxes(rng, n):
    lo = rng.random((n, 2)).astype(np.float32)
    ext = (rng.random((n, 2)) * 0.3 - 0.05).astype(np.float32)  # some inverted
    b = np.concatenate([lo, lo + ext], 1)
    b[:5, 2:] = b[:5, :2]                                        # degenerate
    return b


def _eq(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_helpers_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 200), _boxes(rng, 200)
    pts = rng.random((150, 2)).astype(np.float32)
    valid = rng.random(200) < 0.7
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _eq(geometry.areas(ta), jgeo.areas(jnp.asarray(a)))
    _eq(geometry.contains_point(ta[:40], torch.from_numpy(pts)),
        jgeo.contains_point(jnp.asarray(a[:40]), jnp.asarray(pts)))
    _eq(geometry.box_union(ta, tb), jgeo.box_union(jnp.asarray(a),
                                                   jnp.asarray(b)))
    _eq(geometry.clip_box(ta, tb), jgeo.clip_box(jnp.asarray(a),
                                                 jnp.asarray(b)))
    _eq(geometry.clip_box(ta, tb[:1]), jgeo.clip_box(jnp.asarray(a),
                                                     jnp.asarray(b[:1])))
    _eq(geometry.universe(ta), jgeo.universe(jnp.asarray(a)))
    _eq(geometry.universe(ta, torch.from_numpy(valid)),
        jgeo.universe(jnp.asarray(a), jnp.asarray(valid)))


def _qboxes(seed, q, scale=0.06):
    rng = np.random.default_rng(seed)
    c, s = rng.random((q, 2)), rng.random((q, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


@pytest.fixture(scope="module", params=["osm", "pi"])
def staged(request):
    mbrs = jgen.dataset(request.param, jax.random.PRNGKey(0), 2500)
    out = {}
    for m in ("fg", "bsp"):
        parts = japi.partition(m, mbrs, 150)
        out[m] = (parts,) + stage_tiles(parts, mbrs)
    return np.asarray(mbrs), out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("method", ["fg", "bsp"])
def test_range_counts_rp_bit_for_bit(staged, method):
    mbrs, out = staged
    _, layout, _ = out[method]
    qb = _qboxes(3, 40)
    want = jrange.range_counts_rp(jnp.asarray(qb), layout.tiles,
                                  layout.tile_boxes, layout.uni)
    got = trange.range_counts_rp(_t(qb), _t(layout.tiles),
                                 _t(layout.tile_boxes), _t(layout.uni))
    _eq(got, want)
    ref = trange.range_query_ref(mbrs, qb)
    assert got.tolist() == [len(r) for r in ref]


@pytest.mark.parametrize("method", ["fg", "bsp"])
def test_routed_range_counts_bit_for_bit(staged, method):
    mbrs, out = staged
    parts, layout, _ = out[method]
    qb = _qboxes(4, 25)
    rmask, fanout = jrouter.route_range(parts, jnp.asarray(qb))
    args = (layout.tiles, layout.tile_boxes, layout.uni, rmask)
    targs = [_t(a) for a in args]
    for f in (int(jnp.max(fanout)), 1):
        want = jrange.routed_range_counts(jnp.asarray(qb), *args,
                                          max_fanout=f)
        got = trange.routed_range_counts(_t(qb), *targs, max_fanout=f)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    counts, overflow = trange.routed_range_counts(
        _t(qb), *targs, max_fanout=int(jnp.max(fanout)))
    assert not bool(overflow.any())
    assert counts.tolist() == [len(r) for r in
                               trange.range_query_ref(mbrs, qb)]
