"""repro_torch's routed hit lists (``ops.gathered_hit_list{,_skip}``)
against the nonzeros of repro's routed hit tables, on the same numpy
inputs, in repro's default executor and its Pallas kernel in interpret
mode: with and without an alive mask and its live extent, with chunk
boxes that bound their members and ones that do not, and at the edges
(all -1 candidates, Q·F = 0, a query with no hits).  Then the executors
that take the lists, ``pruned_range_ids`` and ``knn_partial`` given the
extent, against repro's.  On the CPU the lists are the plain version's;
``tests/test_torch_cuda.py`` holds the card's kernels to it.
Tolerance: exact equality throughout (int outputs, float32 distances
bit for bit)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.kernels.range_probe import ops as jops
from repro.query import knn as jknn, range as jrange
from repro.serve import ServeConfig as JConfig
from repro.serve import router as jrouter, stage_tiles as jstage
from repro_torch.kernels.range_probe import kernel as tkernel
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve.layout import staged_from_numpy

torch.set_num_threads(1)
CHUNK = 128
GATHER_SHAPES = [(1, 1, 1, 1), (7, 5, 30, 3), (300, 6, 257, 8)]
N, NQ, K = 2500, 30, 5


def _boxes(rng, n, scale):
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], axis=-1).astype(np.float32)


def _chunk_boxes(tiles):
    """True per-128-slot MBR summary of ``tiles`` (staging invariant)."""
    t, cap, _ = tiles.shape
    c = -(-cap // CHUNK)
    pad = np.broadcast_to(np.array([9e9, 9e9, -9e9, -9e9], np.float32),
                          (t, c * CHUNK - cap, 4))
    g = np.concatenate([tiles, pad], axis=1).reshape(t, c, CHUNK, 4)
    return np.concatenate([g[..., :2].min(2), g[..., 2:].max(2)], -1)


def _case(q, t, cap, f, alive, boxes, seed=0):
    rng = np.random.default_rng(seed + 1000 * q + 100 * t + cap + f)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    cand = rng.integers(-1, t, (q, f)).astype(np.int32)
    al = None if alive is None else rng.random((t, cap)) < 0.7
    c = -(-cap // CHUNK)
    cb = (_chunk_boxes(tiles) if boxes == "bounding"
          else _boxes(rng, t * c, 0.05).reshape(t, c, 4))
    return qb, tiles, cand, al, cb


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _nonzero_triples(mask, cand):
    """repro's flat (query, candidate·cap + slot) nonzeros as (query,
    tile, slot)."""
    q, f, cap = mask.shape
    qi, flat = np.nonzero(np.asarray(mask).reshape(q, -1))
    return qi, cand[qi, flat // cap], flat % cap


def _hit_lists(qb, tiles, cand, al, cb):
    """The port's list without and with the live extent of ``al``."""
    extents = [None] if al is None else [None, tops.live_extent(_t(al))]
    for ext in extents:
        if cb is None:
            yield tops.gathered_hit_list(_t(qb), _t(tiles), _t(cand),
                                         alive=_t(al), extent=ext)
        else:
            yield tops.gathered_hit_list_skip(_t(qb), _t(tiles), _t(cb),
                                              _t(cand), alive=_t(al),
                                              extent=ext)


def _assert_triples(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("boxes", ["none", "bounding", "arbitrary"])
@pytest.mark.parametrize("q,t,cap,f", GATHER_SHAPES)
def test_hit_list_is_nonzero_of_repro_table(q, t, cap, f, boxes, alive,
                                            interpret):
    """The list equals ``np.nonzero`` of repro's (Q, F·cap) table, in its
    flat order, with and without the extent; chunk boxes that do not
    bound their members keep repro's chunk-masked semantics."""
    qb, tiles, cand, al, cb = _case(q, t, cap, f, alive,
                                    "bounding" if boxes == "none" else boxes)
    if boxes == "none":
        cb = None
        mask = jops.gathered_mask(_j(qb), _j(tiles), _j(cand),
                                  interpret=interpret, alive=_j(al))
    else:
        mask = jops.gathered_mask_skip(_j(qb), _j(tiles), _j(cb), _j(cand),
                                       interpret=interpret, alive=_j(al))
    want = _nonzero_triples(mask, cand)
    for got in _hit_lists(qb, tiles, cand, al, cb):
        _assert_triples(got, want)


@pytest.mark.parametrize("skip", [False, True])
def test_hit_list_edges(skip):
    """All -1 candidates, Q·F = 0 both ways, and a query with no hits
    among queries that have some."""
    qb, tiles, cand, al, cb = _case(6, 4, 300, 5, "random", "bounding")
    cbs = cb if skip else None
    qb[2] = [5.0, 5.0, 5.5, 5.5]                   # outside every tile
    for c in (np.full((6, 5), -1, np.int32), cand[:0], cand[:, :0]):
        for got in _hit_lists(qb[:c.shape[0]], tiles, c, al, cbs):
            assert all(x.shape == (0,) and x.dtype == torch.int64
                       for x in got)
    if skip:
        mask = jops.gathered_mask_skip(_j(qb), _j(tiles), _j(cb), _j(cand),
                                       alive=_j(al))
    else:
        mask = jops.gathered_mask(_j(qb), _j(tiles), _j(cand), alive=_j(al))
    want = _nonzero_triples(mask, cand)
    assert 2 not in want[0] and len(set(want[0].tolist())) > 1
    for got in _hit_lists(qb, tiles, cand, al, cbs):
        _assert_triples(got, want)


def test_plain_hit_list_in_blocks_equals_one_block():
    """The plain version's blocks (a few queries at a time, trimmed to
    their live columns) give the one-block list."""
    qb, tiles, cand, al, cb = _case(40, 5, 70, 6, "random", "arbitrary")
    args = (_t(qb), _t(tiles), _t(cand), _t(cb))
    whole = tops.plain_hit_list(*args, alive=_t(al))
    assert len(tops.hit_table_blocks(_t(cand), 70, 3 * 6 * 70)) > 10
    for got, want in zip(tops.plain_hit_list(*args, alive=_t(al),
                                             budget=3 * 6 * 70), whole):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["gather_hits", "gather_hits_skip"])
def test_hit_list_wrappers_refuse_cpu_tensors(name):
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    qb, tiles, cand, _, cb = _case(4, 2, 30, 2, None, "bounding")
    extra = (_t(cb),) if name.endswith("_skip") else ()
    tkernel.reset_launches()
    with pytest.raises(ValueError, match="cuda"):
        getattr(tkernel, name)(_t(qb), _t(tiles), *extra, _t(cand))
    assert sum(tkernel.LAUNCHES.values()) == 0


@pytest.fixture(scope="module")
def staged():
    data = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), N))
    parts = japi.partition("bsp", jnp.asarray(data), 150)
    out = {}
    for li in ("x", "off"):
        lay, stats = jstage(parts, jnp.asarray(data), JConfig(local_index=li))
        out[li] = (lay, stats, staged_from_numpy(lay, "cpu"))
    return out


@pytest.mark.parametrize("alive", ["staged", "random"])
@pytest.mark.parametrize("li", ["x", "off"])
def test_executors_with_extent_match_repro(staged, li, alive):
    """``pruned_range_ids`` and ``knn_partial`` given the live extent of
    their alive mask (the staging's, or a random 70% of it) equal
    repro's; knn_partial also at a max_cand that truncates."""
    jl, _, tl = staged[li]
    a = np.array(jl.alive)
    if alive == "random":
        a = a & (np.random.default_rng(4).random(a.shape) < 0.7)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ext = tops.live_extent(ta)
    rng = np.random.default_rng(1)
    qb = _boxes(rng, NQ, 0.06)
    cand = jrouter.candidate_range(jl.probe_boxes, jnp.asarray(qb), 8)[0]
    want = jrange.pruned_range_ids(jnp.asarray(qb), jl.canon_tiles, jl.ids,
                                   cand, 16, chunk_boxes=jl.chunk_boxes,
                                   alive=ja)
    got = trange.pruned_range_ids(torch.from_numpy(qb), tl.canon_tiles,
                                  tl.ids, _t(cand), 16,
                                  chunk_boxes=tl.chunk_boxes, alive=ta,
                                  extent=ext)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    pts = rng.random((NQ, 2)).astype(np.float32)
    kc = jrouter.candidate_knn(jl.probe_boxes, jnp.asarray(pts), 6)[0]
    re = rng.random(NQ).astype(np.float32) * 0.08
    for mc in (1024, 6):
        want = jknn.knn_partial(jnp.asarray(pts), jl.canon_tiles, jl.ids, kc,
                                jnp.asarray(re), K, max_cand=mc,
                                chunk_boxes=jl.chunk_boxes, alive=ja)
        got = tknn.knn_partial(torch.from_numpy(pts), tl.canon_tiles, tl.ids,
                               _t(kc), torch.from_numpy(re), K, max_cand=mc,
                               chunk_boxes=tl.chunk_boxes, alive=ta,
                               extent=ext)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
