"""repro_torch's dense hit list (``ops.dense_hit_list``) against the
nonzeros of repro's dense hit table (``probe_mask``), on the same numpy
inputs, in repro's default executor and its Pallas kernel in interpret
mode: alive None, staged (each tile's alive slots a prefix, one tile
with none) and random, each with its live extent, and at the edges
(Q = 0, a query with no hits, a tile with no alive slot).  Then the
query blocking (``ops.dense_blocks``; a blocked list against one block)
and the dense executors given the extent (``range_counts``,
``range_ids``, ``batched_knn``) against repro's on "off" and "x"
stagings.  On the CPU the list is the plain version's;
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
from repro.serve import ServeConfig as JConfig, stage_tiles as jstage
from repro_torch.kernels.range_probe import kernel as tkernel
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve.layout import staged_from_numpy

torch.set_num_threads(1)
SHAPES = [(1, 1, 1), (7, 3, 30), (130, 4, 257)]   # ragged Q and cap
N, NQ, K = 2500, 30, 5


def _boxes(rng, n, scale):
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], axis=-1).astype(np.float32)


def _alive(rng, kind, t, cap):
    """None; "staged": each tile's alive slots a prefix of its own length
    (tile 1 none, the last tile all of cap); "random": 70% anywhere."""
    if kind is None:
        return None
    if kind == "random":
        return rng.random((t, cap)) < 0.7
    n = rng.integers(0, cap + 1, t)
    n[-1] = cap
    if t > 2:
        n[1] = 0
    return np.arange(cap)[None, :] < n[:, None]


def _case(q, t, cap, alive, seed=0):
    rng = np.random.default_rng(seed + 1000 * q + 100 * t + cap)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    tiles[rng.random((t, cap)) < 0.2] = [9e9, 9e9, -9e9, -9e9]
    return qb, tiles, _alive(rng, alive, t, cap)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _lists(qb, tiles, al):
    """The port's list without and with the live extent of ``al``."""
    extents = [None] if al is None else [None, tops.live_extent(_t(al))]
    for ext in extents:
        yield tops.dense_hit_list(_t(qb), _t(tiles), alive=_t(al),
                                  extent=ext)


def _assert_triples(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("alive", [None, "staged", "random"])
@pytest.mark.parametrize("q,t,cap", SHAPES)
def test_dense_hit_list_is_nonzero_of_repro_table(q, t, cap, alive,
                                                  interpret):
    """The list equals ``np.nonzero`` of repro's (Q, T, cap) table, in its
    flat order, with and without the live extent."""
    qb, tiles, al = _case(q, t, cap, alive)
    mask = jops.probe_mask(_j(qb), _j(tiles), interpret=interpret,
                           alive=_j(al))
    want = np.nonzero(np.asarray(mask))
    for got in _lists(qb, tiles, al):
        _assert_triples(got, want)


def test_dense_hit_list_edges():
    """Q = 0, a query outside every tile among queries with hits, and a
    tile with no alive slot (extent 0) among tiles with some."""
    qb, tiles, al = _case(9, 5, 300, "staged")
    qb[2] = [5.0, 5.0, 5.5, 5.5]                   # outside every tile
    for got in _lists(qb[:0], tiles, al):
        assert all(x.shape == (0,) and x.dtype == torch.int64 for x in got)
    assert int(tops.live_extent(_t(al))[1]) == 0
    want = np.nonzero(np.asarray(jops.probe_mask(_j(qb), _j(tiles),
                                                 alive=_j(al))))
    assert 2 not in want[0] and 1 not in want[1]
    assert len(set(want[0].tolist())) > 1
    for got in _lists(qb, tiles, al):
        _assert_triples(got, want)


@pytest.mark.parametrize("q,row,budget", [
    (0, 10, 1000), (1, 5000, 1000), (17, 300, 1000), (40, 1000, 1000),
    (9, 1, 1000), (1024, 418_000, 1 << 29), (5, 7, None)])
def test_dense_blocks_cover_every_query_in_order(q, row, budget):
    """Consecutive blocks that hold every query once, in order, each
    within the budget unless it is a single query."""
    blocks = tops.dense_blocks(q, row, budget)
    limit = tops._HIT_TABLE_BYTES if budget is None else budget
    assert [i for b in blocks for i in range(q)[b]] == list(range(q))
    assert all(b.stop - b.start >= 1 for b in blocks)
    assert all((b.stop - b.start) * row <= limit or b.stop - b.start == 1
               for b in blocks)
    if q and row <= limit:
        assert len(blocks) == -(-q // (limit // row))


@pytest.mark.parametrize("alive", [None, "random"])
def test_blocked_dense_hit_list_equals_one_block(alive, monkeypatch):
    """The plain version's tables a few queries at a time (budget
    patched) give the one-block list."""
    qb, tiles, al = _case(40, 5, 70, alive)
    whole = tops.dense_hit_list(_t(qb), _t(tiles), alive=_t(al))
    monkeypatch.setattr(tops, "_HIT_TABLE_BYTES", 3 * 5 * 70)
    assert len(tops.dense_blocks(40, 5 * 70)) > 10
    got = tops.dense_hit_list(_t(qb), _t(tiles), alive=_t(al))
    assert whole[0].numel() > 0
    for g, w in zip(got, whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["dense_counts", "dense_hits"])
def test_dense_wrappers_refuse_cpu_tensors(name):
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    qb, tiles, _ = _case(4, 2, 30, None)
    tkernel.reset_launches()
    with pytest.raises(ValueError, match="cuda"):
        getattr(tkernel, name)(_t(qb), _t(tiles))
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
def test_dense_executors_with_extent_match_repro(staged, li, alive):
    """``range_counts``, ``range_ids`` and ``batched_knn`` given the live
    extent of their alive mask (the staging's, or a random 70% of it)
    equal repro's; batched_knn also at a max_cand that truncates."""
    jl, stats, tl = staged[li]
    a = np.array(jl.alive)
    if alive == "random":
        a = a & (np.random.default_rng(4).random(a.shape) < 0.7)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    ext = tops.live_extent(ta)
    rng = np.random.default_rng(1)
    qb = _boxes(rng, NQ, 0.06)
    want = jrange.range_counts(jnp.asarray(qb), jl.canon_tiles, ja)
    got = trange.range_counts(torch.from_numpy(qb), tl.canon_tiles, ta,
                              extent=ext)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jrange.range_ids(jnp.asarray(qb), jl.canon_tiles, jl.ids, 16, ja)
    got = trange.range_ids(torch.from_numpy(qb), tl.canon_tiles, tl.ids, 16,
                           ta, extent=ext)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    pts = rng.random((NQ, 2)).astype(np.float32)
    for mc in (1024, 6):
        want = jknn.batched_knn(jnp.asarray(pts), K, jl.canon_tiles, jl.ids,
                                jl.uni, max_cand=mc, n_live=stats["n"],
                                alive=ja)
        got = tknn.batched_knn(torch.from_numpy(pts), K, tl.canon_tiles,
                               tl.ids, tl.uni, max_cand=mc,
                               n_live=stats["n"], alive=ta, extent=ext)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
