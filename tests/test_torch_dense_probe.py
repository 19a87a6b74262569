"""repro_torch's dense range probe and dense range executors against
repro's, on the same numpy inputs: ``probe_counts``, ``probe_mask`` and
their ``*_skip`` twins against repro's default executor and its Pallas
kernels in interpret mode (ragged cap and Q, alive None and random,
chunk boxes that bound their members and ones that do not), and the
dense ``range_counts`` / ``range_ids`` over stagings carried across
from repro, in one hit-table block and in many.  Tolerance: exact
equality (bool and int outputs)."""
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
from repro.query import range as jrange
from repro.serve import ServeConfig as JConfig, stage_tiles as jstage
from repro_torch.kernels.range_probe import kernel as tkernel
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.query import range as trange
from repro_torch.serve.layout import staged_from_numpy

torch.set_num_threads(1)
CHUNK = 128


def _boxes(rng, n, scale):
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], axis=-1).astype(np.float32)


def _case(q, t, cap, alive, boxes, seed=0):
    """Seeded queries, tiles (a fifth of the slots sentinel padding), an
    optional random alive mask, and bounding or arbitrary chunk boxes."""
    rng = np.random.default_rng(seed + 1000 * q + 100 * t + cap)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    tiles[rng.random((t, cap)) < 0.2] = [9e9, 9e9, -9e9, -9e9]
    al = None if alive is None else rng.random((t, cap)) < 0.7
    c = -(-cap // CHUNK)
    if boxes == "bounding":
        pad = np.broadcast_to(np.float32([9e9, 9e9, -9e9, -9e9]),
                              (t, c * CHUNK - cap, 4))
        g = np.concatenate([tiles, pad], 1).reshape(t, c, CHUNK, 4)
        cb = np.concatenate([g[..., :2].min(2), g[..., 2:].max(2)], -1)
    else:
        cb = _boxes(rng, t * c, 0.05).reshape(t, c, 4)
    return qb, tiles, al, cb


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


SHAPES = [(1, 1, 1), (7, 3, 30), (130, 4, 257)]   # ragged Q and cap


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("fn", ["probe_counts", "probe_mask"])
@pytest.mark.parametrize("q,t,cap", SHAPES)
def test_dense_probe_matches_repro(q, t, cap, fn, alive, interpret):
    qb, tiles, al, _ = _case(q, t, cap, alive, "bounding")
    want = getattr(jops, fn)(_j(qb), _j(tiles), interpret=interpret,
                             alive=_j(al))
    got = getattr(tops, fn)(_t(qb), _t(tiles), alive=_t(al))
    assert got.dtype == (torch.bool if fn == "probe_mask" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("boxes", ["bounding", "arbitrary"])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("fn", ["probe_counts_skip", "probe_mask_skip"])
@pytest.mark.parametrize("q,t,cap", SHAPES)
def test_dense_probe_skip_matches_repro(q, t, cap, fn, alive, boxes,
                                        interpret):
    """Chunk boxes that do not bound their members: the port still
    equals repro's chunk-masked semantics bit for bit, given the live
    extent beside the alive mask (the plain versions ignore it)."""
    qb, tiles, al, cb = _case(q, t, cap, alive, boxes)
    want = getattr(jops, fn)(_j(qb), _j(tiles), _j(cb), interpret=interpret,
                             alive=_j(al))
    ext = None if al is None else tops.live_extent(_t(al))
    got = getattr(tops, fn)(_t(qb), _t(tiles), _t(cb), alive=_t(al),
                            extent=ext)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["count", "mask", "count_skip", "mask_skip",
                                "count_skip_v1", "mask_skip_v1"])
def test_dense_kernel_wrappers_refuse_cpu_tensors(fn):
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    qb, tiles, _, cb = _case(4, 2, 30, None, "bounding")
    extra = (_t(cb),) if "_skip" in fn else ()
    with pytest.raises(ValueError, match="cuda"):
        getattr(tkernel, fn)(_t(qb), _t(tiles), *extra)
    assert tkernel.LAUNCHES[fn] == 0


@pytest.fixture(scope="module", params=["osm", "pi"])
def staged(request):
    """repro's bsp and hc stagings of 2,500 objects, carried across."""
    data = jgen.dataset(request.param, jax.random.PRNGKey(0), 2500)
    out = {}
    for method in ("bsp", "hc"):
        lay, _ = jstage(japi.partition(method, data, 150), data,
                        JConfig(local_index="off"))
        out[method] = (lay, staged_from_numpy(lay, "cpu"))
    return out


def _qboxes(seed, q=40, scale=0.05):
    return _boxes(np.random.default_rng(seed), q, scale)


@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_dense_range_counts_match_repro(staged, method, alive):
    jl, tl = staged[method]
    al = (None if alive is None else np.asarray(jl.alive)
          & (np.random.default_rng(1).random(jl.alive.shape) < 0.8))
    qb = _qboxes(2)
    want = jrange.range_counts(jnp.asarray(qb), jl.canon_tiles, _j(al))
    got = trange.range_counts(torch.from_numpy(qb), tl.canon_tiles, _t(al))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("max_hits", [3, 64, 100_000])
@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_dense_range_ids_match_repro(staged, method, max_hits, blocked,
                                     monkeypatch):
    """Ascending ids, -1 padding and overflow past max_hits (3 overflows
    most queries; 100,000 is wider than the whole T·cap table), with
    the (Q, T, cap) table built whole or three queries at a time."""
    jl, tl = staged[method]
    if blocked:
        monkeypatch.setattr(tops, "_HIT_TABLE_BYTES", 3 * tl.ids.numel())
    al = np.asarray(jl.alive) & (
        np.random.default_rng(3).random(jl.alive.shape) < 0.9)
    qb = _qboxes(4)
    want = jrange.range_ids(jnp.asarray(qb), jl.canon_tiles, jl.ids,
                            max_hits, jnp.asarray(al))
    got = trange.range_ids(torch.from_numpy(qb), tl.canon_tiles, tl.ids,
                           max_hits, torch.from_numpy(al))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dense_blocks_cover_every_query_within_budget(monkeypatch):
    monkeypatch.setattr(tops, "_HIT_TABLE_BYTES", 1000)
    for q, row in [(0, 10), (1, 5000), (17, 300), (40, 1000), (9, 1)]:
        blocks = tops.dense_blocks(q, row)
        rows = [i for b in blocks for i in range(q)[b]]
        assert rows == list(range(q))
        assert all((b.stop - b.start) * row <= 1000 or b.stop - b.start == 1
                   for b in blocks)
