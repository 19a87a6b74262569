"""repro_torch's routed range probe against repro's, on the same numpy
inputs: every ported ``ops`` function against repro's default executor
and its Pallas kernel in interpret mode, and every ``ref`` oracle
against repro's.  Tolerance: exact equality (bool and int outputs)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.range_probe import ops as jops, ref as jref
from repro_torch.kernels.range_probe import kernel as tkernel
from repro_torch.kernels.range_probe import ops as tops, ref as tref

torch.set_num_threads(1)
CHUNK = 128


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
    """Seeded inputs: queries, tiles, -1-padded candidates, an optional
    random alive mask, and bounding or arbitrary chunk boxes."""
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


GATHER_SHAPES = [(1, 1, 1, 1), (7, 5, 30, 3), (300, 6, 257, 8)]


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("fn", ["gathered_counts", "gathered_mask"])
@pytest.mark.parametrize("q,t,cap,f", GATHER_SHAPES)
def test_gathered_matches_repro(q, t, cap, f, fn, alive, interpret):
    qb, tiles, cand, al, _ = _case(q, t, cap, f, alive, "bounding")
    want = getattr(jops, fn)(_j(qb), _j(tiles), _j(cand),
                             interpret=interpret, alive=_j(al))
    got = getattr(tops, fn)(_t(qb), _t(tiles), _t(cand), alive=_t(al))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("boxes", ["bounding", "arbitrary"])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("fn", ["gathered_counts_skip", "gathered_mask_skip"])
@pytest.mark.parametrize("q,t,cap,f", [(7, 3, 50, 3), (130, 4, 257, 3)])
def test_gathered_skip_matches_repro(q, t, cap, f, fn, alive, boxes,
                                     interpret):
    """Chunk boxes that bound their members and ones that do not: the
    port equals repro's chunk-masked semantics bit for bit either way."""
    qb, tiles, cand, al, cb = _case(q, t, cap, f, alive, boxes)
    want = getattr(jops, fn)(_j(qb), _j(tiles), _j(cb), _j(cand),
                             interpret=interpret, alive=_j(al))
    got = getattr(tops, fn)(_t(qb), _t(tiles), _t(cb), _t(cand),
                            alive=_t(al))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q,t,cap,f", GATHER_SHAPES)
def test_gather_helpers_and_skip_rate_match_repro(q, t, cap, f):
    qb, tiles, cand, al, cb = _case(q, t, cap, f, "random", "arbitrary")
    ids = np.where(np.random.default_rng(q).random((t, cap)) < 0.9,
                   np.arange(t * cap).reshape(t, cap), -1).astype(np.int32)
    pairs = [(tops.gathered_rows(_t(tiles), _t(cand)),
              jops.gathered_rows(_j(tiles), _j(cand))),
             (tops.gathered_ids(_t(ids), _t(cand)),
              jops.gathered_ids(_j(ids), _j(cand))),
             (tops.gathered_alive(_t(al), _t(cand)),
              jops.gathered_alive(_j(al), _j(cand))),
             (tops.gathered_chunk_boxes(_t(cb), _t(cand)),
              jops.gathered_chunk_boxes(_j(cb), _j(cand))),
             (tops.chunk_skip_rate(_t(qb), _t(cb), _t(cand)),
              jops.chunk_skip_rate(_j(qb), _j(cb), _j(cand)))]
    for got, want in pairs:
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("q,t,cap", [(5, 2, 30), (64, 2, 257)])
def test_dense_oracles_match_repro(q, t, cap, alive):
    """The dense oracles the dense kernels are held to."""
    qb, tiles, _, al, cb = _case(q, t, cap, 1, alive, "arbitrary")
    for fn, args in [("probe_mask", ()), ("probe_counts", ()),
                     ("probe_mask_skip", (cb,)),
                     ("probe_counts_skip", (cb,))]:
        want = getattr(jref, fn)(_j(qb), _j(tiles), *map(_j, args), _j(al))
        got = getattr(tref, fn)(_t(qb), _t(tiles), *map(_t, args), _t(al))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_padding_candidates_hit_nothing():
    qb, tiles, _, al, cb = _case(3, 2, 5, 4, "random", "bounding")
    cand = torch.full((3, 4), -1, dtype=torch.int32)
    assert int(tops.gathered_counts(_t(qb), _t(tiles), cand).sum()) == 0
    assert not bool(tops.gathered_mask_skip(_t(qb), _t(tiles), _t(cb),
                                            cand, alive=_t(al)).any())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    qb, tiles, cand, _, _ = _case(4, 2, 30, 2, None, "bounding")
    with pytest.raises(ValueError, match="cuda"):
        tkernel.gather_count(_t(qb), _t(tiles), _t(cand))
    assert tkernel.LAUNCHES["gather_count"] == 0
