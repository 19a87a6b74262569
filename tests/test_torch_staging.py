"""repro_torch's partitioning, MASJ staging and routing against repro's
on the same numpy inputs (osm- and pi-like data from repro's
generators): bsp boxes and valid masks, membership pairs with
nearest-tile adoption, the O(nnz) assignment, every StagedLayout field
and stat, candidate lists and HeatTracker state.  Tolerance: exact
equality everywhere (bool, int and float32 min/max outputs)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi, assign as jassign
from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, layout as jlayout
from repro.serve import router as jrouter
from repro_torch.core.partition import api as tapi, assign as tassign
from repro_torch.serve import ServeConfig as TConfig, layout as tlayout
from repro_torch.serve import router as trouter

torch.set_num_threads(1)
N = 3000


_PARTS: dict = {}


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    return np.array(jgen.dataset(request.param, jax.random.PRNGKey(0), N))


def _parts(mbrs, payload):
    """Both packages' bsp partitionings (cached: repro's jit is slow)."""
    key = (mbrs.tobytes(), payload)
    if key not in _PARTS:
        _PARTS[key] = (japi.partition("bsp", jnp.asarray(mbrs), payload),
                       tapi.partition("bsp", torch.from_numpy(mbrs), payload))
    return _PARTS[key]


@pytest.mark.parametrize("payload", [120, N])
def test_bsp_boxes_and_valid_match_repro(data, payload):
    jp, tp = _parts(data, payload)
    np.testing.assert_array_equal(tp.boxes.numpy(), np.asarray(jp.boxes))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert tp.k() == int(jp.k())


def test_membership_pairs_match_repro_with_adoption(data):
    """Shrunken regions leave gaps, and far objects lie outside them all:
    both are adopted by the nearest tile exactly as repro adopts them."""
    bsp, _ = _parts(data, 120)
    b = np.asarray(bsp.boxes)
    mid, half = (b[:, :2] + b[:, 2:]) / 2, (b[:, 2:] - b[:, :2]) * 0.3
    jp = japi.Partitioning(
        boxes=jnp.asarray(np.concatenate([mid - half, mid + half], -1)),
        valid=bsp.valid)
    rng = np.random.default_rng(0)
    far = np.concatenate([rng.random((40, 2)) * 3 + 1.5,
                          np.full((40, 2), 1e-3)], axis=1)
    far[:, 2:] += far[:, :2]
    mbrs = np.concatenate([data, far.astype(np.float32)])
    want = np.nonzero(np.asarray(jlayout.membership(jp, jnp.asarray(mbrs))))
    tp = tapi.Partitioning.from_numpy(jp.boxes, jp.valid, "cpu")
    obj, part = tlayout.membership(tp, torch.from_numpy(mbrs))
    np.testing.assert_array_equal(obj.numpy(), want[0])
    np.testing.assert_array_equal(part.numpy(), want[1])


@pytest.mark.parametrize("capacity", [8, 40, 256])
def test_assignment_matches_repro_including_overflow(data, capacity):
    jp, tp = _parts(data, 120)
    hit = np.asarray(jlayout.membership(jp, jnp.asarray(data)))
    want = jassign.assign_from_hit(jnp.asarray(hit), capacity)
    got = tassign.assign_from_hit(torch.from_numpy(hit), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("local_index,chunk", [("off", 128), ("x", 128),
                                               ("x", 256)])
def test_stage_tiles_matches_repro(data, local_index, chunk):
    jp, tp = _parts(data, 120)
    jlay, jstats = jlayout.stage_tiles(
        jp, jnp.asarray(data), JConfig(local_index=local_index, chunk=chunk))
    tlay, tstats = tlayout.stage_tiles(
        tp, torch.from_numpy(data),
        TConfig(local_index=local_index, chunk=chunk))
    for f in dataclasses.fields(tlayout.StagedLayout):
        want, got = getattr(jlay, f.name), getattr(tlay, f.name)
        if want is None:
            assert got is None, f.name
            continue
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype)), f.name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f.name)
    assert tstats == jstats


def test_staging_overflow_raises_like_repro(data):
    jp, tp = _parts(data, 120)
    with pytest.raises(ValueError, match="staging overflow"):
        jlayout.stage_tiles(jp, jnp.asarray(data), JConfig(capacity=16))
    with pytest.raises(ValueError, match="staging overflow"):
        tlayout.stage_tiles(tp, torch.from_numpy(data), TConfig(capacity=16))


@pytest.mark.parametrize("f_max", [1, 3, 8, 64])
def test_candidates_and_routing_match_repro(data, f_max):
    jp, tp = _parts(data, 120)
    rng = np.random.default_rng(f_max)
    c = rng.random((50, 2))
    s = rng.random((50, 2)) * 0.08
    qb = np.concatenate([c - s, c + s], -1).astype(np.float32)
    jlay, _ = jlayout.stage_tiles(jp, jnp.asarray(data))
    tlay, _ = tlayout.stage_tiles(tp, torch.from_numpy(data))
    jq, tq = jnp.asarray(qb), torch.from_numpy(qb)
    pairs = list(zip(trouter.candidate_range(tlay.probe_boxes, tq, f_max),
                     jrouter.candidate_range(jlay.probe_boxes, jq, f_max)))
    pairs += list(zip(trouter.route_range(tp, tq), jrouter.route_range(jp, jq)))
    pairs.append((trouter.probe_fanout(tlay.probe_boxes, tq),
                  jrouter.probe_fanout(jlay.probe_boxes, jq)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("decay", [0.85, 1.0])
def test_heat_tracker_state_matches_repro(decay):
    rng = np.random.default_rng(3)
    jt, tt = jrouter.HeatTracker(40, decay), trouter.HeatTracker(40, decay,
                                                          device="cpu")
    for q, f in [(30, 4), (1, 1), (64, 9), (17, 40)]:
        cand = np.where(rng.random((q, f)) < 0.7,
                        rng.integers(0, 40, (q, f)), -1).astype(np.int32)
        jt.observe(cand)
        tt.observe(torch.from_numpy(cand))
    for got, want in zip(tt.snapshot(), jt.snapshot()):
        np.testing.assert_array_equal(got, want)
    assert tt.batches == jt.batches


@pytest.mark.parametrize("bad", [
    dict(placement="mesh"), dict(probe="fast"), dict(local_index="y"),
    dict(chunk=100), dict(capacity=0), dict(slack=-1), dict(shards=0),
    dict(shards=2), dict(compact_dead_frac=0.0),
    dict(restage_dead_frac=1.5), dict(policy="hot")])
def test_serve_config_validation_matches_repro(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())
