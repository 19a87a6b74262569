"""repro_torch's ingest lifecycle under the sharded placement (4 owners
simulated on one device): the ``"sharded"`` cases of repro's
``tests/test_ingest_streams.py`` and
``tests/test_streaming.py::test_sharded_append_and_rebalance_memory_bound``.

Held to repro's sharded server through the same commands on the same
inputs (``test_torch_ingest.py``'s interpreter): after every command
the shard arrays, the owner and local maps, the global probe and chunk
boxes, the bookkeeping, the reports (but ``bytes_transferred``) and
the stats (``moved_tiles`` after a re-stage) equal repro's.  Held
alone to the numpy ``LiveSet`` brute force and a fresh sharded staging
of the live set (``test_torch_ingest_streams.py``'s interpreter) on
all six layouts x osm and pi, the restage threshold and hypothesis
interleavings.  After every command the extent of every shard row
covers its alive slots (``extent >= live_extent(alive)``), tightly
after ``compact`` and re-stages, and padding rows stay sentinel, id
-1, dead and extent 0.  Tolerance: exact equality, ``d2`` bit for bit
against the fresh staging (1e-6 relative against the brute force,
which sums in another order)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import test_torch_ingest as pair
import test_torch_ingest_streams as alone
from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro_torch.core.partition import api as tapi
from repro_torch.kernels.range_probe import ops
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from torch_refs import References

torch.set_num_threads(1)
SHARDED = dict(placement="sharded", shards=4)


def _assert_padding_rows(srv):
    """Shard rows no tile maps to: sentinel, id -1, dead, extent 0."""
    s = srv.slayout
    used = np.zeros(s.id_shards.shape[:2], bool)
    used[s.owner, s.local] = True
    pad = torch.from_numpy(~used)
    assert (s.canon_shards[pad] == torch.tensor([9e9, 9e9, -9e9, -9e9])).all()
    assert (s.id_shards[pad] == -1).all() and not s.alive_shards[pad].any()
    assert (srv.tiles.extent[pad] == 0).all()
    return int(pad.sum())


# -- held to repro's server through the same commands ---------------------------

FIXED_CASES = [("bsp", "osm"), ("hc", "pi"), ("str", "osm")]
SHORT_CASES = [("hilbert", 256, "bsp", "osm"), ("off", 128, "fg", "pi")]
RESTAGE_CFG = dict(slack=256, compact_dead_frac=None, restage_dead_frac=0.3,
                   **SHARDED)
REBALANCE_CFG = dict(slack=0, **SHARDED)


def _rebalance_reference():
    """repro's side of ``test_sharded_append_and_rebalance_memory_bound``:
    1,000 osm objects staged with no slack, then a burst of cap + 1
    copies of the first tile's centre, then the other 500."""
    full = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), 1500))
    base, extra = full[:1000], full[1000:]
    jparts = japi.partition("bsp", jnp.asarray(base), 120)
    js = JServer(jparts, jnp.asarray(base), JConfig(**REBALANCE_CFG))
    tb = np.asarray(jparts.boxes)[0]
    ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
    burst = np.tile(np.asarray(ctr + ctr, np.float32),
                    (js.stats["cap"] + 1, 1))
    steps = [("append", (nb,), pair._state(js, js.append(jnp.asarray(nb))))
             for nb in (burst, extra)]
    return dict(full=base, boxes=np.asarray(jparts.boxes),
                valid=np.asarray(jparts.valid), steps=steps)


REFS = References({
    **{("fixed", m, d): functools.partial(
        pair.reference, m, d, 7, pair.FIXED_STREAM, 8, slack=256, **SHARDED)
       for m, d in FIXED_CASES},
    **{("short", li, c, m, d): functools.partial(
        pair.reference, m, d, 9, pair.SHORT_STREAM, 10,
        **pair._short_cfg(li, c), **SHARDED)
       for li, c, m, d in SHORT_CASES},
    "restage": functools.partial(
        pair.reference, "str", "osm", 13, [("delete", 0.35), ("delete", 0.3)],
        **RESTAGE_CFG),
    "rebalance": _rebalance_reference,
})


@pytest.mark.parametrize("method,dataset", FIXED_CASES)
def test_sharded_fixed_stream_matches_repro(method, dataset):
    """Slack appends, deletes, updates, a forced compaction, an overflow
    re-stage that re-balances the owners, then churn on the re-staged
    shards (hc and str adopt appends into the nearest tile)."""
    ref = REFS["fixed", method, dataset]
    ts = pair._tserver(ref, slack=256, **SHARDED)
    pair._replay(ts, ref["steps"])
    assert ts.stats["restages"] == 1 and "moved_tiles" in ts.stats
    pair._assert_same_answers(ref, ts, 8)
    _assert_padding_rows(ts)


@pytest.mark.parametrize("local_index,chunk,method,dataset", SHORT_CASES)
def test_sharded_short_stream_other_local_indexes_match_repro(
        local_index, chunk, method, dataset):
    ref = REFS["short", local_index, chunk, method, dataset]
    ts = pair._tserver(ref, **pair._short_cfg(local_index, chunk), **SHARDED)
    pair._replay(ts, ref["steps"])
    assert ts.stats["compactions"] >= 1
    pair._assert_same_answers(ref, ts, 10)


def test_sharded_restage_threshold_matches_repro():
    """repro's ``test_restage_threshold_stream``, sharded: churn past
    ``restage_dead_frac`` re-stages and re-balances."""
    ref = REFS["restage"]
    ts = pair._tserver(ref, **RESTAGE_CFG)
    pair._replay(ts, ref["steps"])
    assert ts.stats["restages"] >= 1 and "moved_tiles" in ts.stats


def test_sharded_append_and_rebalance_memory_bound():
    """repro's streaming case: slack-0 appends, a burst that re-stages
    and re-balances the owners, then the rest of the data; shards,
    maps and moved tiles equal repro's, the ceil(T/D) memory bound
    holds again, and the answers equal a fresh sharded staging."""
    ref = REFS["rebalance"]
    base = ref["full"]
    tparts = tapi.Partitioning.from_numpy(ref["boxes"], ref["valid"], "cpu")
    ts = TServer(tparts, base, TConfig(**REBALANCE_CFG), device="cpu")
    (_, (burst,), _), (_, (extra,), _) = ref["steps"]
    assert burst.shape[0] == ts.stats["cap"] + 1
    pair._replay(ts, ref["steps"])
    assert ts.stats["restages"] == 1 and "moved_tiles" in ts.stats
    t, cap = ts.stats["t"], ts.stats["cap"]
    assert ts.stats["t_local"] == -(-t // 4)
    tile_bytes = cap * 4 * 4 + cap * 4
    assert ts.resident_tile_bytes() <= t * tile_bytes / 4 + tile_bytes
    every = np.concatenate([base, burst, extra])
    osrv = TServer(tparts, every, TConfig(**REBALANCE_CFG), device="cpu")
    alone._assert_same_answers(ts, osrv, every, *alone._queries(5))


# -- held alone to the brute force and a fresh sharded staging -----------------

@pytest.mark.parametrize("dataset", ["osm", "pi"])
@pytest.mark.parametrize("method", alone.LAYOUTS)
def test_sharded_fixed_stream_differential(method, dataset):
    srv = alone._run_stream(method, dataset, alone.FIXED_STREAM, seed=7,
                            placement="sharded")
    assert srv.stats["restages"] == 1 and srv.stats["compactions"] >= 1
    _assert_padding_rows(srv)


def test_sharded_restage_threshold_stream():
    stream = [("delete", 0.35), ("check",), ("delete", 0.3), ("check",)]
    srv = alone._run_stream("str", "osm", stream, seed=13,
                            compact_dead_frac=None, restage_dead_frac=0.3,
                            placement="sharded")
    assert srv.stats["restages"] >= 1


@settings(max_examples=12, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(commands=st.lists(alone._op, min_size=3, max_size=8),
       seed=st.integers(0, 2 ** 16), method=st.sampled_from(alone.LAYOUTS),
       local_index=st.sampled_from(["x", "hilbert", "off"]))
def test_sharded_generated_stream_differential(commands, seed, method,
                                               local_index):
    alone._run_stream(method, "osm", commands, seed, compact_dead_frac=0.4,
                      local_index=local_index, placement="sharded")


def test_sharded_extent_rises_on_append_and_stays_on_delete():
    """The extent a shard row: an append raises the rows it writes, a
    delete leaves them (stale-large, still exact), compact tightens."""
    full = np.array(jgen.dataset("pi", jax.random.PRNGKey(2),
                                 600))
    srv = TServer.from_method("bsp", full, 64, TConfig(slack=64, **SHARDED),
                              device="cpu")
    ext0 = srv.tiles.extent.clone()
    srv.append(alone._boxes(np.random.default_rng(0), 40))
    assert (srv.tiles.extent >= ext0).all() and (srv.tiles.extent > ext0).any()
    ext1 = srv.tiles.extent.clone()
    # the id in every shard row's last alive slot
    s = srv.slayout
    rows = torch.nonzero(ext1 > 0)
    last = s.id_shards[rows[:, 0], rows[:, 1], ext1[rows[:, 0], rows[:, 1]]
                       .long() - 1]
    srv.delete(last.numpy())
    assert torch.equal(srv.tiles.extent, ext1)
    want = ops.live_extent(s.alive_shards.flatten(0, 1)).view(ext1.shape)
    assert (ext1 >= want).all() and (ext1 > want).any()
    srv.compact()
    alone._assert_extent(srv, tight=True)
