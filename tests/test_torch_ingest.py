"""repro_torch's ingest lifecycle (``append``, ``delete``, ``update``,
``compact``, the compaction policy and the overflow re-stage) against
repro's, the two servers driven through the same commands on the same
inputs: repro's data and ``Partitioning`` carried across, the
commands' objects and ids drawn with numpy.  After every command the
port's device staging (``canon_tiles``, ``ids``, ``alive``,
``probe_boxes``, ``chunk_boxes``, ``uni``) equals repro's bit for bit,
so do the bookkeeping (``_fill``, ``_dead``, ``_n_free``,
``_canon_slot``), the reports key for key (but ``bytes_transferred``:
the port counts what it uploads, unpadded) and ``stats``; the live
extent covers every alive slot, tightly after ``compact`` and
re-stages.  Also the error contract with the reference's messages,
dead-slot reuse and the scatter's upload bound.  Tolerance: exact
equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro_torch.core.partition import api as tapi
from repro_torch.kernels.range_probe import ops
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer

torch.set_num_threads(1)
N_BASE, PAYLOAD = 400, 64
LAYOUT_FIELDS = ("canon_tiles", "ids", "alive", "probe_boxes", "chunk_boxes",
                 "uni")
SHARD_FIELDS = ("canon_shards", "id_shards", "alive_shards", "chunk_shards",
                "probe_boxes", "chunk_boxes", "uni")
BOOKKEEPING = ("_fill", "_dead", "_n_free", "_canon_slot")

# test_ingest_streams.py's corpus: slack appends, scattered deletes,
# in-place updates, a forced compaction, an overflow re-stage, then
# more churn on the re-staged layout
FIXED_STREAM = [
    ("append", 80), ("delete", 0.10), ("update", 25), ("append", 60),
    ("delete", 0.25), ("compact",), ("burst",), ("delete", 0.15),
    ("update", 10),
]
# a shorter stream that also crosses the automatic compaction threshold
SHORT_STREAM = [
    ("append", 80), ("delete", 0.3), ("update", 20), ("compact",),
    ("append", 40), ("delete", 0.35), ("update", 15),
]


def _boxes(rng, m, scale=0.01):
    lo = rng.uniform(0.0, 1.0, (m, 2)).astype(np.float32)
    ex = rng.uniform(0.0, scale, (m, 2)).astype(np.float32)
    return np.concatenate([lo, lo + ex], axis=1)


def _servers(method, dataset, seed, **cfg):
    """repro's server and the port's on repro's data and partitioning."""
    full = np.array(jgen.dataset(dataset, jax.random.PRNGKey(seed), N_BASE))
    jparts = japi.partition(method, jnp.asarray(full), PAYLOAD)
    tparts = tapi.Partitioning.from_numpy(jparts.boxes, jparts.valid, "cpu")
    return (JServer(jparts, jnp.asarray(full), JConfig(**cfg)),
            TServer(tparts, full, TConfig(**cfg), device="cpu"))


def _assert_same_state(js, ts, jrep, trep, tight):
    """The staging (the shards and owner maps under the sharded
    placement), bookkeeping, report and stats equal repro's, and the
    extent (a tile, or a shard row) covers every alive slot."""
    if js.slayout is None:
        fields, jlay, tlay = LAYOUT_FIELDS, js.layout, ts.layout
        alive = ts.layout.alive
    else:
        fields, jlay, tlay = SHARD_FIELDS, js.slayout, ts.slayout
        alive = ts.slayout.alive_shards.flatten(0, 1)
        np.testing.assert_array_equal(tlay.owner, jlay.owner)
        np.testing.assert_array_equal(tlay.local, jlay.local)
    for name in fields:
        want, got = getattr(jlay, name), getattr(tlay, name)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    ts.tiles._ensure_mirror()
    for name in BOOKKEEPING:
        np.testing.assert_array_equal(getattr(ts.tiles, name),
                                      getattr(js.tiles, name), err_msg=name)
    drop = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k != "bytes_transferred"}
    assert drop(trep) == drop(jrep)
    assert ts.stats == js.stats
    ext = ts.tiles.extent
    want = ops.live_extent(alive).view(ext.shape)
    assert bool((ext >= want).all())
    if tight:
        assert torch.equal(ext, want)


def _run(js, ts, commands, seed):
    rng = np.random.default_rng(seed)
    live = set(range(N_BASE))
    for op in commands:
        kind = op[0]
        if kind == "append":
            nb = _boxes(rng, op[1])
            jrep, trep = js.append(jnp.asarray(nb)), ts.append(nb)
            live |= set(range(jrep["n_total"] - op[1], jrep["n_total"]))
        elif kind in ("delete", "update"):
            pool = np.array(sorted(live))
            count = (max(1, int(op[1] * len(live))) if kind == "delete"
                     else op[1])
            ids = rng.choice(pool, size=min(count, pool.size - 60),
                             replace=False)
            if kind == "delete":
                jrep, trep = js.delete(ids), ts.delete(ids)
                live -= set(ids.tolist())
            else:
                nb = _boxes(rng, ids.size)
                jrep, trep = js.update(ids, jnp.asarray(nb)), ts.update(ids,
                                                                        nb)
        elif kind == "compact":
            jrep, trep = js.compact(), ts.compact()
        else:                                        # burst: cap + 1 copies
            tb = np.asarray(js.parts.boxes)[0]
            ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
            nb = np.tile(np.asarray(ctr + ctr, np.float32),
                         (js.stats["cap"] + 1, 1))
            jrep, trep = js.append(jnp.asarray(nb)), ts.append(nb)
            assert trep["restaged"]
            live |= set(range(jrep["n_total"] - nb.shape[0],
                              jrep["n_total"]))
        _assert_same_state(js, ts, jrep, trep,
                           kind == "compact" or jrep.get("restaged"))
    return live


def _assert_same_answers(js, ts, seed):
    rng = np.random.default_rng(seed)
    c = rng.random((16, 2)).astype(np.float32)
    qb = np.concatenate([c - 0.05, c + 0.05], -1)
    np.testing.assert_array_equal(ts.range_counts(qb)[0].numpy(),
                                  np.asarray(js.range_counts(
                                      jnp.asarray(qb))[0]))
    np.testing.assert_array_equal(
        ts.range_ids(qb, max_hits=256)[0].numpy(),
        np.asarray(js.range_ids(jnp.asarray(qb), max_hits=256)[0]))


@pytest.mark.parametrize("method,dataset", [
    ("bsp", "osm"), ("hc", "osm"), ("str", "osm"), ("hc", "pi")])
def test_fixed_stream_matches_repro(method, dataset):
    """hc and str do not cover the universe, so their appends exercise
    nearest-tile adoption."""
    js, ts = _servers(method, dataset, 7, slack=256)
    _run(js, ts, FIXED_STREAM, seed=7)
    assert ts.stats["restages"] == 1 and ts.stats["compactions"] >= 1
    assert ts.widths.cap == js.widths.cap and ts.widths._w == js.widths._w
    _assert_same_answers(js, ts, 8)


@pytest.mark.parametrize("local_index,chunk,method,dataset", [
    ("hilbert", 256, "bsp", "osm"), ("off", 128, "str", "pi")])
def test_short_stream_other_local_indexes_match_repro(local_index, chunk,
                                                      method, dataset):
    """Compaction's Hilbert slot order (the encode over the current
    universe; chunk boxes of 256 slots, each stored twice) and its
    unindexed branch, forced and by threshold."""
    js, ts = _servers(method, dataset, 9, slack=128, local_index=local_index,
                      chunk=chunk, compact_dead_frac=0.25)
    _run(js, ts, SHORT_STREAM, seed=9)
    assert ts.stats["compactions"] >= 1
    _assert_same_answers(js, ts, 10)


# -- the error contract -----------------------------------------------------

@pytest.fixture
def small_server():
    full = np.array(jgen.dataset("osm", jax.random.PRNGKey(3), 200))
    return TServer.from_method("bsp", full, PAYLOAD, TConfig(slack=64),
                               device="cpu")


def test_delete_unknown_id_raises(small_server):
    with pytest.raises(ValueError, match=r"delete of unknown id\(s\): "
                                         r"999, 1234"):
        small_server.delete(np.array([999, 1234]))
    assert small_server.stats["n"] == 200      # nothing half-applied


def test_delete_repeated_id_in_batch_raises(small_server):
    with pytest.raises(ValueError, match=r"delete batch repeats "
                                         r"id\(s\): 5"):
        small_server.delete(np.array([5, 7, 5]))
    assert small_server.stats["n"] == 200


def test_double_delete_raises(small_server):
    small_server.delete(np.array([42]))
    with pytest.raises(ValueError, match=r"delete of already-deleted "
                                         r"id\(s\): 42"):
        small_server.delete(np.array([42]))
    assert small_server.stats["n"] == 199


def test_update_unknown_and_mismatch_raise(small_server):
    with pytest.raises(ValueError, match=r"update of unknown id\(s\)"):
        small_server.update(np.array([10 ** 6]),
                            np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="length mismatch"):
        small_server.update(np.array([1, 2]), np.zeros((3, 4), np.float32))


def test_long_id_lists_are_cut_in_errors(small_server):
    with pytest.raises(ValueError, match=r"unknown id\(s\): 1000, 1001, "
                                         r"1002, 1003, 1004, 1005, 1006, "
                                         r"1007, \.\.\. \(9 total\)"):
        small_server.delete(np.arange(1000, 1009))


# -- slot reuse and the scatter's cost --------------------------------------

def test_deleted_slots_reused_before_slack():
    """Dead canonical slots opened by deletes are refilled by later
    appends before any fresh slack: delete/append churn holds the fill
    frontier (and so the overflow re-stage) flat, as repro's does."""
    js, ts = _servers("bsp", "osm", 5, slack=64, compact_dead_frac=None)
    ts.tiles._ensure_mirror()
    fill0 = int(ts.tiles._fill.sum())
    rng = np.random.default_rng(17)
    live = np.arange(N_BASE)
    for _ in range(6):
        ids = rng.choice(live, size=40, replace=False)
        live = np.setdiff1d(live, ids)
        _assert_same_state(js, ts, js.delete(ids), ts.delete(ids), False)
        assert ts.tiles._n_free.sum() > 0         # slots opened for reuse
        nb = _boxes(rng, 40)
        jrep, trep = js.append(jnp.asarray(nb)), ts.append(nb)
        _assert_same_state(js, ts, jrep, trep, False)
        live = np.concatenate([live, np.arange(trep["n_total"] - 40,
                                               trep["n_total"])])
    # 240 inserted copies against 240 freed slots: without reuse the
    # frontier would march >= 240 slots
    assert int(ts.tiles._fill.sum()) - fill0 <= 120
    assert ts.stats["restages"] == 0


def test_append_transfers_touched_cells_not_layout():
    """An append's and a delete's device upload is a sliver of the
    staged member data (repro's bound: under 1/20)."""
    full = np.array(jgen.dataset("osm", jax.random.PRNGKey(4), 3000))
    srv = TServer.from_method("str", full, 100, TConfig(slack=128),
                              device="cpu")
    staged = srv.layout.canon_tiles.numel() * 4
    rep = srv.append(_boxes(np.random.default_rng(0), 10))
    assert not rep["restaged"]
    assert 0 < rep["bytes_transferred"] < staged / 20
    rep = srv.delete(np.arange(10))
    assert 0 < rep["bytes_transferred"] < staged / 20
