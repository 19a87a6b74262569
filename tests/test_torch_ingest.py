"""repro_torch's ingest lifecycle (``append``, ``delete``, ``update``,
``compact``, the compaction policy and the overflow re-stage) against
repro's, the two servers driven through the same commands on the same
inputs: repro's data and ``Partitioning`` carried across, the
commands' objects and ids drawn with numpy.  repro's server runs its
stream first (every case's in threads, ``torch_refs``) and its state
is copied after each command; the port's then replays the commands.
After every command the
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

import copy
import functools

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
from torch_refs import References

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


def _jserver(method, dataset, seed, **cfg):
    """repro's data, partitioning and server."""
    full = np.array(jgen.dataset(dataset, jax.random.PRNGKey(seed), N_BASE))
    jparts = japi.partition(method, jnp.asarray(full), PAYLOAD)
    return full, jparts, JServer(jparts, jnp.asarray(full), JConfig(**cfg))


def _tserver(ref, **cfg):
    """The port's server on repro's data and partitioning (``ref``)."""
    tparts = tapi.Partitioning.from_numpy(ref["boxes"], ref["valid"], "cpu")
    return TServer(tparts, ref["full"], TConfig(**cfg), device="cpu")


def _jcall(js, kind, args):
    if kind in ("append", "burst"):
        return js.append(jnp.asarray(args[0]))
    if kind == "delete":
        return js.delete(args[0])
    if kind == "update":
        return js.update(args[0], jnp.asarray(args[1]))
    return js.compact()


def _tcall(ts, kind, args):
    if kind in ("append", "burst"):
        return ts.append(args[0])
    if kind == "delete":
        return ts.delete(args[0])
    if kind == "update":
        return ts.update(*args)
    return ts.compact()


def _state(js, jrep) -> dict:
    """repro's staging (the shards and owner maps under the sharded
    placement), bookkeeping, report and stats after a command, copied."""
    if js.slayout is None:
        lay, fields = js.layout, LAYOUT_FIELDS
    else:
        lay, fields = js.slayout, SHARD_FIELDS + ("owner", "local")
    return dict(
        sharded=js.slayout is not None,
        layout={n: None if getattr(lay, n) is None
                else np.array(getattr(lay, n)) for n in fields},
        book={n: np.array(getattr(js.tiles, n)) for n in BOOKKEEPING},
        report=copy.deepcopy(jrep), stats=copy.deepcopy(js.stats))


def _assert_same_state(want, ts, trep, tight):
    """The port's staging, bookkeeping, report and stats equal repro's
    (``want``, a ``_state``), and the extent (a tile, or a shard row)
    covers every alive slot."""
    if not want["sharded"]:
        fields, tlay = LAYOUT_FIELDS, ts.layout
        alive = ts.layout.alive
    else:
        fields, tlay = SHARD_FIELDS, ts.slayout
        alive = ts.slayout.alive_shards.flatten(0, 1)
        np.testing.assert_array_equal(tlay.owner, want["layout"]["owner"])
        np.testing.assert_array_equal(tlay.local, want["layout"]["local"])
    for name in fields:
        w, got = want["layout"][name], getattr(tlay, name)
        if w is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    ts.tiles._ensure_mirror()
    for name in BOOKKEEPING:
        np.testing.assert_array_equal(getattr(ts.tiles, name),
                                      want["book"][name], err_msg=name)
    drop = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k != "bytes_transferred"}
    assert drop(trep) == drop(want["report"])
    assert ts.stats == want["stats"]
    ext = ts.tiles.extent
    want = ops.live_extent(alive).view(ext.shape)
    assert bool((ext >= want).all())
    if tight:
        assert torch.equal(ext, want)


def _record(js, commands, seed):
    """repro's server driven through ``commands`` -> each command's
    kind, its inputs (drawn with numpy) and repro's state after it."""
    rng = np.random.default_rng(seed)
    live = set(range(N_BASE))
    steps = []
    for op in commands:
        kind = op[0]
        if kind == "append":
            args = (_boxes(rng, op[1]),)
        elif kind in ("delete", "update"):
            pool = np.array(sorted(live))
            count = (max(1, int(op[1] * len(live))) if kind == "delete"
                     else op[1])
            ids = rng.choice(pool, size=min(count, pool.size - 60),
                             replace=False)
            args = (ids,) if kind == "delete" else (ids,
                                                    _boxes(rng, ids.size))
        elif kind == "compact":
            args = ()
        else:                                        # burst: cap + 1 copies
            tb = np.asarray(js.parts.boxes)[0]
            ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
            args = (np.tile(np.asarray(ctr + ctr, np.float32),
                            (js.stats["cap"] + 1, 1)),)
        jrep = _jcall(js, kind, args)
        if kind in ("append", "burst"):
            m = args[0].shape[0]
            live |= set(range(jrep["n_total"] - m, jrep["n_total"]))
        elif kind == "delete":
            live -= set(args[0].tolist())
        steps.append((kind, args, _state(js, jrep)))
    return steps


def _replay(ts, steps, after=None):
    """The port's server through repro's recorded commands, its state
    held to repro's after each (tightly after a compaction or a
    re-stage); ``after(kind)`` runs after each command's checks."""
    for kind, args, want in steps:
        trep = _tcall(ts, kind, args)
        if kind == "burst":
            assert trep["restaged"]
        _assert_same_state(want, ts, trep, kind == "compact"
                           or want["report"].get("restaged"))
        if after is not None:
            after(kind)


def _answer_queries(seed):
    rng = np.random.default_rng(seed)
    c = rng.random((16, 2)).astype(np.float32)
    return np.concatenate([c - 0.05, c + 0.05], -1)


def _answers(js, seed):
    """repro's range counts and id lists for ``_answer_queries(seed)``."""
    qb = jnp.asarray(_answer_queries(seed))
    return (np.asarray(js.range_counts(qb)[0]),
            np.asarray(js.range_ids(qb, max_hits=256)[0]))


def _assert_same_answers(ref, ts, seed):
    qb = _answer_queries(seed)
    counts, ids = ref["answers"]
    np.testing.assert_array_equal(ts.range_counts(qb)[0].numpy(), counts)
    np.testing.assert_array_equal(ts.range_ids(qb, max_hits=256)[0].numpy(),
                                  ids)


def reference(method, dataset, seed, commands, answers_seed=None, **cfg):
    """repro's side of a stream: its data and partitioning, the
    recorded commands (``_record``), its widths after them and its
    answers to ``answers_seed``'s queries."""
    full, jparts, js = _jserver(method, dataset, seed, **cfg)
    steps = _record(js, commands, seed)
    return dict(full=full, boxes=np.asarray(jparts.boxes),
                valid=np.asarray(jparts.valid), steps=steps,
                widths=(js.widths.cap, dict(js.widths._w)),
                answers=None if answers_seed is None
                else _answers(js, answers_seed))


def _reuse_reference():
    """repro's side of ``test_deleted_slots_reused_before_slack``: six
    deletes of 40 live ids, each followed by 40 appends."""
    full, jparts, js = _jserver("bsp", "osm", 5, slack=64,
                                compact_dead_frac=None)
    rng = np.random.default_rng(17)
    live = np.arange(N_BASE)
    steps = []
    for _ in range(6):
        ids = rng.choice(live, size=40, replace=False)
        live = np.setdiff1d(live, ids)
        steps.append(("delete", (ids,), _state(js, js.delete(ids))))
        nb = _boxes(rng, 40)
        jrep = js.append(jnp.asarray(nb))
        steps.append(("append", (nb,), _state(js, jrep)))
        live = np.concatenate([live, np.arange(jrep["n_total"] - 40,
                                               jrep["n_total"])])
    return dict(full=full, boxes=np.asarray(jparts.boxes),
                valid=np.asarray(jparts.valid), steps=steps)


FIXED_CASES = [("bsp", "osm"), ("hc", "osm"), ("str", "osm"), ("hc", "pi")]
SHORT_CASES = [("hilbert", 256, "bsp", "osm"), ("off", 128, "str", "pi")]


def _short_cfg(local_index, chunk):
    return dict(slack=128, local_index=local_index, chunk=chunk,
                compact_dead_frac=0.25)


REFS = References({
    **{("fixed", m, d): functools.partial(
        reference, m, d, 7, FIXED_STREAM, 8, slack=256)
       for m, d in FIXED_CASES},
    **{("short", li, c, m, d): functools.partial(
        reference, m, d, 9, SHORT_STREAM, 10, **_short_cfg(li, c))
       for li, c, m, d in SHORT_CASES},
    "reuse": _reuse_reference,
})


@pytest.mark.parametrize("method,dataset", FIXED_CASES)
def test_fixed_stream_matches_repro(method, dataset):
    """hc and str do not cover the universe, so their appends exercise
    nearest-tile adoption."""
    ref = REFS["fixed", method, dataset]
    ts = _tserver(ref, slack=256)
    _replay(ts, ref["steps"])
    assert ts.stats["restages"] == 1 and ts.stats["compactions"] >= 1
    assert (ts.widths.cap, ts.widths._w) == ref["widths"]
    _assert_same_answers(ref, ts, 8)


@pytest.mark.parametrize("local_index,chunk,method,dataset", SHORT_CASES)
def test_short_stream_other_local_indexes_match_repro(local_index, chunk,
                                                      method, dataset):
    """Compaction's Hilbert slot order (the encode over the current
    universe; chunk boxes of 256 slots, each stored twice) and its
    unindexed branch, forced and by threshold."""
    ref = REFS["short", local_index, chunk, method, dataset]
    ts = _tserver(ref, **_short_cfg(local_index, chunk))
    _replay(ts, ref["steps"])
    assert ts.stats["compactions"] >= 1
    _assert_same_answers(ref, ts, 10)


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
    ref = REFS["reuse"]
    ts = _tserver(ref, slack=64, compact_dead_frac=None)
    ts.tiles._ensure_mirror()
    fill0 = int(ts.tiles._fill.sum())

    def opened(kind):
        if kind == "delete":
            assert ts.tiles._n_free.sum() > 0     # slots opened for reuse

    _replay(ts, ref["steps"], opened)
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
