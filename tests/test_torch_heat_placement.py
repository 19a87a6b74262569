"""repro_torch's heat-aware placement against repro's with ``mesh=None``
(the owners simulated on one device), at ``tests/test_heat_placement.py``'s
sizes (N = 1200, NQ = 24, K = 4, 4 shards, ``replicate_top`` 2), repro's
data and ``Partitioning`` carried across and every query stream made
with numpy: ``_plan_replicas`` on seeded owners, scores and
co-occurrence; the ``"heat"`` server's owner, local and replica maps,
shards, stats and rebalance reports, and its counts, id lists and kNN
(ids, ``d2`` bit for bit, flags, stats), routed before and after a
rebalance on all six layouts for osm and on bsp and slc for pi, dense
on bsp; the ``"sharded"`` server's rebalance; ``rebalance_every``; the
memory bound; an ingest stream through the replicas with a forced
compaction and an overflow re-stage, each replica row's extent equal to
its primary's after every command; and every routed candidate resolving
to exactly one resident copy.  repro's side of the heat-server and
ingest cases runs first, every case's in threads (``torch_refs``), its
state copied after each step; the port's then replays the steps.
Tolerance: exact equality throughout."""
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
from repro.query import knn as jknn, range as jrange
from repro.serve import (PlacementPolicy as JPolicy, ServeConfig as JConfig,
                         SpatialServer as JServer)
from repro.serve import layout as jlayout
from repro_torch.core.partition import api as tapi
from repro_torch.kernels.range_probe import ops as tops
from repro_torch.serve import HeatSharded, PlacementPolicy
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve import layout as tlayout
from torch_refs import References

torch.set_num_threads(1)
LAYOUTS = ["hc", "str", "fg", "bsp", "slc", "bos"]
N, NQ, K, SHARDS, TOP, PAYLOAD = 1200, 24, 4, 4, 2, 120
SHARD_FIELDS = ("canon_shards", "id_shards", "alive_shards", "chunk_shards",
                "probe_boxes", "chunk_boxes", "uni")
REPORT_KEYS = ("placement", "moved_tiles", "replicated_tiles", "cut_before",
               "cut_after", "bytes_transferred")


def _hot_qboxes(seed, q, frac=0.8):
    """``tests/test_heat_placement.py``'s skewed stream drawn with numpy:
    most centres in one 0.2-wide patch with larger boxes, the rest
    uniform."""
    rng = np.random.default_rng(seed)
    n_hot = int(q * frac)
    ctr = rng.random(2) * 0.6 + 0.2
    c = np.concatenate([ctr + (rng.random((n_hot, 2)) - 0.5) * 0.2,
                        rng.random((q - n_hot, 2))])
    s = rng.random((q, 2)) * 0.05
    s[:n_hot] += 0.08
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


def _pts(seed, q):
    return np.random.default_rng(seed).random((q, 2)).astype(np.float32)


def _cfg(placement="heat", top=TOP, every=None, shards=SHARDS, **kw):
    """repro's config and the port's, the same fields."""
    pol = dict(heat_decay=0.9, replicate_top=top, rebalance_every=every)
    return (JConfig(placement=placement, shards=shards,
                    policy=JPolicy(**pol), **kw),
            TConfig(placement=placement, shards=shards,
                    policy=PlacementPolicy(**pol), **kw))


@functools.cache
def _data(dataset):
    return np.array(jgen.dataset(dataset, jax.random.PRNGKey(0), N))


def _jserver(dataset, method, placement="heat", every=None, **kw):
    """repro's server and its partitioning's boxes and flags."""
    data = _data(dataset)
    jparts = japi.partition(method, jnp.asarray(data), PAYLOAD)
    jc, _ = _cfg(placement, every=every, **kw)
    return (JServer(jparts, jnp.asarray(data), jc, method=method),
            (np.asarray(jparts.boxes), np.asarray(jparts.valid)))


def _tserver(dataset, method, parts, placement="heat", every=None, **kw):
    """The port's server on repro's data and partitioning (``parts``)."""
    tparts = tapi.Partitioning.from_numpy(*parts, "cpu")
    _, tc = _cfg(placement, every=every, **kw)
    return TServer(tparts, _data(dataset), tc, device="cpu", method=method)


def _pair(dataset, method, placement="heat", every=None, **kw):
    """repro's server and the port's on repro's data and partitioning."""
    js, parts = _jserver(dataset, method, placement, every, **kw)
    return js, _tserver(dataset, method, parts, placement, every, **kw)


def _assert_replicas(ts):
    """Every replica row is its primary's row bit for bit: boxes, ids,
    alive, chunk boxes and the live extent."""
    s = ts.slayout
    reps = np.flatnonzero(s.rep_owner >= 0)
    ext = ts.tiles.extent
    for name in ("canon_shards", "id_shards", "alive_shards",
                 "chunk_shards"):
        a = getattr(s, name)
        if a is None:
            continue
        assert torch.equal(a[s.rep_owner[reps], s.rep_local[reps]],
                           a[s.owner[reps], s.local[reps]]), name
    assert torch.equal(ext[s.rep_owner[reps], s.rep_local[reps]],
                       ext[s.owner[reps], s.local[reps]])
    return reps.size


MAPS = ("owner", "local", "rep_owner", "rep_local")


def _copy(v):
    return None if v is None else np.array(v)


def _placement(js) -> dict:
    """repro's maps, replica maps, shards, stats and resident bytes,
    copied."""
    w = js.slayout
    return dict(maps={n: _copy(getattr(w, n)) for n in MAPS},
                shards={n: _copy(getattr(w, n)) for n in SHARD_FIELDS},
                stats=copy.deepcopy(js.stats),
                resident=js.resident_tile_bytes())


def _assert_same_placement(want, ts):
    """Maps, replica maps, shards, stats and the extent equal repro's
    (``want``, a ``_placement``)."""
    s = ts.slayout
    for name in MAPS:
        w = want["maps"][name]
        if w is None:
            assert getattr(s, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(s, name), w,
                                          err_msg=name)
    for name in SHARD_FIELDS:
        got, w = getattr(s, name), want["shards"][name]
        if w is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert ts.stats == want["stats"]
    assert ts.resident_tile_bytes() == want["resident"]
    ext = ts.tiles.extent
    assert torch.equal(ext, tops.live_extent(
        s.alive_shards.flatten(0, 1)).view(ext.shape))
    if s.rep_owner is not None:
        _assert_replicas(ts)


def _copied(answer):
    """An answer's arrays as numpy, its stats copied."""
    return tuple(copy.deepcopy(a) if isinstance(a, dict) else np.array(a)
                 for a in answer)


def _answers(js, qb, pts, pruned=None, hits=(8, 2048)) -> dict:
    """repro's range counts, id lists at each of ``hits`` and kNN."""
    return dict(counts=_copied(js.range_counts(jnp.asarray(qb),
                                               pruned=pruned)),
                ids=[_copied(js.range_ids(jnp.asarray(qb), max_hits=m,
                                          pruned=pruned)) for m in hits],
                knn=_copied(js.knn(jnp.asarray(pts), K, pruned=pruned)))


def _assert_same_answers(want, ts, qb, pts, pruned=None, hits=(8, 2048)):
    """The port's answers equal repro's (``want``, an ``_answers`` of the
    same arguments)."""
    got, stats = ts.range_counts(qb, pruned=pruned)
    np.testing.assert_array_equal(got.numpy(), want["counts"][0])
    assert stats == want["counts"][1]
    for max_hits, w_ids in zip(hits, want["ids"]):
        got = ts.range_ids(qb, max_hits=max_hits, pruned=pruned)
        for g, w in zip(got[:3], w_ids[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[3] == w_ids[3]
    got = ts.knn(pts, K, pruned=pruned)
    for g, w in zip(got[:3], want["knn"][:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[3] == want["knn"][3]
    return got


# -- the replica planner ---------------------------------------------------------

@pytest.mark.parametrize("t,d,top", [(12, 4, 3), (37, 3, 5), (64, 4, 64),
                                     (9, 2, 1), (200, 8, 16)])
@pytest.mark.parametrize("with_cooc", [False, True])
def test_plan_replicas_matches_repro(t, d, top, with_cooc):
    """Seeded owners, scores (with ties) and co-occurrence: the same
    replica owners and rows as repro's planner."""
    rng = np.random.default_rng(t * 31 + d * 7 + top)
    owner = rng.integers(0, d, t).astype(np.int32)
    score = np.floor(rng.pareto(1.0, t) * 4)       # ties in the ranking
    cooc = None
    if with_cooc:
        cooc = np.floor(rng.random((t, t)) * 3) * (rng.random((t, t)) < 0.2)
    t_local = -(-t // d)
    got = tlayout._plan_replicas(owner, score, t_local, d, top, cooc=cooc)
    want = jlayout._plan_replicas(owner, score, t_local, d, top, cooc=cooc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.bincount(got[0][got[0] >= 0], minlength=d).max(
        initial=0) <= top
    assert not np.any(got[0] == owner)


# -- the heat server against repro's -------------------------------------------

HEAT_CASES = [("osm", m) for m in LAYOUTS] + [("pi", "bsp"), ("pi", "slc")]


@pytest.mark.parametrize("dataset,method", HEAT_CASES)
def test_heat_server_matches_repro_through_a_rebalance(dataset, method):
    """Cold (replicas by member counts), then rebalanced on three hot
    batches' heat: maps, shards, stats, the report and every routed and
    dense answer equal repro's; the routed answers equal the brute
    force."""
    want = REFS["heat", dataset, method]
    ts = _tserver(dataset, method, want["parts"])
    assert isinstance(ts.tiles, HeatSharded) and ts.tiles.mode == "heat"
    qb, pts = _hot_qboxes(1, NQ), _pts(2, NQ)
    data = _data(dataset)
    ref = jrange.range_query_ref(data, qb)
    ref_ids, _ = jknn.knn_ref(data, pts, K)
    for round_ in range(2):
        _assert_same_placement(want["placement"][round_], ts)
        got = _assert_same_answers(want["answers"][round_], ts, qb, pts,
                                   hits=((8,), (2048,))[round_])
        assert got[3]["mode"] == "heat"
        np.testing.assert_array_equal(got[0].numpy()[~got[2].numpy()],
                                      ref_ids[~got[2].numpy()])
        counts, stats = ts.range_counts(qb)
        assert [int(c) for c in counts] == [len(r) for r in ref]
        assert stats["mode"] == "heat"
        if round_ == 0:
            if method == "bsp":       # the dense oracle of a heat server
                _assert_same_answers(want["dense"], ts, qb, pts,
                                     pruned=False, hits=(8,))
            got = ts.rebalance()
            assert got == want["report"] and set(got) == set(REPORT_KEYS)
            assert ts.rebalance_s.keys() >= {"snapshot_s", "stage_s",
                                              "plan_s", "scatter_s"}
    assert ts._batches_since_rebalance == want["batches"]


def _heat_reference(dataset, method):
    """repro's side of ``test_heat_server_matches_repro_through_a_rebalance``:
    each round's placement and answers, the dense oracle's (bsp) and
    the rebalance's report between them."""
    js, parts = _jserver(dataset, method)
    qb, pts = _hot_qboxes(1, NQ), _pts(2, NQ)
    out = dict(parts=parts, placement=[], answers=[])
    for round_ in range(2):
        out["placement"].append(_placement(js))
        out["answers"].append(_answers(js, qb, pts,
                                       hits=((8,), (2048,))[round_]))
        js.range_counts(jnp.asarray(qb))
        if round_ == 0:
            if method == "bsp":
                out["dense"] = _answers(js, qb, pts, pruned=False, hits=(8,))
            out["report"] = copy.deepcopy(js.rebalance())
    out["batches"] = js._batches_since_rebalance
    return out


@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_sharded_rebalance_matches_repro(method):
    """The count-balanced placement re-planned on heat co-locates
    without replicas: the same owners, cut and report as repro's, the
    answers unchanged."""
    js, ts = _pair("osm", method, placement="sharded")
    qb, pts = _hot_qboxes(3, NQ), _pts(4, NQ)
    before = ts.range_counts(qb)[0]
    js.range_counts(jnp.asarray(qb))
    for _ in range(2):
        js.range_counts(jnp.asarray(qb))
        ts.range_counts(qb)
    want, got = js.rebalance(), ts.rebalance()
    assert got == want and got["replicated_tiles"] == 0
    assert got["cut_after"] <= got["cut_before"]
    assert ts.slayout.rep_owner is None
    _assert_same_placement(_placement(js), ts)
    assert torch.equal(ts.range_counts(qb)[0], before)
    js.range_counts(jnp.asarray(qb))
    _assert_same_answers(_answers(js, qb, pts), ts, qb, pts)


def test_rebalance_every_matches_repro():
    """``rebalance_every=2``: a counts batch and a kNN batch each count
    as one observed batch, and the rebalance they trigger runs before
    the triggering range batch probes (the batch runs on the new plan)
    -- at every step the maps, stats and answers equal repro's."""
    js, ts = _pair("osm", "bsp", every=2)
    for i in range(5):
        qb, pts = _hot_qboxes(10 + i, NQ), _pts(20 + i, NQ)
        want, wstats = js.range_counts(jnp.asarray(qb))
        got, stats = ts.range_counts(qb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats == wstats
        want = js.knn(jnp.asarray(pts), K)
        got = ts.knn(pts, K)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == want[3]
        assert ts._batches_since_rebalance == js._batches_since_rebalance
        _assert_same_placement(_placement(js), ts)
    assert "moved_tiles" in ts.stats and ts.heat.batches == 10


def test_same_traffic_same_plan():
    """Two port servers fed the same batches rebalance to the same
    placement."""
    qb = _hot_qboxes(1, NQ)
    srvs = [TServer.from_method("bsp", _data("pi"), PAYLOAD, _cfg()[1],
                                device="cpu") for _ in range(2)]
    for srv in srvs:
        for _ in range(3):
            srv.range_counts(qb)
        srv.rebalance()
    a, b = srvs[0].slayout, srvs[1].slayout
    for name in ("owner", "local", "rep_owner", "rep_local"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_one_shard_places_no_replicas():
    """A second owner needs a second device: ``shards=1`` zeroes
    ``replicate_top``, as repro does."""
    js, ts = _pair("osm", "bsp", shards=1)
    assert ts.stats["replicated_tiles"] == 0
    _assert_same_placement(_placement(js), ts)
    assert ts.slayout.id_shards.shape[1] == ts.stats["t"]


# -- the memory bound -------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["osm", "pi"])
def test_heat_memory_bound(dataset):
    """Every owner has exactly ``ceil(T/D) + replicate_top`` shard rows
    on every layout, cold and after a rebalance, and every replica row
    is a copy of its primary."""
    qb = _hot_qboxes(3, NQ)
    for m in LAYOUTS:
        srv = TServer.from_method(m, _data(dataset), PAYLOAD, _cfg()[1],
                                  device="cpu")
        want_rows = -(-srv.stats["t"] // SHARDS) + TOP
        assert srv.slayout.canon_shards.shape[:2] == (SHARDS, want_rows)
        assert 0 < _assert_replicas(srv) <= TOP * SHARDS
        srv.range_counts(qb)
        srv.rebalance()
        assert srv.slayout.canon_shards.shape[:2] == (SHARDS, want_rows)
        assert 0 < _assert_replicas(srv) <= TOP * SHARDS
        assert srv.resident_tile_bytes() * SHARDS == (
            srv.slayout.canon_shards.numel() * 4
            + srv.slayout.id_shards.numel() * 4)


# -- ingest through the replicas -----------------------------------------------

def _ingest_boxes(rng, m, scale=0.05):
    lo = rng.uniform(0.0, 1.0, (m, 2)).astype(np.float32)
    ex = rng.uniform(0.0, scale, (m, 2)).astype(np.float32)
    return np.concatenate([lo, lo + ex], axis=1)


def _check_ingest(want, ts, trep, tight):
    """After a command: the report but ``bytes_transferred``, maps,
    shards, stats and replicas equal repro's (``want``, a
    ``_placement`` with the ``report``); each replica row's extent
    equals its primary's and covers its alive slots."""
    drop = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k != "bytes_transferred"}
    assert drop(trep) == drop(want["report"])
    s = ts.slayout
    for name in MAPS:
        np.testing.assert_array_equal(getattr(s, name), want["maps"][name])
    for name in SHARD_FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      want["shards"][name], err_msg=name)
    assert ts.stats == want["stats"]
    assert _assert_replicas(ts) > 0
    ext = ts.tiles.extent
    live = tops.live_extent(s.alive_shards.flatten(0, 1)).view(ext.shape)
    assert bool((ext >= live).all())
    if tight:
        assert torch.equal(ext, live)


INGEST_STREAM = [("append", 40), ("delete", 25), ("update", 10),
                 ("compact",), ("burst",), ("delete", 30), ("append", 20)]
INGEST_CFG = dict(slack=64, compact_dead_frac=None)


def _ingest_reference(dataset):
    """repro's side of ``test_ingest_through_replicas_with_forced_compaction``:
    the rebalance's report, each command's inputs (drawn with numpy)
    and repro's state after it, and the answers after the stream."""
    js, parts = _jserver(dataset, "bsp", **INGEST_CFG)
    qb = _hot_qboxes(1, NQ)
    for _ in range(3):
        js.range_counts(jnp.asarray(qb))
    report = copy.deepcopy(js.rebalance())
    rng = np.random.default_rng(1)
    live = set(range(N))
    steps = []
    for op in INGEST_STREAM:
        kind = op[0]
        if kind == "append":
            args = (_ingest_boxes(rng, op[1]),)
        elif kind == "burst":
            tb = np.asarray(js.parts.boxes)[0]
            ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
            args = (np.tile(np.asarray(ctr + ctr, np.float32),
                            (js.stats["cap"] + 1, 1)),)
        elif kind == "delete":
            args = (rng.choice(np.array(sorted(live)), op[1],
                               replace=False),)
        elif kind == "update":
            ids = rng.choice(np.array(sorted(live)), op[1], replace=False)
            args = (ids, _ingest_boxes(rng, op[1]))
        else:
            args = ()
        if kind in ("append", "burst"):
            jrep = js.append(jnp.asarray(args[0]))
            n0 = jrep["n_total"] - args[0].shape[0]
            live |= set(range(n0, jrep["n_total"]))
        elif kind == "delete":
            jrep = js.delete(args[0])
            live -= set(args[0].tolist())
        elif kind == "update":
            jrep = js.update(args[0], jnp.asarray(args[1]))
        else:
            jrep = js.compact()
        steps.append((kind, args, dict(_placement(js),
                                       report=copy.deepcopy(jrep))))
    return dict(parts=parts, rebalance=report, steps=steps,
                answers=_answers(js, qb, _pts(2, NQ)))


@pytest.mark.parametrize("dataset", ["osm", "pi"])
def test_ingest_through_replicas_with_forced_compaction(dataset):
    """After a rebalance on hot traffic: appends, deletes, an update, a
    forced compaction, an overflow burst that re-stages (re-planning on
    the stored heat) and churn after it; every write fans out to the
    replica rows.  Then the answers equal repro's and the brute force of
    the surviving set."""
    want = REFS["ingest", dataset]
    ts = _tserver(dataset, "bsp", want["parts"], **INGEST_CFG)
    qb = _hot_qboxes(1, NQ)
    for _ in range(3):
        ts.range_counts(qb)
    got = ts.rebalance()
    assert got == want["rebalance"] and got["replicated_tiles"] > 0
    live = {i: _data(dataset)[i] for i in range(N)}
    for kind, args, w in want["steps"]:
        if kind in ("append", "burst"):
            nb = args[0]
            trep = ts.append(nb)
            assert trep["restaged"] == (kind == "burst")
            n0 = trep["n_total"] - nb.shape[0]
            live.update({n0 + i: nb[i] for i in range(nb.shape[0])})
        elif kind == "delete":
            trep = ts.delete(args[0])
            for i in args[0]:
                del live[int(i)]
        elif kind == "update":
            ids, nb = args
            trep = ts.update(ids, nb)
            live.update({int(i): nb[j] for j, i in enumerate(ids)})
        else:
            trep = ts.compact()
            assert trep["compacted_tiles"] > 0
        _check_ingest(w, ts, trep, kind == "compact" or trep["restaged"])
    assert ts.stats["restages"] == 1
    ids_live = np.array(sorted(live))
    boxes_live = np.stack([live[i] for i in ids_live])
    ref = jrange.range_query_ref(boxes_live, qb)
    got = _assert_same_answers(want["answers"], ts, qb, _pts(2, NQ))
    hit_ids, _, ovf, _ = ts.range_ids(qb, max_hits=2048)
    assert not ovf.any() and got[3]["mode"] == "heat"
    for qi, rows in enumerate(ref):
        row = hit_ids[qi].numpy()
        np.testing.assert_array_equal(np.sort(row[row >= 0]),
                                      np.sort(ids_live[rows]))


REFS = References({
    **{("heat", d, m): functools.partial(_heat_reference, d, m)
       for d, m in HEAT_CASES},
    **{("ingest", d): functools.partial(_ingest_reference, d)
       for d in ("osm", "pi")},
})


# -- routing to one resident copy -----------------------------------------------

@pytest.mark.parametrize("method", ["slc", "bsp"])
def test_replicas_route_to_one_resident_copy(method):
    """Every candidate of a routed batch resolves to exactly one
    (owner, row) that holds the tile, primary or replica, and each
    query's candidates are covered once; the split's stats equal
    repro's on the same batch."""
    js, ts = _pair("osm", method)
    qb = _hot_qboxes(1, NQ)
    for _ in range(3):
        js.range_counts(jnp.asarray(qb))
        ts.range_counts(qb)
    js.rebalance()
    ts.rebalance()
    s = ts.slayout
    assert np.any(s.rep_owner >= 0)
    cand, costs, _ = ts._route_batch(torch.from_numpy(qb))
    slots, ss, sc, xstats = ts.tiles._exchange_plan(cand, costs)
    jcand, jcosts, _ = js._route_batch(jnp.asarray(qb))
    _, _, _, wstats = js.tiles._exchange_plan(np.asarray(jcand), jcosts)
    assert xstats == wstats
    cand, ss, sc = cand.numpy(), ss.numpy(), sc.numpy()
    inv = {(int(o), int(lt)): t for t, (o, lt) in enumerate(zip(s.owner,
                                                               s.local))}
    for t in np.flatnonzero(s.rep_owner >= 0):
        inv[(int(s.rep_owner[t]), int(s.rep_local[t]))] = int(t)
    got = {q: [] for q in range(cand.shape[0])}
    for h in range(ss.shape[0]):
        for o in range(ss.shape[1]):
            for mi in range(ss.shape[2]):
                if ss[h, o, mi] < 0:
                    continue
                lts = sc[h, o, mi]
                got[int(slots[h, ss[h, o, mi]])].extend(
                    inv[(o, int(lt))] for lt in lts[lts >= 0])
    for q in range(cand.shape[0]):
        assert sorted(got[q]) == sorted(cand[q][cand[q] >= 0].tolist()), q
    assert xstats["probe_load_imbalance"] >= 1.0
    assert xstats["routed_alt"] >= 0
