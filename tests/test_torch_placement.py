"""repro_torch's placement and exchange pieces against repro's on the
same seeded numpy inputs: the capped LPT packer (and its infeasible
raise), tile sharding (the ``ceil(T/D)`` cap, the moved-tile count),
the co-locating planner, query packing, the packed-row scatter and its
inverse (numpy and tensors), ``owner_split`` (with and without replica
tables), the three owner merges (one home, and every home at once
against a loop over homes), the kNN packing weight, and the balance
shim.  Tolerance: exact equality throughout (float64 makespans
included)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement as jplace
from repro.query import knn as jknn, range as jrange
from repro.serve import layout as jlayout, router as jrouter
from repro_torch.core import placement as tplace
from repro_torch.query import balance as tbalance
from repro_torch.query import knn as tknn, range as trange
from repro_torch.serve import layout as tlayout, router as trouter

torch.set_num_threads(1)


def _costs(kind, t, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(t)
    if kind == "heavy":
        return np.r_[1e9, np.zeros(t - 1)]
    if kind == "ties":
        return rng.integers(0, 3, t).astype(np.float64)
    return rng.pareto(1.0, t)


# -- the packers -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pareto", "zeros", "heavy", "ties"])
@pytest.mark.parametrize("t,d", [(16, 4), (17, 4), (9, 8), (11, 3), (5, 5)])
def test_lpt_pack_capped_matches_repro(kind, t, d):
    costs = _costs(kind, t, t * d)
    cap = -(-t // d)
    got = tplace.lpt_pack_capped(costs, d, cap)
    want = jplace.lpt_pack_capped(costs, d, cap)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert np.bincount(got[0], minlength=d).max() <= cap


def test_lpt_pack_capped_infeasible_raises():
    with pytest.raises(ValueError, match="cannot place 9 items on 2 "
                                         "devices with cap 4"):
        tplace.lpt_pack_capped(np.ones(9), 2, 4)


@pytest.mark.parametrize("kind", ["pareto", "zeros", "heavy", "ties"])
@pytest.mark.parametrize("t,d", [(11, 4), (24, 4), (13, 5), (7, 1)])
def test_shard_tiles_matches_repro(kind, t, d):
    costs = _costs(kind, t, t + d)
    prev = np.random.default_rng(t).integers(0, d, t).astype(np.int32)
    for kw in ({}, {"prev_owner": prev}):
        owner, local, t_local, stats = tplace.shard_tiles(costs, d, **kw)
        w = jplace.shard_tiles(costs, d, **kw)
        np.testing.assert_array_equal(owner, w[0])
        np.testing.assert_array_equal(local, w[1])
        assert owner.dtype == w[0].dtype and local.dtype == w[1].dtype
        assert t_local == w[2] == -(-t // d)
        assert stats == w[3]
        assert ("moved" in stats) == ("prev_owner" in kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colocate_tiles_matches_repro(seed):
    rng = np.random.default_rng(seed)
    t, d = 14, 4
    costs = rng.pareto(1.5, t)
    cooc = rng.poisson(0.6, (t, t)).astype(np.float64)
    prev = tplace.lpt_pack_capped(costs, d, -(-t // d))[0]
    for kw in ({}, {"prev_owner": prev}):
        got = tplace.colocate_tiles(costs, cooc, d, -(-t // d), **kw)
        want = jplace.colocate_tiles(costs, cooc, d, -(-t // d), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    got = tplace.shard_tiles(costs, d, cooc=cooc)
    want = jplace.shard_tiles(costs, d, cooc=cooc)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[3] == want[3]


def test_balance_shim_reexports_placement():
    for name in ("lpt_pack", "lpt_pack_capped", "round_robin_pack",
                 "shard_tiles", "tile_costs"):
        assert getattr(tbalance, name) is getattr(tplace, name)


# -- query packing ------------------------------------------------------------

@pytest.mark.parametrize("q,d,kind", [(1, 1, "pareto"), (7, 3, "ties"),
                                      (64, 8, "pareto"), (10, 4, "zeros"),
                                      (5, 8, "pareto"), (33, 5, "ties")])
def test_pack_queries_matches_repro(q, d, kind):
    costs = _costs(kind, q, q + d)
    slots, stats = tlayout.pack_queries(costs, d)
    want, wstats = jlayout.pack_queries(costs, d)
    np.testing.assert_array_equal(slots, want)
    assert slots.dtype == want.dtype and stats == wstats


@pytest.mark.parametrize("tail", [(), (4,), (3, 2)])
def test_pack_and_unpack_rows_match_repro(tail):
    rng = np.random.default_rng(len(tail))
    q, d = 13, 4
    slots, _ = jlayout.pack_queries(rng.random(q), d)
    arr = rng.random((q,) + tail).astype(np.float32)
    pad = np.full(tail, -7.0, np.float32)
    want = jlayout._pack_rows(arr, slots, pad)
    np.testing.assert_array_equal(tlayout._pack_rows(arr, slots, pad), want)
    got_t = tlayout._pack_rows(torch.from_numpy(arr), slots, pad)
    np.testing.assert_array_equal(got_t.numpy(), want)
    back = jlayout._unpack_rows(want, slots, q)
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(tlayout._unpack_rows(want, slots, q), back)
    np.testing.assert_array_equal(
        tlayout._unpack_rows(got_t, slots, q).numpy(), back)


@pytest.mark.parametrize("k,n", [(1, 1), (4, 1200), (10, 8_000_000),
                                 (3, 401)])
def test_knn_cost_proxy_matches_repro(k, n):
    rng = np.random.default_rng(k)
    uni = np.array([-0.013, 0.002, 1.007, 0.9991], np.float32)
    dist = (rng.random((9, 12)) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        tlayout._knn_cost_proxy(uni, n, torch.from_numpy(dist), k),
        jlayout._knn_cost_proxy(uni, n, jnp.asarray(dist), k))


# -- owner_split ---------------------------------------------------------------

def _split_inputs(seed, t=23, d=4, q=30, f=6):
    rng = np.random.default_rng(seed)
    owner, local, _, _ = jplace.shard_tiles(rng.pareto(1.0, t), d)
    cand = np.full((q, f), -1, np.int32)
    for i in range(q):
        n = rng.integers(0, f + 1)
        cand[i, :n] = np.sort(rng.choice(t, n, replace=False))
    slots, _ = jlayout.pack_queries((cand >= 0).sum(1).astype(float), d)
    return cand, slots, owner, local, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_split_matches_repro(seed):
    cand, slots, owner, local, _ = _split_inputs(seed)
    got = trouter.owner_split(cand, slots, owner, local)
    want = jrouter.owner_split(cand, slots, owner, local)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[2] == want[2]


@pytest.mark.parametrize("seed", [3, 4])
def test_owner_split_with_replica_tables_matches_repro(seed):
    cand, slots, owner, local, rng = _split_inputs(seed)
    t, d = owner.shape[0], 4
    alt_owner = np.full(t, -1, np.int32)
    alt_local = np.full(t, -1, np.int32)
    hot = rng.choice(t, 6, replace=False)
    alt_owner[hot] = (owner[hot] + 1 + rng.integers(0, d - 1, 6)) % d
    alt_local[hot] = 6 + np.arange(6)
    got = trouter.owner_split(cand, slots, owner, local, alt_owner=alt_owner,
                              alt_local=alt_local)
    want = jrouter.owner_split(cand, slots, owner, local, alt_owner=alt_owner,
                               alt_local=alt_local)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] and got[2]["routed_alt"] > 0


# -- the owner merges -----------------------------------------------------------

def _messages(rng, d, m, qpd):
    """(D, M) message slots: each owner's column names distinct home
    slots (a query reaches each owner at most once), -1 padded."""
    sl = np.full((d, m), -1, np.int32)
    for o in range(d):
        n = rng.integers(0, min(m, qpd) + 1)
        sl[o, :n] = rng.choice(qpd, n, replace=False)
    return sl


def _id_partials(rng, sl, mh, qpd):
    """Per-owner ascending id lists, owner-disjoint per query, some
    longer than ``mh`` (truncated, true counts kept)."""
    d, m = sl.shape
    pids = np.full((d, m, mh), -1, np.int32)
    pcounts = np.zeros((d, m), np.int32)
    pool = {s: rng.permutation(500)[:60] + 1000 * s for s in range(qpd)}
    for o in range(d):
        for j in range(m):
            s = sl[o, j]
            if s < 0:
                continue
            n = rng.integers(0, mh + 3)
            mine = np.sort(pool[s][o * 15:o * 15 + n])
            pcounts[o, j] = mine.size
            pids[o, j, :min(mh, mine.size)] = mine[:mh]
    return pids, pcounts


def _knn_partials(rng, sl, k):
    """Per-owner top-k rows sorted by (d2, id), -1/+inf padded, with
    distance ties across owners."""
    d, m = sl.shape
    pids = np.full((d, m, k), -1, np.int32)
    pd2 = np.full((d, m, k), np.inf, np.float32)
    for o in range(d):
        for j in range(m):
            n = rng.integers(0, k + 1)
            ids = rng.choice(100, n, replace=False) * d + o
            d2 = rng.integers(0, 4, n).astype(np.float32) * np.float32(0.25)
            order = np.lexsort((ids, d2))
            pids[o, j, :n], pd2[o, j, :n] = ids[order], d2[order]
    return pids, pd2


@pytest.mark.parametrize("seed", range(4))
def test_merge_owner_counts_matches_repro(seed):
    rng = np.random.default_rng(seed)
    d, m, qpd = 4, 7, 9
    sl = _messages(rng, d, m, qpd)
    part = rng.integers(0, 50, (d, m)).astype(np.int32)
    want = np.asarray(jrange.merge_owner_counts(jnp.asarray(part),
                                                jnp.asarray(sl), qpd))
    got = trange.merge_owner_counts(torch.from_numpy(part),
                                    torch.from_numpy(sl), qpd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_hits", [4, 16, 200])
@pytest.mark.parametrize("seed", range(3))
def test_merge_owner_ids_matches_repro(seed, max_hits):
    rng = np.random.default_rng(seed)
    d, m, qpd, mh = 4, 6, 8, min(max_hits, 12)
    sl = _messages(rng, d, m, qpd)
    pids, pcounts = _id_partials(rng, sl, mh, qpd)
    want = jrange.merge_owner_ids(jnp.asarray(pids), jnp.asarray(pcounts),
                                  jnp.asarray(sl), qpd, max_hits)
    got = trange.merge_owner_ids(torch.from_numpy(pids),
                                 torch.from_numpy(pcounts),
                                 torch.from_numpy(sl), qpd, max_hits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("seed", range(3))
def test_merge_knn_partials_matches_repro(seed, k):
    rng = np.random.default_rng(seed + 10 * k)
    d, m, qpd = 4, 6, 7
    sl = _messages(rng, d, m, qpd)
    pids, pd2 = _knn_partials(rng, sl, k)
    want = jknn.merge_knn_partials(jnp.asarray(pids), jnp.asarray(pd2),
                                   jnp.asarray(sl), qpd, k)
    got = tknn.merge_knn_partials(torch.from_numpy(pids),
                                  torch.from_numpy(pd2),
                                  torch.from_numpy(sl), qpd, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merges_of_every_home_at_once_equal_a_loop_over_homes():
    """The exchange merges all D homes in one call (leading home axis):
    the same bits as one call a home."""
    rng = np.random.default_rng(5)
    d, m, qpd, k, mh = 4, 6, 8, 3, 5
    sl = np.stack([_messages(rng, d, m, qpd) for _ in range(d)])
    part = rng.integers(0, 9, (d, d, m)).astype(np.int32)
    ids = [_id_partials(rng, sl[h], mh, qpd) for h in range(d)]
    knn = [_knn_partials(rng, sl[h], k) for h in range(d)]
    t = torch.from_numpy
    counts = trange.merge_owner_counts(t(part), t(sl), qpd)
    hid = trange.merge_owner_ids(t(np.stack([a for a, _ in ids])),
                                 t(np.stack([b for _, b in ids])), t(sl),
                                 qpd, 7)
    nn = tknn.merge_knn_partials(t(np.stack([a for a, _ in knn])),
                                 t(np.stack([b for _, b in knn])), t(sl),
                                 qpd, k)
    for h in range(d):
        one = trange.merge_owner_counts(t(part[h]), t(sl[h]), qpd)
        assert torch.equal(counts[h], one)
        one = trange.merge_owner_ids(t(ids[h][0]), t(ids[h][1]), t(sl[h]),
                                     qpd, 7)
        assert all(torch.equal(a[h], b) for a, b in zip(hid, one))
        one = tknn.merge_knn_partials(t(knn[h][0]), t(knn[h][1]), t(sl[h]),
                                      qpd, k)
        assert all(torch.equal(a[h], b) for a, b in zip(nn, one))
