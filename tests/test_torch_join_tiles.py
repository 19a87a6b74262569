"""repro_torch's batched join passes (every live tile of a plan at once)
against repro's ``jax.lax.map`` of ``tile_join_count`` (rp and raw) and
``tile_join_pairs`` over the same planned tiles, through the passes'
plain versions (``mbr_join.ref.tile_rp_counts``, ``tile_raw_counts``,
``tile_pair_list``) and the CPU route of ``mbr_join.ops``; the engine's
counts against the per-tile functions and repro's
``run_join_count``: bsp and hc plans of a dense
join, truncation at 1, 37 and more pairs than any tile holds, and
hand-made tiles with boxes on a tile's and on the universe's high edge,
a tile with no R member and live slots with id -1.  The work-item
layout the card's kernels decode is checked against every live (tile,
row, column).  Tolerance: exact equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.query import engine as jengine, join as jjoin
from repro_torch.kernels.mbr_join import kernel as tmk, ops as tmops
from repro_torch.kernels.mbr_join import ref as tmref
from repro_torch.query import engine as tengine

torch.set_num_threads(1)
BIG = 100_000


def _boxes(n, seed, scale):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return np.concatenate([c - s, c + s], -1).astype(np.float32)


def _arrays(plan):
    """One device's (r_tiles, s_tiles, r_ids, s_ids, tile_boxes, uni) as
    numpy, and each tile's live sizes (the prefix of ids >= 0)."""
    rt, st, rid, sid, tb = (np.asarray(a)[0] for a in (
        plan.r_tiles, plan.s_tiles, plan.r_ids, plan.s_ids,
        plan.tile_boxes))
    return (rt, st, rid, sid, tb, np.asarray(plan.universe),
            (rid >= 0).sum(1), (sid >= 0).sum(1))


def _repro_counts(rt, st, tb, uni, dedup="rp"):
    u = jnp.asarray(uni)
    return np.asarray(jax.lax.map(
        lambda a: jjoin.tile_join_count(a[0], a[1], a[2], u, dedup=dedup),
        (jnp.asarray(rt), jnp.asarray(st), jnp.asarray(tb))))


def _repro_pairs(rt, st, rid, sid, tb, uni, max_pairs):
    """The reference's per-tile lists, each cut to its kept pairs and
    concatenated in slot order, and every tile's hit count."""
    u = jnp.asarray(uni)
    pr, ps, n = jax.lax.map(
        lambda a: jjoin.tile_join_pairs(*a, u, max_pairs),
        tuple(jnp.asarray(x) for x in (rt, st, rid, sid, tb)))
    pr, ps, n = np.asarray(pr), np.asarray(ps), np.asarray(n)
    keep = [min(int(k), max_pairs) for k in n]
    return (np.concatenate([pr[j, :k] for j, k in enumerate(keep)]),
            np.concatenate([ps[j, :k] for j, k in enumerate(keep)]), n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module", params=["bsp", "hc"])
def planned(request):
    """repro's plan of a dense join (many pairs a tile), as arrays."""
    r, s = _boxes(600, 10, 0.04), _boxes(500, 11, 0.04)
    return _arrays(jengine.plan_join(request.param, jnp.asarray(r),
                                     jnp.asarray(s), 150, 1))


def test_rp_counts_match_repro_map(planned):
    rt, st, _, _, tb, uni, lr, ls = planned
    want = _repro_counts(rt, st, tb, uni)
    assert want.sum() > 0
    args = _t(rt, st, tb, uni)
    np.testing.assert_array_equal(
        tmref.tile_rp_counts(*args, lr, ls).numpy(), want)
    np.testing.assert_array_equal(
        tmops.tile_rp_counts(*args, lr, ls).numpy(), want)


def test_raw_counts_match_repro_map(planned):
    """The raw count, duplicates included: repro's tile_join_count with
    dedup="none" over every padded tile (the sentinel never matches)."""
    rt, st, _, _, tb, uni, lr, ls = planned
    want = _repro_counts(rt, st, tb, uni, dedup="none")
    assert (want > _repro_counts(rt, st, tb, uni)).any()
    args = _t(rt, st)
    np.testing.assert_array_equal(
        tmref.tile_raw_counts(*args, lr, ls).numpy(), want)
    np.testing.assert_array_equal(
        tmops.tile_raw_counts(*args, lr, ls).numpy(), want)


@pytest.mark.parametrize("max_pairs", [1, 37, BIG])
def test_pair_list_matches_repro_map(planned, max_pairs):
    rt, st, rid, sid, tb, uni, lr, ls = planned
    want = _repro_pairs(rt, st, rid, sid, tb, uni, max_pairs)
    assert want[2].max() > 37
    got = tmops.tile_pair_list(*_t(rt, st, rid, sid), lr, ls, max_pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_row_blocked_loops_match(planned, monkeypatch):
    """The plain versions' tables a few rows at a time: same counts, same
    pairs, same truncation point."""
    rt, st, rid, sid, tb, uni, lr, ls = planned
    want_c = tmref.tile_rp_counts(*_t(rt, st, tb, uni), lr, ls)
    want_r = tmref.tile_raw_counts(*_t(rt, st), lr, ls)
    want_p = tmref.tile_pair_list(*_t(rt, st, rid, sid), lr, ls, 37)
    monkeypatch.setattr(tmref, "TABLE_BYTES", 5 * int(ls.max()))
    assert torch.equal(tmref.tile_rp_counts(*_t(rt, st, tb, uni), lr, ls),
                       want_c)
    assert torch.equal(tmref.tile_raw_counts(*_t(rt, st), lr, ls), want_r)
    np.testing.assert_array_equal(
        want_r.numpy(), _repro_counts(rt, st, tb, uni, dedup="none"))
    for g, w in zip(tmref.tile_pair_list(*_t(rt, st, rid, sid), lr, ls, 37),
                    want_p):
        assert torch.equal(g, w)


def _edge_tiles():
    """Three tiles of the unit square (left half, right half, top) with
    boxes touching x = 0.5 (a tile's high edge: the right tile owns the
    reference point) and x = y = 1 (the universe's: closed), a top tile
    with no R member, and live slots with id -1 on both sides."""
    sent = [9e9, 9e9, -9e9, -9e9]
    tb = np.array([[0, 0, .5, .5], [.5, 0, 1, .5], [0, .5, 1, 1]],
                  np.float32)
    uni = np.array([0, 0, 1, 1], np.float32)
    r = [[[.1, .1, .5, .2], [.4, .1, .5, .3], [.2, .2, .3, .3], sent],
         [[.5, .1, .6, .2], [.9, .4, 1., .5], [.6, .1, .7, .4], [.7, .3,
                                                                .8, .4]],
         [sent] * 4]
    s = [[[.5, .1, .6, .2], [.3, .2, .5, .3], [.1, .1, .2, .2], sent],
         [[.5, .15, .55, .2], [1., .45, 1., .45], [.65, .2, .9, .45], sent],
         [[.1, .6, .2, .7], sent, sent, sent]]
    rid = np.array([[0, 1, 2, -1], [3, 4, -1, 5], [-1] * 4], np.int32)
    sid = np.array([[0, -1, 2, -1], [3, 4, 5, -1], [6, -1, -1, -1]],
                   np.int32)
    lr, ls = np.array([3, 4, 0]), np.array([3, 3, 1])
    return (np.array(r, np.float32), np.array(s, np.float32), rid, sid, tb,
            uni, lr, ls)


@pytest.mark.parametrize("max_pairs", [1, 2, BIG])
def test_edges_empty_tiles_and_negative_ids_match_repro(max_pairs):
    rt, st, rid, sid, tb, uni, lr, ls = _edge_tiles()
    want = _repro_counts(rt, st, tb, uni)
    assert want.tolist() == [5, 5, 0]     # the edge rules decide these
    np.testing.assert_array_equal(
        tmops.tile_rp_counts(*_t(rt, st, tb, uni), lr, ls).numpy(), want)
    want = _repro_pairs(rt, st, rid, sid, tb, uni, max_pairs)
    got = tmops.tile_pair_list(*_t(rt, st, rid, sid), lr, ls, max_pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0] >= 0).all() and (got[1] >= 0).all()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """``ops`` sends CPU tensors to the plain versions; the kernel
    wrappers refuse them rather than fall back."""
    rt, st, rid, sid, tb, uni, lr, ls = _edge_tiles()
    meta = tmk.tile_meta(lr, ls, "cpu", (4, 4))
    with pytest.raises(ValueError, match="cuda"):
        tmk.rp_counts(*_t(rt, st, tb, uni), meta)
    with pytest.raises(ValueError, match="cuda"):
        tmk.raw_counts(*_t(rt, st), meta)
    with pytest.raises(ValueError, match="cuda"):
        tmk.pair_list(*_t(rt, st, rid, sid), meta, 5)

    def launched(*a, **k):
        raise AssertionError("the kernel route took CPU tensors")

    monkeypatch.setattr(tmk, "rp_counts", launched)
    monkeypatch.setattr(tmk, "raw_counts", launched)
    monkeypatch.setattr(tmk, "pair_list", launched)
    tmops.tile_rp_counts(*_t(rt, st, tb, uni), lr, ls)
    tmops.tile_raw_counts(*_t(rt, st), lr, ls)
    tmops.tile_pair_list(*_t(rt, st, rid, sid), lr, ls, 5)


@pytest.mark.parametrize("shape", [(4, 3), (512, 1024), (1, 1)])
def test_work_items_cover_every_live_pair_once(shape):
    """The kernels' decode of the layout (an item's tile by binary search
    of item_start, then its row and column block; a row cell's tile by
    binary search of row_base) visits each live (tile, row, column)
    exactly once and gives every live row of a tile with S members its
    own cell, in slot order."""
    br, bs = shape
    lr = np.array([0, 5, 9, 1, 7, 0, 3])
    ls = np.array([4, 0, 7, 1, 12, 2, 5])
    meta = tmk.tile_meta(lr, ls, "cpu", shape)
    t = len(lr)
    d = meta.data.numpy()
    assert d.shape == (4 * t + 2,)
    np.testing.assert_array_equal(d[:t], lr)
    np.testing.assert_array_equal(d[t:2 * t], ls)
    start, row_base = d[2 * t:3 * t + 1], d[3 * t + 1:]
    seen = np.zeros((t, lr.max(), ls.max()), np.int64)
    for item in range(meta.items):
        j = int(np.searchsorted(start[:t], item, side="right")) - 1
        ncb = -(-ls[j] // bs)
        local = item - start[j]
        r0, c0 = (local // ncb) * br, (local % ncb) * bs
        seen[j, r0:min(lr[j], r0 + br), c0:min(ls[j], c0 + bs)] += 1
    live = (np.arange(lr.max())[None, :, None] < lr[:, None, None]) & (
        np.arange(ls.max())[None, None, :] < ls[:, None, None])
    np.testing.assert_array_equal(seen, live.astype(np.int64))
    cells = [(j, r) for j in range(t) if ls[j] for r in range(lr[j])]
    assert meta.rows == len(cells)
    for gr, (j, r) in enumerate(cells):
        assert int(np.searchsorted(row_base[:t], gr, side="right")) - 1 == j
        assert gr - row_base[j] == r


def test_engine_counts_and_pairs_equal_the_per_tile_path():
    """The engine's batched rp and raw counts and MASJ pair list on a
    port plan equal the per-tile functions it used to loop over, and the
    raw total repro's run_join_count(dedup="none") on repro's plan."""
    from repro_torch.query import join as tjoin
    r, s = _boxes(700, 20, 0.03), _boxes(600, 21, 0.03)
    plan = tengine.plan_join("hc", r, s, 150, 1, device="cpu")
    want = torch.zeros(plan.r_tiles.shape[1], dtype=torch.int64)
    raw = torch.zeros_like(want)
    prs, pss = [], []
    for j, (nr, ns) in enumerate(zip(plan.live_r[0], plan.live_s[0])):
        if not (nr and ns):
            continue
        args = (plan.r_tiles[0, j, :nr], plan.s_tiles[0, j, :ns])
        want[j] = tjoin.tile_join_count(*args, plan.tile_boxes[0, j],
                                        plan.universe)
        raw[j] = tjoin.tile_join_count(*args, plan.tile_boxes[0, j],
                                       plan.universe, dedup="none")
        pr, ps, _ = tjoin.tile_pairs(*args, plan.r_ids[0, j, :nr],
                                     plan.s_ids[0, j, :ns],
                                     plan.tile_boxes[0, j], plan.universe, 16)
        prs.append(pr)
        pss.append(ps)
    assert torch.equal(tengine.tile_counts(plan), want)
    assert torch.equal(tengine.tile_counts(plan, dedup="none"), raw)
    assert (raw > want).any()
    jplan = jengine.plan_join("hc", jnp.asarray(r), jnp.asarray(s), 150, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    assert tengine.run_join_count(plan, dedup="none") == int(raw.sum()) == \
        jengine.run_join_count(jplan, mesh, "d", dedup="none")
    stats = {}
    rid, sid, _ = tengine.masj_pairs(plan, max_pairs_per_tile=16,
                                     stats=stats)
    assert torch.equal(rid, torch.cat(prs)) and torch.equal(sid,
                                                            torch.cat(pss))
    assert stats["truncated_tiles"] > 0 and stats["pairs"] == rid.shape[0]
