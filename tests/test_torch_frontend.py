"""repro_torch's request plane against repro's (``tests/test_frontend.py``'s
cases): the config, the plane (admission, DRR fairness, deadline-or-full
closing, the batch-shape ladder, timeouts), the metrics and histogram,
the clock and the open-loop simulator make repro's decisions on the
same seeded streams, with a stub executor (pure Python); ``poisson_workload``
draws repro's arrivals.  On live servers (N = 1500 osm-like objects,
``bsp`` at payload 130, repro's data and ``Partitioning`` carried
across, queries made with numpy): padded batches at every ladder width
equal direct batched calls on the port's replicated, sharded and heat
servers, and repro's server's answers on the same queries; the
open-loop simulation serves every arrival its direct answer; the
asyncio frontend serves mixed kinds, rejects when full and drains on
close.  Tolerance: exact equality throughout (the simulated latencies
too: the same virtual clock arithmetic)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import api as japi
from repro.data import spatial_gen as jgen
from repro.serve import ServeConfig as JConfig, SpatialServer as JServer
from repro.serve import frontend as jfe
from repro.serve.frontend import metrics as jmetrics
from repro_torch.core.partition import api as tapi
from repro_torch.serve import PlacementPolicy
from repro_torch.serve import ServeConfig as TConfig, SpatialServer as TServer
from repro_torch.serve import frontend as tfe
from repro_torch.serve.frontend import metrics as tmetrics

torch.set_num_threads(1)
N, PAYLOAD, NQ = 1500, 130, 13
FE = {"repro": jfe, "port": tfe}


def _req(fe, kind="range_counts", payload=None, params=(), tenant="default",
         deadline=float("inf")):
    return fe.Request(kind=kind,
                      payload=payload if payload is not None else np.zeros(4),
                      params=params, tenant=tenant, deadline=deadline)


# -- config, clock --------------------------------------------------------------

def test_config_validates_as_repro():
    cfg = tfe.FrontendConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfe.FrontendConfig())
    assert cfg.max_batch == cfg.ladder[-1]
    assert [cfg.width_for(n) for n in range(1, 513)] == \
        [jfe.FrontendConfig().width_for(n) for n in range(1, 513)]
    assert cfg.replace(max_delay=0.5).max_delay == 0.5
    for bad in (dict(ladder=()), dict(ladder=(128, 64)),
                dict(ladder=(0, 64)), dict(max_delay=-1.0),
                dict(queue_limit=0), dict(quantum=0),
                dict(default_deadline=0.0)):
        for fe in FE.values():
            with pytest.raises(ValueError):
                fe.FrontendConfig(**bad)
    with pytest.raises(ValueError):
        tfe.FrontendConfig(ladder=(4,)).width_for(5)
    assert tfe.FrontendConfig(ladder=[8.0, 16]).ladder == (8, 16)


def test_clocks():
    c = tfe.VirtualClock(1.5)
    assert c.now() == 1.5 and c.advance(0.25) == 1.75
    assert c.advance_to(3.0) == 3.0
    with pytest.raises(ValueError):
        c.advance(-1e-9)
    with pytest.raises(ValueError):
        c.advance_to(2.0)
    a = tfe.MonotonicClock().now()
    assert tfe.MonotonicClock().now() >= a


# -- the plane: repro's cases on the port -------------------------------------

def test_batch_closes_on_deadline_not_before():
    cfg = tfe.FrontendConfig(ladder=(4, 8), max_delay=0.010)
    plane = tfe.RequestPlane(cfg)
    for t in (0.0, 0.001, 0.002):
        assert plane.submit(_req(tfe), now=t)
    assert plane.next_due(0.002) == pytest.approx(0.010)
    assert plane.form_batch(0.009) == (None, [])
    batch, expired = plane.form_batch(0.010)
    assert batch is not None and not expired
    assert len(batch.requests) == 3 and batch.width == 4
    assert [r.seq for r in batch.requests] == [0, 1, 2]
    assert plane.pending == 0


def test_batch_closes_immediately_when_full():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(4, 8), max_delay=10.0))
    for _ in range(9):
        plane.submit(_req(tfe), now=0.0)
    assert plane.next_due(0.0) == 0.0
    batch, _ = plane.form_batch(0.0)
    assert len(batch.requests) == 8 and batch.width == 8
    assert plane.pending == 1
    batch, _ = plane.form_batch(10.0)
    assert len(batch.requests) == 1 and batch.width == 4


def test_ladder_pads_to_smallest_fitting_rung():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(4, 8, 16),
                                                max_delay=0.0))
    for n, want in ((3, 4), (5, 8), (9, 16)):
        for _ in range(n):
            plane.submit(_req(tfe), now=0.0)
        batch, _ = plane.form_batch(0.0)
        assert len(batch.requests) == n and batch.width == want


def test_kinds_and_params_batch_separately():
    plane = tfe.RequestPlane(tfe.FrontendConfig(max_delay=0.0))
    plane.submit(_req(tfe, "range_ids", params=(64,)), now=0.0)
    plane.submit(_req(tfe, "range_ids", params=(128,)), now=0.0)
    plane.submit(_req(tfe, "knn", np.zeros(2), (4, 64)), now=0.0)
    seen = set()
    for _ in range(3):
        batch, _ = plane.form_batch(0.0)
        assert len(batch.requests) == 1
        seen.add((batch.kind, batch.params))
    assert seen == {("range_ids", (64,)), ("range_ids", (128,)),
                    ("knn", (4, 64))}
    assert plane.form_batch(0.0) == (None, [])
    with pytest.raises(ValueError):
        plane.submit(_req(tfe, "nearest"), now=0.0)


def test_drr_hot_tenant_cannot_starve_others():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(8,), max_delay=0.0,
                                                quantum=2))
    for _ in range(100):
        plane.submit(_req(tfe, tenant="hog"), now=0.0)
    for i in range(4):
        plane.submit(_req(tfe, tenant=f"small{i}"), now=0.0)
    batch, _ = plane.form_batch(0.0)
    by = {}
    for r in batch.requests:
        by[r.tenant] = by.get(r.tenant, 0) + 1
    assert by == {"hog": 4, "small0": 1, "small1": 1, "small2": 1,
                  "small3": 1}


def test_deadline_close_serves_exhausted_deficit_tenant():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(8,), max_delay=0.010,
                                                quantum=2))
    for _ in range(6):
        plane.submit(_req(tfe, tenant="hog"), now=0.0)
    plane.submit(_req(tfe, tenant="slow"), now=0.002)
    assert plane.form_batch(0.009) == (None, [])
    batch, expired = plane.form_batch(0.010)
    assert not expired and [r.tenant for r in batch.requests] == \
        ["hog", "hog", "slow", "hog", "hog", "hog", "hog"]
    assert plane.pending == 0


def test_deadline_expiry_inside_exhausted_deficit_batch():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(4,), max_delay=0.010,
                                                quantum=4))
    for _ in range(4):
        plane.submit(_req(tfe, tenant="hog"), now=0.0)
    doomed = _req(tfe, tenant="slow", deadline=0.004)
    plane.submit(doomed, now=0.0)
    batch, expired = plane.form_batch(0.0)
    assert [r.tenant for r in batch.requests] == ["hog"] * 4 and not expired
    batch, expired = plane.form_batch(0.010)
    assert batch is None and expired == [doomed]
    assert plane.metrics.timed_out == 1 and plane.pending == 0


def test_drr_rotation_persists_across_batches():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(2,), max_delay=0.0,
                                                quantum=1))
    for t in "abc":
        for _ in range(2):
            plane.submit(_req(tfe, tenant=t), now=0.0)
    order = [[r.tenant for r in plane.form_batch(0.0)[0].requests]
             for _ in range(3)]
    assert sorted(t for pair in order for t in pair) == list("aabbcc")
    assert order[0] == ["a", "b"] and order[1] == ["c", "a"]


def test_backpressure_and_deadlines():
    plane = tfe.RequestPlane(tfe.FrontendConfig(queue_limit=3))
    assert all(plane.submit(_req(tfe, tenant="t"), 0.0) for _ in range(3))
    assert not plane.submit(_req(tfe, tenant="t"), 0.0)
    m = plane.metrics
    assert m.rejected == 1 and m.admitted == 3 and m.tenants["t"].rejected == 1
    plane.form_batch(1.0)
    assert plane.submit(_req(tfe, tenant="t"), 1.0)
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(4,), max_delay=0.0))
    dead, live = _req(tfe, deadline=0.5), _req(tfe, deadline=5.0)
    plane.submit(dead, 0.0)
    plane.submit(live, 0.0)
    batch, expired = plane.form_batch(1.0)
    assert expired == [dead] and batch.requests == [live]
    plane = tfe.RequestPlane(tfe.FrontendConfig(default_deadline=0.25))
    r, explicit = _req(tfe), _req(tfe, deadline=9.0)
    plane.submit(r, 1.0)
    plane.submit(explicit, 1.0)
    assert r.deadline == pytest.approx(1.25) and explicit.deadline == 9.0


def test_metrics_fill_ratio_and_padded_slots():
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(8,), max_delay=0.0))
    for _ in range(5):
        plane.submit(_req(tfe), 0.0)
    plane.form_batch(0.0)
    m = plane.metrics
    assert (m.batch_slots, m.batch_fill, m.padded_slots) == (8, 5, 3)
    assert m.batch_fill_ratio == pytest.approx(5 / 8)
    snap = m.snapshot()
    assert snap["batches"] == 1 and snap["padded_slots"] == 3


# -- the same decisions as repro on seeded streams -----------------------------

def _batch_key(batch):
    return None if batch is None else (
        batch.kind, batch.params, [r.seq for r in batch.requests],
        batch.width, batch.formed_at)


@pytest.mark.parametrize("seed", range(6))
def test_plane_makes_repros_decisions_on_a_seeded_stream(seed):
    """Random submissions (three kinds, two params each, five tenants
    of skewed weight, random deadlines) interleaved with forced and
    unforced closes at random times: every admission, batch (kind,
    params, request order, width, time), expiry, ``next_due`` and
    ``pending`` and the final metrics snapshot equal repro's."""
    rng = np.random.default_rng(seed)
    cfg = dict(ladder=(2, 4, 8), max_delay=float(rng.choice([0.0, 0.003])),
               queue_limit=int(rng.integers(6, 40)),
               quantum=int(rng.integers(1, 4)),
               default_deadline=[None, 0.02][seed % 2])
    planes = {k: fe.RequestPlane(fe.FrontendConfig(**cfg))
              for k, fe in FE.items()}
    kinds = [("range_counts", ()), ("range_ids", (64,)),
             ("range_ids", (128,)), ("knn", (4, 64))]
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(0.0007))
        if rng.random() < 0.7:
            kind, params = kinds[int(rng.integers(0, len(kinds)))]
            tenant = f"t{min(int(rng.pareto(1.0)), 4)}"
            dl = (float("inf") if rng.random() < 0.6
                  else now + float(rng.random() * 0.01))
            out = {k: p.submit(_req(FE[k], kind, params=params,
                                    tenant=tenant, deadline=dl), now)
                   for k, p in planes.items()}
        else:
            force = bool(rng.random() < 0.2)
            out = {}
            for k, p in planes.items():
                batch, expired = p.form_batch(now, force=force)
                out[k] = (_batch_key(batch), [r.seq for r in expired])
        assert out["port"] == out["repro"]
        assert planes["port"].next_due(now) == planes["repro"].next_due(now)
        assert planes["port"].pending == planes["repro"].pending
    assert planes["port"].metrics.snapshot() == \
        planes["repro"].metrics.snapshot()


def test_histogram_matches_repro():
    """The same samples (past the cap: decimation) give repro's kept
    samples, percentiles and snapshot."""
    rng = np.random.default_rng(0)
    vals = rng.exponential(0.01, 5000).tolist()
    h = {k: m.Histogram(cap=64) for k, m in
         {"repro": jmetrics, "port": tmetrics}.items()}
    for v in vals:
        for x in h.values():
            x.record(v)
    assert h["port"].samples == h["repro"].samples
    assert h["port"].snapshot() == h["repro"].snapshot()
    for p in (0, 1, 50, 90, 99, 100):
        assert h["port"].percentile(p) == h["repro"].percentile(p)
    t = tmetrics.Histogram(cap=64)
    for i in range(1000):
        t.record(float(i))
    assert t.count == 1000 and t.max == 999.0 and len(t.samples) < 64
    assert t.percentile(50) == pytest.approx(500.0, rel=0.1)
    assert tmetrics.Histogram().percentile(50) == 0.0


# -- the open-loop simulator ------------------------------------------------------

def _stub_execute(service_s):
    def execute(server, batch):
        return [0] * len(batch.requests), service_s
    return execute


def _mix(rng, i):
    """A mixed stream: kinds and tenants drawn from the arrival rng."""
    u = rng.random()
    kind, params = (("range_counts", ()) if u < 0.7 else
                    ("range_ids", (256,)) if u < 0.9 else ("knn", (4, 64)))
    payload = rng.random(2 if kind == "knn" else 4).astype(np.float32)
    return kind, payload, params, "hot" if rng.random() < 0.7 else f"t{i % 3}"


@pytest.mark.parametrize("rate,seed", [(10_000.0, 11), (500.0, 1),
                                       (60_000.0, 3)])
def test_poisson_workload_draws_repros_arrivals(rate, seed):
    wl = {k: fe.poisson_workload(rate, 0.1, _mix, seed=seed)
          for k, fe in FE.items()}
    assert len(wl["port"]) == len(wl["repro"]) > 0
    for a, b in zip(wl["port"], wl["repro"]):
        assert (a.t, a.kind, a.params, a.tenant, a.deadline) == \
            (b.t, b.kind, b.params, b.tenant, b.deadline)
        np.testing.assert_array_equal(a.payload, b.payload)


@pytest.mark.parametrize("service_s", [0.004, 0.0005])
def test_sim_makes_repros_decisions(service_s):
    """An overloaded mixed stream with tight deadlines on some
    arrivals: the port's simulator gives repro's outcomes, latencies
    and metrics, bit for bit, run over run."""
    cfg = dict(ladder=(8, 16), max_delay=0.002, queue_limit=64)
    out = {}
    for k, fe in FE.items():
        wl = fe.poisson_workload(10_000.0, 0.1, _mix, seed=11)
        for a in wl[::7]:
            a.deadline = 0.002
        runs = [fe.simulate_open_loop(None, wl, fe.FrontendConfig(**cfg),
                                      execute=_stub_execute(service_s))
                for _ in range(2)]
        assert runs[0][1].snapshot() == runs[1][1].snapshot()
        out[k] = runs[0]
    (rp, mp), (rr, mr) = out["port"], out["repro"]
    assert mp.snapshot() == mr.snapshot()
    assert [(r.outcome.value, r.queue_s, r.execute_s, r.total_s)
            for r in rp] == [(r.outcome.value, r.queue_s, r.execute_s,
                              r.total_s) for r in rr]
    s = mp.snapshot()
    if service_s > 0.001:
        assert s["rejected"] > 0 and s["timed_out"] > 0
    assert sum(r.ok for r in rp) + s["rejected"] + s["timed_out"] == len(rp)


def test_sim_latency_grows_with_load():
    def make(rng, i):
        return "range_counts", np.zeros(4), (), "default"
    cfg = tfe.FrontendConfig(ladder=(8, 16), max_delay=0.001)
    _, light = tfe.simulate_open_loop(
        None, tfe.poisson_workload(500.0, 0.2, make, seed=1), cfg,
        execute=_stub_execute(0.002))
    _, heavy = tfe.simulate_open_loop(
        None, tfe.poisson_workload(6000.0, 0.2, make, seed=1), cfg,
        execute=_stub_execute(0.002))
    assert heavy.total_s.percentile(99) > light.total_s.percentile(99)
    assert heavy.batch_fill_ratio > light.batch_fill_ratio


# -- live servers ----------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    mbrs = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), N))
    rng = np.random.default_rng(1)
    c = rng.random((NQ, 2))
    s = rng.random((NQ, 2)) * 0.06
    qb = np.concatenate([c - s, c + s], -1).astype(np.float32)
    pts = np.random.default_rng(2).random((NQ, 2)).astype(np.float32)
    return mbrs, japi.partition("bsp", jnp.asarray(mbrs), PAYLOAD), qb, pts


PLACEMENTS = {"replicated": dict(),
              "sharded": dict(placement="sharded", shards=4),
              "heat": dict(placement="heat", shards=4)}


@pytest.fixture(scope="module", params=list(PLACEMENTS))
def servers(request, data):
    """repro's server and the port's (CPU) on the same placement."""
    mbrs, jparts, _, _ = data
    tparts = tapi.Partitioning.from_numpy(jparts.boxes, jparts.valid, "cpu")
    cfg = PLACEMENTS[request.param]
    tcfg = TConfig(**cfg) if request.param != "heat" else TConfig(
        policy=PlacementPolicy(replicate_top=2), **cfg)
    js = None
    if request.param != "heat":
        js = JServer(jparts, jnp.asarray(mbrs), JConfig(**cfg))
    return js, TServer(tparts, mbrs, tcfg, device="cpu")


def _direct(srv, kind, q, params):
    """One direct batched call of the port's server -> host rows."""
    if kind == "range_counts":
        return [int(c) for c in srv.range_counts(q)[0]]
    if kind == "range_ids":
        hid, cnt, ovf, _ = srv.range_ids(q, max_hits=params[0])
        return [(hid[i].numpy(), int(cnt[i]), bool(ovf[i]))
                for i in range(q.shape[0])]
    nn, d2, ovf, _ = srv.knn(q, params[0], max_cand=params[1])
    return [(nn[i].numpy(), d2[i].numpy(), bool(ovf[i]))
            for i in range(q.shape[0])]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert g == w


@pytest.mark.parametrize("width", [16, 64])
def test_padded_batches_equal_direct_calls_and_repro(data, servers, width):
    """Every kind at two ladder widths: the padded batch's answers equal
    the port's direct unpadded call and repro's padded batch (ids, counts,
    ``(d2, id)``, overflow flags), and are host numpy."""
    _, _, qb, pts = data
    js, ts = servers
    for kind, q, params in (("range_counts", qb, ()),
                            ("range_ids", qb, (256,)),
                            ("range_ids", qb, (4,)),
                            ("knn", pts, (5, 256))):
        reqs = [tfe.Request(kind, q[i], params) for i in range(NQ)]
        got = tfe.execute_batch(ts, tfe.Batch(kind, params, reqs, width, 0.0))
        _same(got, _direct(ts, kind, q, params))
        for v in got:
            assert not any(isinstance(x, torch.Tensor)
                           for x in (v if isinstance(v, tuple) else (v,)))
        if js is not None:
            jreqs = [jfe.Request(kind, q[i], params) for i in range(NQ)]
            _same(got, jfe.execute_batch(
                js, jfe.Batch(kind, params, jreqs, width, 0.0)))


def test_split_batches_match_one_direct_batch(data, servers):
    _, _, qb, _ = data
    ts = servers[1]
    plane = tfe.RequestPlane(tfe.FrontendConfig(ladder=(4, 8), max_delay=0.0))
    reqs = [tfe.Request("range_counts", qb[i], ()) for i in range(NQ)]
    for r in reqs:
        plane.submit(r, 0.0)
    got = {}
    while plane.pending:
        batch, _ = plane.form_batch(0.0, force=True)
        for req, val in zip(batch.requests, tfe.execute_batch(ts, batch)):
            got[req.seq] = val
    assert [got[r.seq] for r in reqs] == _direct(ts, "range_counts", qb, ())


def test_open_loop_sim_on_a_live_server(data, servers):
    """Seeded mixed arrivals, real execution: every response is its
    query's direct answer."""
    _, _, qb, pts = data
    ts = servers[1]

    def make(rng, i):
        u = rng.random()
        if u < 0.6:
            return "range_counts", qb[i % NQ], (), f"t{i % 3}"
        if u < 0.85:
            return "range_ids", qb[i % NQ], (64,), "t0"
        return "knn", pts[i % NQ], (3, 256), "t1"

    wl = tfe.poisson_workload(4000.0, 0.03, make, seed=5)
    responses, metrics = tfe.simulate_open_loop(
        ts, wl, tfe.FrontendConfig(ladder=(8, 16), max_delay=0.002))
    want = {k: _direct(ts, k, q, p) for k, q, p in (
        ("range_counts", qb, ()), ("range_ids", qb, (64,)),
        ("knn", pts, (3, 256)))}
    assert all(r.ok for r in responses) and metrics.completed == len(wl)
    for i, (a, r) in enumerate(zip(wl, responses)):
        _same([r.value], [want[a.kind][i % NQ]])
    assert metrics.batches > 0 and metrics.total_s.count == len(wl)


# -- the asyncio wrapper -----------------------------------------------------------

def test_asyncio_frontend_serves_mixed_kinds(data, servers):
    _, _, qb, pts = data
    ts = servers[1]
    counts_w = _direct(ts, "range_counts", qb, ())
    knn_w = _direct(ts, "knn", pts, (3, 256))
    ids_w = _direct(ts, "range_ids", qb, (32,))

    async def main():
        async with tfe.ServeFrontend(ts, tfe.FrontendConfig(
                ladder=(16,), max_delay=0.005)) as fe:
            out = await asyncio.gather(
                asyncio.gather(*[fe.range_counts(qb[i], tenant=f"t{i % 3}")
                                 for i in range(NQ)]),
                asyncio.gather(*[fe.knn(pts[i], 3, max_cand=256)
                                 for i in range(NQ)]),
                asyncio.gather(*[fe.range_ids(qb[i], 32) for i in range(NQ)]))
        return out, fe

    (counts, knns, ids), fe = asyncio.run(main())
    assert all(r.ok for r in counts + knns + ids)
    assert [r.value for r in counts] == counts_w
    _same([r.value for r in knns], knn_w)
    _same([r.value for r in ids], ids_w)
    snap = fe.metrics.snapshot()
    assert snap["completed"] == 3 * NQ == snap["total_s"]["count"]
    assert set(snap["tenants"]) == {"default", "t0", "t1", "t2"}
    ps = fe.placement_stats()
    assert ps["placement"] == ts.stats["placement"]
    assert ps["heat_batches"] == ts.heat.batches > 0


def test_asyncio_frontend_rejects_when_full(data, servers):
    _, _, qb, _ = data

    async def main():
        fe = tfe.ServeFrontend(servers[1], tfe.FrontendConfig(
            ladder=(4,), max_delay=0.05, queue_limit=2))
        fe.start()
        try:
            return await asyncio.gather(*[fe.range_counts(qb[i])
                                          for i in range(6)])
        finally:
            await fe.close()

    outcomes = [r.outcome for r in asyncio.run(main())]
    assert outcomes.count(tfe.Outcome.REJECTED) >= 1
    assert all(o in (tfe.Outcome.OK, tfe.Outcome.REJECTED) for o in outcomes)


def test_asyncio_close_drains_pending(data, servers):
    _, _, qb, _ = data
    want = _direct(servers[1], "range_counts", qb[:4], ())

    async def main():
        fe = tfe.ServeFrontend(servers[1], tfe.FrontendConfig(
            ladder=(64,), max_delay=30.0))       # never due on its own
        fe.start()
        futs = [asyncio.ensure_future(fe.range_counts(qb[i]))
                for i in range(4)]
        await asyncio.sleep(0)
        await fe.close()                         # force-drains
        return await asyncio.gather(*futs)

    rs = asyncio.run(main())
    assert all(r.ok for r in rs) and [r.value for r in rs] == want


def test_frontend_not_started_raises(servers, data):
    async def main():
        await tfe.ServeFrontend(servers[1]).range_counts(data[2][0])
    with pytest.raises(RuntimeError, match="not started"):
        asyncio.run(main())
