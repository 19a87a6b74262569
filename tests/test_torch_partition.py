"""repro_torch's six Table-1 partitioners against repro's on the same
osm- and pi-like data (repro's generators, carried across as numpy):
boxes and valid masks bit for bit at two payloads; the fixed grid's
edges bit for bit against ``jnp.linspace``'s jitted CPU rounding; bos
past the point where its data runs out; the registry's Table-1
metadata; MASJ counts exactly and the paper's metrics and the cost
model within a relative 1e-6 (float32 sums in another order over at
most a few hundred tiles); sampling on a shared sample, and by the
properties ``tests/test_sampling.py`` checks."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (wires repro's Hilbert kernel into hc)
from repro.core import cost_model as jcost, geometry as jgeom
from repro.core import metrics as jmetrics
from repro.core import sampling as jsampling
from repro.core.partition import api as japi, bos as jbos
from repro.core.partition import partition_counts as jcounts
from repro.data import spatial_gen as jgen
from repro_torch.core import cost_model as tcost, metrics as tmetrics
from repro_torch.core import geometry as tgeom
from repro_torch.core import sampling as tsampling
from repro_torch.core.partition import api as tapi, bos as tbos
from repro_torch.core.partition import fg as tfg
from repro_torch.core.partition import partition_counts as tcounts

torch.set_num_threads(1)
N = 3000
METHODS = ["fg", "bsp", "slc", "bos", "str", "hc"]
TOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(scope="module", params=["osm", "pi"])
def data(request):
    return np.array(jgen.dataset(request.param, jax.random.PRNGKey(0), N))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _both(method, mbrs, payload):
    jp = japi.partition(method, jnp.asarray(mbrs), payload)
    tp = tapi.partition(method, torch.from_numpy(mbrs), payload)
    return jp, tp


@pytest.mark.parametrize("payload", [120, 500])
@pytest.mark.parametrize("method", METHODS)
def test_partition_matches_repro_bit_for_bit(data, method, payload):
    jp, tp = _both(method, data, payload)
    assert tp.boxes.dtype == torch.float32 and tp.kmax == jp.kmax
    np.testing.assert_array_equal(_bits(tp.boxes.numpy()), _bits(jp.boxes))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert tp.k() == int(jp.k())


@pytest.mark.parametrize("payload", [7, 60, 120, 500, 3000])
def test_fg_edges_match_jnp_linspace_on_the_data(data, payload):
    m = max(1, math.ceil(math.sqrt(N / payload)))
    uni = tgeom.universe(torch.from_numpy(data))
    for lo, hi in ((0, 2), (1, 3)):
        got = tfg.linspace_edges(uni[lo], uni[hi], m)
        want = jnp.linspace(jnp.asarray(uni[lo].numpy()),
                            jnp.asarray(uni[hi].numpy()), m + 1)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("m", [1, 2, 3, 16, 33, 34, 45, 100, 351, 352,
                               383, 400, 700, 1000])
def test_fg_edges_follow_each_rounding_regime(m):
    """Unrolled (m <= 33: edge 1 rounds as fma(start, 1 - c, sc)),
    the plain contracted loop, and the vectorised loop (m >= 352: also
    1 - i*c contracted, up to the last full 32 edges)."""
    rng = np.random.default_rng(m)
    for _ in range(3):
        lo, hi = np.sort(rng.random(2).astype(np.float32) * 4 - 2)
        got = tfg.linspace_edges(torch.tensor(lo), torch.tensor(hi), m)
        want = jnp.linspace(jnp.asarray(lo), jnp.asarray(hi), m + 1)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_bos_past_the_end_of_its_data(data, monkeypatch):
    """Two steps more than the data needs, in both packages: the extra
    steps repeat the remaining box and are not valid."""
    ceil_plus_2 = types.SimpleNamespace(ceil=lambda x: math.ceil(x) + 2)
    monkeypatch.setattr(jbos, "math", ceil_plus_2)
    monkeypatch.setattr(tbos, "math", ceil_plus_2)
    jp, tp = _both("bos", data[:700], 300)
    assert tp.kmax == 5 and tp.valid.numpy().tolist() == [True] * 3 + [
        False] * 2
    np.testing.assert_array_equal(_bits(tp.boxes.numpy()), _bits(jp.boxes))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))


@pytest.mark.parametrize("n,payload", [(1, 5), (300, 300), (900, 300),
                                       (901, 300)])
def test_bos_exact_and_ragged_fits(data, n, payload):
    jp, tp = _both("bos", data[:n], payload)
    np.testing.assert_array_equal(_bits(tp.boxes.numpy()), _bits(jp.boxes))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))


def test_registry_metadata_matches_repro():
    def table(mod):
        return {name: (i.overlapping, i.search, i.criterion,
                       i.covers_universe)
                for name, i in mod.methods().items()}
    assert table(tapi) == table(japi)
    assert list(tapi.methods()) == list(japi.methods())
    assert tapi.info("hc").overlapping and not tapi.info("bsp").overlapping
    with pytest.raises(KeyError):
        tapi.partition("quadtree", torch.zeros(4, 4), 2)


@pytest.mark.parametrize("method", METHODS)
def test_counts_and_metrics_match_repro(data, method):
    jp, tp = _both(method, data, 120)
    jc, jcp = jcounts(jnp.asarray(data), jp)
    tc, tcp = tcounts(torch.from_numpy(data), tp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tcp.numpy(), np.asarray(jcp))
    pairs = [
        (tmetrics.balance_stddev(tc, tp.valid),
         jmetrics.balance_stddev(jc, jp.valid)),
        (tmetrics.boundary_ratio(tc, tp.valid, N),
         jmetrics.boundary_ratio(jc, jp.valid, N)),
        (tmetrics.skew_ratio(tc, tp.valid), jmetrics.skew_ratio(jc, jp.valid)),
        (tmetrics.coverage(tcp), jmetrics.coverage(jcp)),
        (tmetrics.padding_waste(tc, tp.valid, 256),
         jmetrics.padding_waste(jc, jp.valid, 256)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_cost_model_matches_repro():
    ks = [4, 16, 64, 256, 1024]
    alphas = [0.01, 0.05, 0.12, 0.3, 0.7]
    got_i, got = tcost.optimal_k(50_000, 40_000, ks, alphas)
    want_i, want = jcost.optimal_k(50_000, 40_000, ks, alphas)
    assert int(got_i) == int(want_i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p = tcost.CostParams(beta=3.0, c_pair=0.5)
    jp = jcost.CostParams(beta=3.0, c_pair=0.5)
    for k, a, skew in [(1, 0.0, 1.0), (37, 0.2, 2.5), (0, 1.5, 0.5)]:
        np.testing.assert_allclose(
            float(tcost.straggler_cost(1e4, 3e4, k, a, skew, p)),
            float(jcost.straggler_cost(1e4, 3e4, k, a, skew, jp)), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_sampled_partition_of_a_shared_sample_matches_repro(data, method):
    """Both packages partition the same 20% sample at payload 24 and fit
    it to the full data (rim extension for covering layouts)."""
    idx = np.random.default_rng(5).permutation(N)[:600]
    sample = data[idx]
    jparts = japi.partition(method, jnp.asarray(sample), 24)
    if japi.info(method).covers_universe:
        jparts = jsampling._extend_rim(
            jparts, jgeom.universe(jnp.asarray(sample)),
            jgeom.universe(jnp.asarray(data)))
    got = tsampling.partition_sample(method, torch.from_numpy(data),
                                     torch.from_numpy(sample), 24)
    assert (got.sample_size, got.sample_payload) == (600, 24)
    np.testing.assert_array_equal(_bits(got.parts.boxes.numpy()),
                                  _bits(jparts.boxes))
    np.testing.assert_array_equal(got.parts.valid.numpy(),
                                  np.asarray(jparts.valid))
    fb = tsampling.nearest_box_fallback(torch.from_numpy(data), got.parts)
    np.testing.assert_array_equal(
        fb.numpy(), np.asarray(jsampling.nearest_box_fallback(
            jnp.asarray(data), jparts)))


@pytest.fixture(scope="module")
def osm4k():
    return torch.from_numpy(np.array(
        jgen.dataset("osm", jax.random.PRNGKey(0), 4000)))


@pytest.mark.parametrize("method", ["fg", "bsp", "slc", "bos"])
def test_sampled_layout_covers_full_dataset(osm4k, method):
    res = tsampling.sampled_partition(method, osm4k, 200, 0.2,
                                      torch.Generator().manual_seed(1))
    _, copies = tsampling.evaluate_on_full(res, osm4k)
    assert float(tmetrics.coverage(copies)) == 1.0


@pytest.mark.parametrize("method", ["hc", "str"])
def test_tight_mbr_samples_leave_gaps_the_fallback_fills(osm4k, method):
    res = tsampling.sampled_partition(method, osm4k, 200, 0.1,
                                      torch.Generator().manual_seed(2))
    _, copies = tsampling.evaluate_on_full(res, osm4k)
    assert bool((copies == 0).any())
    fb = tsampling.nearest_box_fallback(osm4k, res.parts)
    assert fb.shape == (4000,) and bool(res.parts.valid[fb.long()].all())
    m = osm4k.numpy()
    c = (m[:, :2] + m[:, 2:]) * 0.5
    boxes, valid = res.parts.boxes.numpy(), res.parts.valid.numpy()
    d2 = np.sum((c[:, None] - ((boxes[:, :2] + boxes[:, 2:]) * 0.5)[None])
                ** 2, axis=-1)
    d2[:, ~valid] = np.inf
    np.testing.assert_array_equal(fb.numpy(), np.argmin(d2, axis=1))


def test_higher_sampling_rate_does_not_blow_up_balance(osm4k):
    stds = []
    for gamma in (0.05, 0.5):
        res = tsampling.sampled_partition("bsp", osm4k, 200, gamma,
                                          torch.Generator().manual_seed(3))
        counts, _ = tsampling.evaluate_on_full(res, osm4k)
        stds.append(float(tmetrics.balance_stddev(counts, res.parts.valid)))
    assert stds[1] <= stds[0] * 1.5


def test_sample_payload_scaling():
    mbrs = torch.from_numpy(np.array(
        jgen.dataset("pi", jax.random.PRNGKey(1), 1000)))
    res = tsampling.sampled_partition("slc", mbrs, 100, 0.3,
                                      torch.Generator().manual_seed(0))
    assert (res.sample_size, res.sample_payload) == (300, 30)
    assert abs(res.parts.k() - 10) <= 2
