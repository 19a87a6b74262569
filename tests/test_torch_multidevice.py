"""repro_torch's multi-device paths, simulated on one device, against
repro's: join plans for 4 and 8 devices count what repro counts and
what the unpartitioned brute force counts (``mbr_join.ref``'s
``intersect_count``) on all six layouts, raw and exact, and list the
same distinct MASJ pairs as the one-device plan; ``parallel_partition``
against repro's on an 8-device host mesh in a subprocess (the pattern
of ``tests/test_multidevice.py``), repro's splitters passed across
(its sample comes from ``jax.random``): regions, ``valid`` and the
stats bit for bit; the port's own splitters cover every object; and
the ETL's ``--parallel``.  Tolerance: exact equality throughout."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.kernels  # noqa: F401  (wires repro's Hilbert kernel into hc)
from repro.data import spatial_gen as jgen
from repro.kernels.mbr_join import ref as jmref
from repro.query import engine as jengine
from repro_torch.core import metrics
from repro_torch.core.partition import partition_counts
from repro_torch.launch import partition_etl
from repro_torch.query import engine as tengine
from repro_torch.query import parallel_partition as tpp

torch.set_num_threads(1)
METHODS = ["fg", "bsp", "slc", "bos", "str", "hc"]
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def rs():
    r = np.array(jgen.dataset("osm", jax.random.PRNGKey(0), 1500))
    s = np.array(jgen.dataset("pi", jax.random.PRNGKey(1), 1200))
    return r, s


@pytest.fixture(scope="module")
def oracle(rs):
    return int(jmref.intersect_count(jnp.asarray(rs[0]), jnp.asarray(rs[1])))


@pytest.mark.parametrize("n_devices", [4, 8])
@pytest.mark.parametrize("method", METHODS)
def test_multi_device_plans_count_as_repro(rs, oracle, method, n_devices):
    r, s = rs
    plan = tengine.plan_join(method, r, s, 200, n_devices, device="cpu")
    assert plan.r_tiles.shape[0] == n_devices
    jplan = jengine.plan_join(method, jnp.asarray(r), jnp.asarray(s), 200, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    want = jengine.spatial_join_count(jplan, mesh, "d",
                                      max_pairs_per_tile=8192)
    got = tengine.spatial_join_count(plan, max_pairs_per_tile=8192)
    assert got == want == oracle
    raw = tengine.run_join_count(plan, dedup="none")
    assert raw == jengine.run_join_count(jplan, mesh, "d", dedup="none")
    one = tengine.plan_join(method, r, s, 200, 1, device="cpu")
    assert raw == tengine.run_join_count(one, dedup="none")
    per = tengine.tile_counts(plan, dedup="none")
    assert per.shape == (n_devices * plan.stats["tpd"],)
    assert int(per.sum()) == raw
    rid, sid, uniq = tengine.masj_pairs(plan, max_pairs_per_tile=8192)
    orid, osid, ouniq = tengine.masj_pairs(one, max_pairs_per_tile=8192)
    got_pairs = set(zip(rid[uniq].tolist(), sid[uniq].tolist()))
    assert got_pairs == set(zip(orid[ouniq].tolist(), osid[ouniq].tolist()))
    assert len(got_pairs) == oracle


_PP = """
import sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.data import spatial_gen
from repro.query import parallel_partition as pp
mesh = Mesh(np.array(jax.devices()).reshape(8), ('d',))
res = {}
for name, n, payload, cap in [('osm', 3000, 100, 2.0), ('pi', 2500, 64, 2.0),
                              ('osm', 2000, 50, 0.1)]:
    key = jax.random.PRNGKey(n)
    mbrs = spatial_gen.dataset(name, key, n)
    parts, stats = pp.parallel_partition(key, mbrs, payload, mesh, 'd',
                                         cap_factor=cap)
    tag = f'{name}{n}'
    res[tag + '_mbrs'] = np.asarray(mbrs)
    res[tag + '_spl'] = np.asarray(pp.coarse_splitters(key, mbrs, 8))
    res[tag + '_boxes'] = np.asarray(parts.boxes)
    res[tag + '_valid'] = np.asarray(parts.valid)
    res[tag + '_stats'] = np.array([stats['dropped'], stats['buckets'],
                                    stats['kmax_local']])
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def repro_partitions(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", _PP, str(out)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return np.load(out)


@pytest.mark.parametrize("tag,payload,cap", [
    ("osm3000", 100, 2.0), ("pi2500", 64, 2.0), ("osm2000", 50, 0.1)])
def test_parallel_partition_matches_repro_on_eight_devices(
        repro_partitions, tag, payload, cap):
    """The third case's small buffers drop objects, as repro's do."""
    ref = repro_partitions
    parts, stats = tpp.parallel_partition(
        torch.from_numpy(ref[tag + "_mbrs"]), payload, 8, cap_factor=cap,
        splitters=torch.from_numpy(ref[tag + "_spl"].astype(np.int64)))
    np.testing.assert_array_equal(parts.boxes.numpy(), ref[tag + "_boxes"])
    np.testing.assert_array_equal(parts.valid.numpy(), ref[tag + "_valid"])
    want = ref[tag + "_stats"]
    assert [stats["dropped"], stats["buckets"], stats["kmax_local"]] == \
        want.tolist()
    assert (stats["dropped"] > 0) == (cap < 1.0)


@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_parallel_partition_with_own_splitters_covers_every_object(d):
    mbrs = torch.from_numpy(np.array(jgen.dataset(
        "osm", jax.random.PRNGKey(d), 2000)))
    parts, stats = tpp.parallel_partition(mbrs, 100, d)
    assert stats == dict(dropped=0, buckets=d,
                         kmax_local=max(1, -(-2 * -(-2000 // d) // 100)))
    assert parts.boxes.shape == (d * stats["kmax_local"] * d, 4)
    _, copies = partition_counts(mbrs, parts)
    assert float(metrics.coverage(copies)) == 1.0
    spl = tpp.coarse_splitters(mbrs, d)
    assert spl.shape == (d - 1,) and bool((spl[1:] >= spl[:-1]).all())


def test_etl_parallel_partitions_and_joins_on_the_cpu(capsys):
    assert partition_etl.main(["--device", "cpu", "--n", "3000", "--payload",
                               "300", "--parallel", "--join"]) == 0
    out = capsys.readouterr().out
    assert "parallel partition stats: {'dropped': 0, 'buckets': 1" in out
    assert "coverage          = 1.0000" in out and "join: |R⋈S| =" in out
