"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card.  The file imports neither jax nor repro, so it runs where
only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Tolerance: exact equality
(bool and int outputs)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np
import pytest
import torch

from repro_torch.data import spatial_gen
from repro_torch.kernels.range_probe import kernel, ops
from repro_torch.query import knn as knn_mod
from repro_torch.query import range as range_mod
from repro_torch.serve import ServeConfig, SpatialServer

pytestmark = pytest.mark.cuda
CHUNK = 128


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _boxes(rng, n, scale):
    c = rng.random((n, 2))
    s = rng.random((n, 2)) * scale
    return torch.from_numpy(
        np.concatenate([c - s, c + s], axis=-1).astype(np.float32))


def _case(q, t, cap, f, alive, boxes, seed=0):
    rng = np.random.default_rng(seed + q + t + cap + f)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    cand = torch.from_numpy(rng.integers(-1, t, (q, f)).astype(np.int32))
    al = (None if alive is None
          else torch.from_numpy(rng.random((t, cap)) < 0.7))
    c = -(-cap // CHUNK)
    if boxes == "bounding":
        pad = torch.tensor([9e9, 9e9, -9e9, -9e9]).expand(t, c * CHUNK - cap, 4)
        g = torch.cat([tiles, pad], 1).reshape(t, c, CHUNK, 4)
        cb = torch.cat([g[..., :2].amin(2), g[..., 2:].amax(2)], -1)
    else:
        cb = _boxes(rng, t * c, 0.05).reshape(t, c, 4)
    return qb, tiles, cand, al, cb


@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("boxes", ["bounding", "arbitrary"])
@pytest.mark.parametrize("q,t,cap,f", [(1, 1, 1, 1), (300, 6, 257, 8),
                                       (70, 3, 4100, 5)])
def test_kernels_match_plain_versions(q, t, cap, f, alive, boxes):
    """All four kernels bit-equal their plain versions: ragged cap, -1
    candidates, chunk boxes that do not bound their members."""
    _need_cuda()
    qb, tiles, cand, al, cb = _case(q, t, cap, f, alive, boxes)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    for fn, extra in [("gathered_counts", ()), ("gathered_mask", ()),
                      ("gathered_counts_skip", (cb,)),
                      ("gathered_mask_skip", (cb,))]:
        got = getattr(ops, fn)(dev(qb), dev(tiles), *map(dev, extra),
                               dev(cand), alive=dev(al))
        want = getattr(ops, fn)(qb, tiles, *extra, cand, alive=al)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), fn


@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("boxes", ["bounding", "arbitrary"])
@pytest.mark.parametrize("q,t,cap", [(1, 1, 1), (7, 2, 1024), (130, 5, 257),
                                     (300, 3, 4100)])
def test_dense_kernels_match_plain_versions(q, t, cap, alive, boxes):
    """The four dense kernels bit-equal their plain versions: ragged Q
    and cap (both store paths: cap % 4 == 0 and not), sentinel slots,
    chunk boxes that do not bound their members."""
    _need_cuda()
    qb, tiles, _, al, cb = _case(q, t, cap, 1, alive, boxes)
    tiles[torch.from_numpy(np.random.default_rng(cap).random((t, cap))
                           < 0.3)] = torch.tensor([9e9, 9e9, -9e9, -9e9])
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    for fn, extra in [("probe_counts", ()), ("probe_mask", ()),
                      ("probe_counts_skip", (cb,)),
                      ("probe_mask_skip", (cb,))]:
        got = getattr(ops, fn)(dev(qb), dev(tiles), *map(dev, extra),
                               alive=dev(al))
        want = getattr(ops, fn)(qb, tiles, *extra, alive=al)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), fn


def test_wrappers_count_launches_and_reject_bad_inputs():
    _need_cuda()
    qb, tiles, cand, _, cb = _case(20, 3, 300, 4, None, "bounding")
    qb, tiles, cand, cb = qb.cuda(), tiles.cuda(), cand.cuda(), cb.cuda()
    kernel.reset_launches()
    kernel.gather_count_skip(qb, tiles, cb, cand)
    assert kernel.LAUNCHES["gather_count_skip"] == 1
    with pytest.raises(TypeError):
        kernel.gather_count(qb.double(), tiles, cand)
    with pytest.raises(ValueError):
        kernel.gather_mask(qb, tiles.transpose(0, 1), cand)
    with pytest.raises(ValueError):
        kernel.gather_count_skip(qb, tiles, cb[:, :1].contiguous(), cand)
    kernel.count(qb, tiles, alive=None)
    assert kernel.LAUNCHES["count"] == 1
    with pytest.raises(ValueError):
        kernel.mask_skip(qb, tiles, cb[:1].contiguous())
    assert sum(kernel.LAUNCHES.values()) == 2


def test_server_on_cuda_matches_cpu():
    """The whole slice on the card equals the plain versions on the CPU."""
    _need_cuda()
    mbrs = spatial_gen.osm_like(20_000, seed=0, device="cpu")
    qb = _boxes(np.random.default_rng(1), 64, 0.03)
    for li in ("x", "off"):
        srv = {d: SpatialServer.from_method("bsp", mbrs, 256,
                                            ServeConfig(local_index=li),
                                            device=d)
               for d in ("cpu", "cuda")}
        want = srv["cpu"].range_counts(qb)
        got = srv["cuda"].range_counts(qb)
        assert torch.equal(got[0].cpu(), want[0]) and got[1] == want[1]
        want = srv["cpu"].range_ids(qb, max_hits=16)
        got = srv["cuda"].range_ids(qb, max_hits=16)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        ref = range_mod.range_query_ref(mbrs.numpy(), qb.numpy())
        assert [len(r) for r in ref] == got[1].cpu().tolist()


def test_knn_on_cuda_matches_cpu_and_bruteforce():
    """Pruned and dense kNN on the card equal the plain versions on the
    CPU, stats included, and the numpy brute force's ids."""
    _need_cuda()
    mbrs = spatial_gen.osm_like(20_000, seed=0, device="cpu")
    pts = torch.from_numpy(
        np.random.default_rng(2).random((64, 2)).astype(np.float32))
    want_ids, _ = knn_mod.knn_ref(mbrs.numpy(), pts.numpy(), 8)
    for li in ("x", "off"):
        srv = {d: SpatialServer.from_method("bsp", mbrs, 256,
                                            ServeConfig(local_index=li),
                                            device=d)
               for d in ("cpu", "cuda")}
        for pruned in (None, False):
            want = srv["cpu"].knn(pts, 8, pruned=pruned)
            got = srv["cuda"].knn(pts, 8, pruned=pruned)
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g.cpu(), w)
            assert got[3] == want[3]
            ok = ~got[2].cpu().numpy()
            np.testing.assert_array_equal(got[0].cpu().numpy()[ok],
                                          want_ids[ok])
