"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card.  The file imports neither jax nor repro, so it runs where
only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Tolerance: exact equality
(bool and int outputs); the SSD block's float32 output within the
reference's 2e-5 (another summation order than the plain version's),
and the Mamba2 model within 1e-4 in float32."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np
import pytest
import torch

from repro_torch.core import hilbert as core_hilbert
from repro_torch.core.partition import api as papi
from repro_torch.data import spatial_gen
from repro_torch.kernels.hilbert import kernel as hkernel
from repro_torch.kernels.hilbert import ops as hops
from repro_torch.kernels.mbr_join import kernel as mkernel
from repro_torch.kernels.mbr_join import ops as mops
from repro_torch.kernels.range_probe import kernel, ops
from repro_torch.kernels.ssd import kernel as skernel
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd import ref as sref
from repro_torch.query import engine as join_engine
from repro_torch.query import knn as knn_mod
from repro_torch.query import range as range_mod
from repro_torch.serve import ServeConfig, SpatialServer, router

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
    candidates, chunk boxes that do not bound their members; the two
    count kernels with and without the live extent of the alive mask."""
    _need_cuda()
    qb, tiles, cand, al, cb = _case(q, t, cap, f, alive, boxes)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    ext = None if al is None else ops.live_extent(al)
    for fn, extra in [("gathered_counts", ()), ("gathered_mask", ()),
                      ("gathered_counts_skip", (cb,)),
                      ("gathered_mask_skip", (cb,))]:
        want = getattr(ops, fn)(qb, tiles, *extra, cand, alive=al)
        kw = [{}, {"extent": dev(ext)}] if "counts" in fn else [{}]
        for k in kw:
            got = getattr(ops, fn)(dev(qb), dev(tiles), *map(dev, extra),
                                   dev(cand), alive=dev(al), **k)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (fn, k)


@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("cap", [257, 4096])
def test_count_kernels_runs_padding_and_empty_tiles(cap, alive):
    """The tile-major counts at their edges: 300 queries on one tile (runs
    of 128, 128 and 44 at most), all -1 rows, tiles whose live extent is
    0 or cap, and alive slots only past a dead prefix; 4096
    slots read the alive flags 16 bytes a thread, 257 a byte at a time."""
    _need_cuda()
    t, f = 5, 6
    qb, tiles, cand, al, cb = _case(300, t, cap, f, alive, "bounding")
    cand[:, 0] = 0                     # every query probes tile 0
    cand[:40] = -1                     # all -1 rows
    if al is not None:
        al[2] = False                  # extent 0
        al[3] = False
        al[3, cap - 1] = True          # extent == cap
        al[4, :cap // 2] = False       # alive only past a dead prefix
    ext = None if al is None else ops.live_extent(al)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    for fn, extra in [("gathered_counts", ()),
                      ("gathered_counts_skip", (cb,))]:
        want = getattr(ops, fn)(qb, tiles, *extra, cand, alive=al)
        assert int(want[:40].abs().sum()) == 0
        for e in (None, ext):
            kernel.reset_launches()
            got = getattr(ops, fn)(dev(qb), dev(tiles), *map(dev, extra),
                                   dev(cand), alive=dev(al), extent=dev(e))
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (fn, e is None)
            assert sum(kernel.LAUNCHES.values()) == 1
    empty = torch.full((7, f), -1, dtype=torch.int32)
    got = ops.gathered_counts(dev(qb[:7]), dev(tiles), dev(empty),
                              alive=dev(al), extent=dev(ext))
    assert torch.equal(got.cpu(), torch.zeros((7, f), dtype=torch.int32))


@pytest.mark.parametrize("boxes", [None, "bounding", "arbitrary"])
@pytest.mark.parametrize("alive", [None, "random"])
@pytest.mark.parametrize("cap", [257, 20_000])
def test_hit_list_kernels_match_plain_version(cap, alive, boxes):
    """The routed hit lists (count, scan, emit) at their edges, bit-equal
    to the plain version and to the nonzeros of the mask kernel's
    table: 280 queries on one tile (three runs of up to 128), a query
    whose box holds all of that tile (hits far past a warp, and across
    the 8,192-slot segments at 20,000 slots), all -1 rows, tiles whose
    extent is 0, below cap and cap; with and without the extent."""
    _need_cuda()
    t, f = 5, 6
    qb, tiles, cand, al, cb = _case(300, t, cap, f, alive, boxes or
                                    "bounding")
    cb = None if boxes is None else cb
    cand[:, 0] = 0                     # every query probes tile 0
    cand[40:60] = -1                   # all -1 rows
    qb[0] = torch.tensor([-1.0, -1.0, 2.0, 2.0])   # holds all of tile 0
    if al is not None:
        al[2] = False                  # extent 0
        al[3, cap // 2:] = False       # extent below cap
        al[1, cap - 1] = True          # extent == cap
    ext = None if al is None else ops.live_extent(al)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    name = "gather_hits" if cb is None else "gather_hits_skip"
    extra = () if cb is None else (cb,)
    fn = "gathered_hit_list" + ("" if cb is None else "_skip")
    want = getattr(ops, fn)(qb, tiles, *extra, cand, alive=al)
    assert int((want[0] == 0).sum()) > (8192 if cap > 8192 else 32)
    table = getattr(kernel, name.replace("hits", "mask"))(
        dev(qb), dev(tiles), *map(dev, extra), dev(cand), alive=dev(al))
    bq, bf, bs = table.nonzero(as_tuple=True)
    for w, x in zip(want, (bq, dev(cand)[bq, bf].long(), bs)):
        assert torch.equal(x.cpu(), w)
    for e in (None, ext):
        kernel.reset_launches()
        got = getattr(ops, fn)(dev(qb), dev(tiles), *map(dev, extra),
                               dev(cand), alive=dev(al), extent=dev(e))
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == dict(
            {k: 0 for k in kernel.LAUNCHES}, **{name: 1})
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and torch.equal(g.cpu(), w)
    empty = torch.full((7, f), -1, dtype=torch.int32)
    got = getattr(ops, fn)(dev(qb[:7]), dev(tiles), *map(dev, extra),
                           dev(empty), alive=dev(al), extent=dev(ext))
    assert all(g.shape == (0,) for g in got)


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
    # the block-per-(tile, query block) counts, off the dense path
    got = kernel.count(dev(qb), dev(tiles), alive=dev(al))
    assert torch.equal(got.cpu(), ops.probe_counts(qb, tiles, alive=al))
    # the chunk-skipping pair to the live extent, and its first design
    ext = None if al is None else ops.live_extent(al)
    for name in ("count_skip", "mask_skip"):
        want = getattr(ops, "probe_" + name.replace("count", "counts"))(
            qb, tiles, cb, alive=al)
        for got in (getattr(kernel, name)(dev(qb), dev(tiles), dev(cb),
                                          alive=dev(al), extent=dev(ext)),
                    getattr(kernel, name + "_v1")(dev(qb), dev(tiles),
                                                  dev(cb), alive=dev(al))):
            assert torch.equal(got.cpu(), want), name


@pytest.mark.parametrize("alive", [None, "random", "staged"])
@pytest.mark.parametrize("q,t,cap", [(1, 1, 1), (700, 5, 257),
                                     (130, 4, 20_000)])
def test_dense_tile_kernels_match_plain_version(q, t, cap, alive,
                                                monkeypatch):
    """The tile-major dense counts and hit list bit-equal their plain
    versions: Q not a multiple of 4 x 128 (runs of 512 and fewer), cap
    not a multiple of 128 and past one 8,192-slot segment, a query that
    holds every box (hits past a warp and across segments), a tile
    whose extent is 0 and one whose last slot is alive, with and
    without the extent; then the hit list in several query blocks."""
    _need_cuda()
    rng = np.random.default_rng(q + t + cap)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    tiles[torch.from_numpy(rng.random((t, cap)) < 0.2)] = torch.tensor(
        [9e9, 9e9, -9e9, -9e9])
    qb[0] = torch.tensor([-1.0, -1.0, 2.0, 2.0])   # holds every box
    al = None
    if alive == "random":
        al = torch.from_numpy(rng.random((t, cap)) < 0.7)
    elif alive == "staged":                        # a prefix of each tile
        n = torch.from_numpy(rng.integers(0, cap + 1, t))
        n[0] = cap
        al = torch.arange(cap)[None, :] < n[:, None]
    if al is not None and t > 2:
        al[1] = False                  # extent 0
        al[2, cap - 1] = True          # extent == cap
    ext = None if al is None else ops.live_extent(al)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    want_c = ops.probe_counts(qb, tiles, alive=al)
    want_h = ops.dense_hit_list(qb, tiles, alive=al)
    assert int((want_h[0] == 0).sum()) > (8192 if cap > 8192 else 32) or (
        q == 1)
    for e in (None, ext):
        kernel.reset_launches()
        got_c = ops.probe_counts(dev(qb), dev(tiles), alive=dev(al),
                                 extent=dev(e))
        got_h = ops.dense_hit_list(dev(qb), dev(tiles), alive=dev(al),
                                   extent=dev(e))
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == dict({k: 0 for k in kernel.LAUNCHES},
                                       dense_counts=1, dense_hits=1)
        assert torch.equal(got_c.cpu(), want_c), e is None
        for g, w in zip(got_h, want_h):
            assert g.dtype == torch.int64 and torch.equal(g.cpu(), w)
    monkeypatch.setattr(ops, "_DENSE_CELL_BYTES",     # three queries a block
                        3 * kernel.dense_row_bytes(t, cap))
    kernel.reset_launches()
    got_h = ops.dense_hit_list(dev(qb), dev(tiles), alive=dev(al),
                               extent=dev(ext))
    assert kernel.LAUNCHES["dense_hits"] == -(-q // 3)
    for g, w in zip(got_h, want_h):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("alive", [None, "random", "staged"])
@pytest.mark.parametrize("boxes", ["bounding", "arbitrary"])
@pytest.mark.parametrize("q,t,cap", [(1, 1, 1), (7, 3, 4100), (130, 5, 257),
                                     (700, 4, 20_000)])
def test_dense_skip_kernels_match_plain_version(q, t, cap, alive, boxes):
    """The chunk-skipping dense counts (tile-major, a query a thread) and
    table (slot-parallel) bit-equal their plain versions and their first
    design (``count_skip_v1``, ``mask_skip_v1``): Q = 1, 7, 130 and 700
    (runs of 128 and fewer), ragged chunks, rows not 16-byte aligned
    (cap % 16 != 0: 1 and 257; 4,100 takes the byte path too), caps past
    one 2,048-slot table segment and one 8,192-slot count segment, a
    query that holds every box, a tile whose extent is 0 and one whose
    last slot is alive, chunk boxes that do not bound their members,
    with and without the extent."""
    _need_cuda()
    rng = np.random.default_rng(q + t + cap)
    qb = _boxes(rng, q, 0.2)
    tiles = _boxes(rng, t * cap, 0.1).reshape(t, cap, 4)
    tiles[torch.from_numpy(rng.random((t, cap)) < 0.2)] = torch.tensor(
        [9e9, 9e9, -9e9, -9e9])
    qb[0] = torch.tensor([-1.0, -1.0, 2.0, 2.0])   # holds every box
    c = -(-cap // CHUNK)
    if boxes == "bounding":
        pad = torch.tensor([9e9, 9e9, -9e9, -9e9]).expand(t, c * CHUNK - cap, 4)
        g = torch.cat([tiles, pad], 1).reshape(t, c, CHUNK, 4)
        cb = torch.cat([g[..., :2].amin(2), g[..., 2:].amax(2)], -1)
    else:
        cb = _boxes(rng, t * c, 0.05).reshape(t, c, 4)
    al = None
    if alive == "random":
        al = torch.from_numpy(rng.random((t, cap)) < 0.7)
    elif alive == "staged":                        # a prefix of each tile
        n = torch.from_numpy(rng.integers(0, cap + 1, t))
        n[0] = cap
        al = torch.arange(cap)[None, :] < n[:, None]
    if al is not None and t > 2:
        al[1] = False                  # extent 0
        al[2, cap - 1] = True          # extent == cap
    ext = None if al is None else ops.live_extent(al)
    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    want_c = ops.probe_counts_skip(qb, tiles, cb, alive=al)
    want_m = ops.probe_mask_skip(qb, tiles, cb, alive=al)
    assert int(want_c[0].sum()) > 0 or cap == 1
    for e in (None, ext):
        kernel.reset_launches()
        got_c = ops.probe_counts_skip(dev(qb), dev(tiles), dev(cb),
                                      alive=dev(al), extent=dev(e))
        got_m = ops.probe_mask_skip(dev(qb), dev(tiles), dev(cb),
                                    alive=dev(al), extent=dev(e))
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == dict({k: 0 for k in kernel.LAUNCHES},
                                       count_skip=1, mask_skip=1)
        assert torch.equal(got_c.cpu(), want_c), e is None
        assert torch.equal(got_m.cpu(), want_m), e is None
    kernel.reset_launches()
    v1_c = kernel.count_skip_v1(dev(qb), dev(tiles), dev(cb), alive=dev(al))
    v1_m = kernel.mask_skip_v1(dev(qb), dev(tiles), dev(cb), alive=dev(al))
    assert kernel.LAUNCHES == dict({k: 0 for k in kernel.LAUNCHES},
                                   count_skip_v1=1, mask_skip_v1=1)
    assert torch.equal(v1_c.cpu(), want_c) and torch.equal(v1_m.cpu(), want_m)


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


@pytest.mark.parametrize("order", [1, 4, 8, 16, 17, 31])
@pytest.mark.parametrize("n", [1, 3, 255, 4097, 300_001, 2**22 + 3])
def test_hilbert_encode_matches_plain_version(n, order):
    """Ragged N (a vector path's scalar tail; 300k and 4M run the
    grid-stride loop), orders of both designs (all planes at once up to
    16, the plane loop above), keys past 2**31, and a slice one element
    in (not 16-byte aligned: the scalar path); the plane-loop design
    (encode_v1) on the same inputs."""
    _need_cuda()
    rng = np.random.default_rng(n + order)
    gx, gy = (torch.from_numpy(rng.integers(0, 2**order, n).astype(np.int32))
              for _ in range(2))
    if order == 16:
        gx[0], gy[0] = 65535, 0                 # key >= 2**31
    want = core_hilbert.xy2d(gx, gy, order)
    cx, cy = gx.cuda(), gy.cuda()
    hkernel.reset_launches()
    got = hops.encode(cx, cy, order)
    torch.cuda.synchronize()
    assert hkernel.LAUNCHES == {"encode": 1, "encode_v1": 0}
    assert torch.equal(got.cpu(), want)
    assert torch.equal(hkernel.encode_v1(cx, cy, order).cpu(), want)
    if n > 1:
        assert cx[1:].data_ptr() % 16
        got = hops.encode(cx[1:], cy[1:], order)
        assert torch.equal(got.cpu(), core_hilbert.xy2d(gx[1:], gy[1:],
                                                        order))
    with pytest.raises(TypeError):
        hkernel.encode(gx.cuda().long(), gy.cuda(), order)


@pytest.mark.parametrize("br,bs", [(256, 128), (128, 128), (512, 256),
                                   (100, 96), (1024, 2048)])
@pytest.mark.parametrize("n,m", [(1, 1), (7, 5), (300, 257), (2049, 515)])
def test_mbr_join_kernels_match_plain_versions(n, m, br, bs):
    """Block counts cell by cell, and the full table padding included
    (both store widths: M_pad % 16 == 0, M_pad % 4 == 0 and neither),
    with touching boxes and sentinel padding."""
    _need_cuda()
    rng = np.random.default_rng(n * m + br)
    r, s = _boxes(rng, n, 0.1), _boxes(rng, m, 0.1)
    r[0] = torch.tensor([0.0, 0.0, 0.5, 0.5])
    s[0] = torch.tensor([0.5, 0.5, 1.0, 1.0])           # touches r[0]
    r4, s4 = mops.pad_cm(r, br), mops.pad_cm(s, bs)
    mkernel.reset_launches()
    got = mops.count_blocks(r4.cuda(), s4.cuda(), br, bs)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mops.count_blocks(r4, s4, br, bs))
    for m_pad in (s4.shape[1], s4.shape[1] + 4, s4.shape[1] + 1):
        s_odd = mops.pad_cm(s, 1)
        s_odd = torch.cat([s_odd, torch.tensor(
            [[9e9], [9e9], [-9e9], [-9e9]]).expand(4, m_pad - m)], 1)
        got = mops.mask_cm(r4.cuda(), s_odd.contiguous().cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), mops.mask_cm(r4, s_odd))
    assert mkernel.LAUNCHES == {"count": 1, "mask": 3, "rp_counts": 0,
                                "raw_counts": 0, "pair_list": 0}
    assert int(mops.join_count(r.cuda(), s.cuda(), br, bs)) == int(
        mops.join_count(r, s, br, bs))
    with pytest.raises(ValueError):
        mkernel.count(r4.cuda(), s4.cuda(), br, bs + 1)


@pytest.mark.parametrize("method", ["fg", "bsp", "slc", "bos", "str", "hc"])
def test_partition_and_join_on_cuda_match_cpu(method):
    """The slice on the card equals the plain versions on the CPU:
    partition boxes, the plan, the exact count and the raw count; hc
    launches encode, an rp join the batched rp count, a MASJ join the
    batched pair list, the raw count one batched raw count, and none the
    block-count or mask table kernels."""
    _need_cuda()
    r = spatial_gen.osm_like(6000, seed=0, device="cpu")
    s = spatial_gen.osm_like(5000, seed=1, device="cpu")
    parts = {d: papi.partition(method, torch.cat([r, s]).to(d), 400)
             for d in ("cpu", "cuda")}
    assert torch.equal(parts["cuda"].boxes.cpu(), parts["cpu"].boxes)
    hkernel.reset_launches()
    mkernel.reset_launches()
    plans = {d: join_engine.plan_join(method, r, s, 400, 1, device=d)
             for d in ("cpu", "cuda")}
    for name in ("r_tiles", "r_ids", "s_tiles", "s_ids", "tile_boxes"):
        assert torch.equal(getattr(plans["cuda"], name).cpu(),
                           getattr(plans["cpu"], name)), name
    assert plans["cuda"].stats == plans["cpu"].stats
    for fn in (lambda p: join_engine.spatial_join_count(
                   p, max_pairs_per_tile=10**6),
               lambda p: join_engine.run_join_count(p, dedup="none")):
        assert fn(plans["cuda"]) == fn(plans["cpu"])
    assert (hkernel.LAUNCHES["encode"] > 0) == (method == "hc")
    assert mkernel.LAUNCHES["raw_counts"] == 1
    assert mkernel.LAUNCHES["count"] == 0 and mkernel.LAUNCHES["mask"] == 0
    assert mkernel.LAUNCHES["pair_list" if plans["cuda"].stats["overlapping"]
                            else "rp_counts"] > 0


def _skewed_plan(method):
    """A plan of osm-like hotspots with tiles of more than one work item
    (512 rows, 1,024 columns), on the card."""
    r = spatial_gen.osm_like(40_000, seed=0, device="cpu")
    s = spatial_gen.osm_like(30_000, seed=1, device="cpu")
    plan = join_engine.plan_join(method, r, s, 3000, 1, device="cuda")
    assert (plan.live_r > 512).any() and (plan.live_s > 1024).any()
    return plan


@pytest.mark.parametrize("max_pairs", [1, 37, 10**8])
@pytest.mark.parametrize("method", ["bsp", "hc", "fg"])
def test_batched_join_kernels_match_plain_versions(method, max_pairs):
    """The rp count, the raw count and the pair list over a whole skewed
    plan, bit for bit against their plain versions on the CPU: tiles
    spanning several work items, tiles emptied on one side, live slots
    with id -1, and truncation."""
    _need_cuda()
    plan = _skewed_plan(method)
    lr, ls = plan.live_r[0].copy(), plan.live_s[0].copy()
    lr[1], ls[2] = 0, 0                        # empty on one side
    rt, st, rid, sid, tb = (a[0].clone() for a in (
        plan.r_tiles, plan.s_tiles, plan.r_ids, plan.s_ids,
        plan.tile_boxes))
    rid[3, :lr[3]:7] = -1
    sid[4, :ls[4]:5] = -1
    meta = mkernel.tile_meta(lr, ls, rt.device)
    assert meta.items > int(((lr > 0) & (ls > 0)).sum())
    cpu = [a.cpu() for a in (rt, st, rid, sid, tb, plan.universe)]
    mkernel.reset_launches()
    got = mkernel.rp_counts(rt, st, tb, plan.universe, meta)
    torch.cuda.synchronize()
    want = mops.tile_rp_counts(cpu[0], cpu[1], cpu[4], cpu[5], lr, ls)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 0
    got = mkernel.raw_counts(rt, st, meta)
    torch.cuda.synchronize()
    raw = mops.tile_raw_counts(cpu[0], cpu[1], lr, ls)
    assert torch.equal(got.cpu(), raw) and (raw >= want).all()
    assert not raw[1] and not raw[2]
    got = mkernel.pair_list(rt, st, rid, sid, meta, max_pairs)
    torch.cuda.synchronize()
    want = mops.tile_pair_list(*cpu[:4], lr, ls, max_pairs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (want[2] > max_pairs).any() == (max_pairs < 10**8)
    assert mkernel.LAUNCHES == {"count": 0, "mask": 0, "rp_counts": 1,
                                "raw_counts": 1, "pair_list": 1}


def test_join_launches_do_not_grow_with_the_tiles():
    """One rp-count launch a run_join_count(dedup="rp"), one raw-count
    launch a run_join_count(dedup="none"), one pair list a MASJ join, and
    no block-count or table kernel on either count."""
    _need_cuda()
    for method, name in (("bsp", "rp_counts"), ("hc", "pair_list")):
        plan = _skewed_plan(method)
        assert plan.r_tiles.shape[1] > 8
        mkernel.reset_launches()
        if name == "rp_counts":
            join_engine.run_join_count(plan, dedup="rp")
            join_engine.run_join_count(plan, dedup="none")
            assert mkernel.LAUNCHES == {"count": 0, "mask": 0,
                                        "rp_counts": 1, "raw_counts": 1,
                                        "pair_list": 0}
        join_engine.spatial_join_count(plan, max_pairs_per_tile=10**8)
        assert mkernel.LAUNCHES["mask"] == 0
        assert mkernel.LAUNCHES[name] == (2 if name == "rp_counts" else 1)


def test_hilbert_local_index_on_cuda_matches_cpu():
    _need_cuda()
    mbrs = spatial_gen.osm_like(20_000, seed=0, device="cpu")
    qb = _boxes(np.random.default_rng(3), 64, 0.03)
    srv = {d: SpatialServer.from_method("hc", mbrs, 256,
                                        ServeConfig(local_index="hilbert"),
                                        device=d)
           for d in ("cpu", "cuda")}
    assert torch.equal(srv["cuda"].layout.ids.cpu(), srv["cpu"].layout.ids)
    want = srv["cpu"].range_counts(qb)
    got = srv["cuda"].range_counts(qb)
    assert torch.equal(got[0].cpu(), want[0]) and got[1] == want[1]


INGEST_FIELDS = ("canon_tiles", "ids", "alive", "probe_boxes",
                 "chunk_boxes", "uni")


def _centre_burst(parts, m):
    """``m`` coincident objects at the centre of tile 0's region."""
    tb = parts.boxes[0].cpu().numpy()
    ctr = [(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2]
    return np.tile(np.asarray(ctr + ctr, np.float32), (m, 1))


@pytest.mark.parametrize("local_index", ["x", "hilbert", "off"])
def test_ingest_stream_on_cuda_matches_cpu(local_index):
    """Appends, deletes, updates, a forced compaction, an overflow
    re-stage and churn after it on the card: after every command the
    staging, the live extent, the report and the stats equal the plain
    versions' on the CPU; the extent covers every alive slot, tightly
    after compaction and re-stage; the answers equal the CPU's.  The
    "hilbert" compaction launches the encode."""
    _need_cuda()
    mbrs = spatial_gen.osm_like(6000, seed=3, device="cpu")
    parts = papi.partition("bsp", mbrs, 256)
    cfg = ServeConfig(local_index=local_index, slack=128)
    srv = {d: SpatialServer(parts, mbrs, cfg, device=d)
           for d in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    live = np.arange(6000)

    def pick(k):
        return rng.choice(live, size=k, replace=False)

    stream = [("append", 500), ("delete", 800), ("update", 300),
              ("append", 400), ("compact",), ("burst",), ("delete", 500),
              ("update", 100)]
    for op in stream:
        if op[0] == "append":
            nb = _boxes(rng, op[1], 0.004).numpy()
            call = lambda s: s.append(nb)  # noqa: E731
        elif op[0] == "delete":
            ids = pick(op[1])
            live = np.setdiff1d(live, ids)
            call = lambda s: s.delete(ids)  # noqa: E731
        elif op[0] == "update":
            ids, nb = pick(op[1]), _boxes(rng, op[1], 0.004).numpy()
            call = lambda s: s.update(ids, nb)  # noqa: E731
        elif op[0] == "compact":
            call = lambda s: s.compact()  # noqa: E731
        else:
            nb = _centre_burst(parts, srv["cpu"].stats["cap"] + 1)
            call = lambda s: s.append(nb)  # noqa: E731
        hkernel.reset_launches()
        want, got = call(srv["cpu"]), call(srv["cuda"])
        assert got == want and srv["cuda"].stats == srv["cpu"].stats
        if op[0] == "append":
            live = np.concatenate([live, np.arange(got["n_total"] - len(nb),
                                                   got["n_total"])])
        for name in INGEST_FIELDS:
            w = getattr(srv["cpu"].layout, name)
            g = getattr(srv["cuda"].layout, name)
            assert (w is None and g is None) or torch.equal(g.cpu(), w), name
        ext = srv["cuda"].tiles.extent
        assert torch.equal(ext.cpu(), srv["cpu"].tiles.extent)
        tight = ops.live_extent(srv["cuda"].layout.alive)
        assert bool((ext >= tight).all())
        if op[0] == "compact" or got["restaged"]:
            assert torch.equal(ext, tight)
        if local_index == "hilbert" and op[0] == "compact":
            assert hkernel.LAUNCHES["encode"] == 1
    qb = _boxes(np.random.default_rng(5), 64, 0.03)
    pts = torch.from_numpy(
        np.random.default_rng(6).random((32, 2)).astype(np.float32))
    for fn in (lambda s: s.range_counts(qb),
               lambda s: s.range_ids(qb, max_hits=64),
               lambda s: s.knn(pts, 5, max_cand=8192)):
        want, got = fn(srv["cpu"]), fn(srv["cuda"])
        for g, w in zip(got[:-1], want[:-1]):
            assert torch.equal(g.cpu(), w)
        assert got[-1] == want[-1]


def _plain(fn, *args, **kw):
    """``fn`` on CPU copies of its tensor arguments: the plain version."""
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa
    return fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})


def test_delete_heavy_stream_keeps_probes_exact_past_a_stale_extent():
    """Appends, then deletes of 70% of the ids with compaction off: the
    extent stays stale-large on most tiles, and the routed, dense and
    dense-skip counts and hit lists given it equal their plain versions,
    the server's pruned and dense answers equal each other and the
    brute force on the live set."""
    _need_cuda()
    mbrs = spatial_gen.osm_like(20_000, seed=5, device="cpu")
    base, extra = mbrs[:16_000], mbrs[16_000:]
    parts = papi.partition("bsp", base, 256)
    srv = SpatialServer(parts, base, ServeConfig(slack=2048,
                                                 compact_dead_frac=None),
                        device="cuda")
    for i in range(0, 4000, 1000):
        assert not srv.append(extra[i:i + 1000])["restaged"]
    rng = np.random.default_rng(6)
    dead = rng.choice(20_000, 14_000, replace=False)
    for chunk in np.array_split(dead, 4):
        srv.delete(chunk)
    live = np.setdiff1d(np.arange(20_000), dead)
    lay, ext = srv.layout, srv.tiles.extent
    tight = ops.live_extent(lay.alive)
    assert bool((ext >= tight).all()) and int((ext > tight).sum()) > 0
    q = _boxes(rng, 300, 0.03).cuda()
    hit = router.probe_overlap(lay.probe_boxes, q)
    cand = router.candidates_from_overlap(
        hit, max(1, int(hit.sum(1).max())))[0].contiguous()
    tiles, cb, alive = lay.canon_tiles, lay.chunk_boxes, lay.alive
    for fn, args in [(ops.gathered_counts, (q, tiles, cand)),
                     (ops.gathered_counts_skip, (q, tiles, cb, cand)),
                     (ops.gathered_hit_list, (q, tiles, cand)),
                     (ops.gathered_hit_list_skip, (q, tiles, cb, cand)),
                     (ops.probe_counts, (q, tiles)),
                     (ops.probe_counts_skip, (q, tiles, cb)),
                     (ops.probe_mask_skip, (q, tiles, cb)),
                     (ops.dense_hit_list, (q, tiles))]:
        got = fn(*args, alive=alive, extent=ext)
        want = _plain(fn, *args, alive=alive)
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            assert torch.equal(g.cpu(), w), fn.__name__
    counts = srv.range_counts(q)[0]
    assert torch.equal(counts, srv.range_counts(q, pruned=False)[0])
    live_boxes = mbrs[live].numpy()
    ref = range_mod.range_query_ref(live_boxes, q.cpu().numpy())
    assert counts.tolist() == [len(r) for r in ref]
    hid, _, ovf, _ = srv.range_ids(q, max_hits=4096)
    assert not ovf.any()
    for row, r in zip(hid.cpu().numpy(), ref):
        np.testing.assert_array_equal(row[row >= 0], np.sort(live[r]))


def test_append_past_the_old_extent_needs_the_raise():
    """An appended object lands past its tile's staged extent: the
    maintained extent rose to cover it, and the count and hit-list
    kernels given the staged (now stale-small) extent would miss it."""
    _need_cuda()
    mbrs = spatial_gen.osm_like(8000, seed=7, device="cpu")
    parts = papi.partition("bsp", mbrs, 256)
    srv = SpatialServer(parts, mbrs, ServeConfig(slack=256,
                                                 local_index="off"),
                        device="cuda")
    old = srv.tiles.extent.clone()
    new = _centre_burst(parts, 1)
    new[:, 2:] += 1e-6
    assert not srv.append(new)["restaged"]
    t, s = (int(v) for v in srv.tiles._canon_slot[8000])
    ext = srv.tiles.extent
    assert s >= int(old[t]) and int(ext[t]) == s + 1
    lay = srv.layout
    q = torch.from_numpy(new).cuda()
    cand = torch.tensor([[t]], dtype=torch.int32, device="cuda")
    want = _plain(ops.gathered_counts, q, lay.canon_tiles, cand,
                  alive=lay.alive)
    assert torch.equal(ops.gathered_counts(q, lay.canon_tiles, cand,
                                           alive=lay.alive,
                                           extent=ext).cpu(), want)
    stale = ops.gathered_counts(q, lay.canon_tiles, cand, alive=lay.alive,
                                extent=old)
    assert int(stale.sum()) == int(want.sum()) - 1
    hits = ops.gathered_hit_list(q, lay.canon_tiles, cand, alive=lay.alive,
                                 extent=ext)
    assert (t, s) in set(zip(hits[1].tolist(), hits[2].tolist()))
    stale = ops.gathered_hit_list(q, lay.canon_tiles, cand,
                                  alive=lay.alive, extent=old)
    assert (t, s) not in set(zip(stale[1].tolist(), stale[2].tolist()))
    dense = ops.probe_counts(q, lay.canon_tiles, alive=lay.alive, extent=old)
    assert int(dense.sum()) == int(srv.range_counts(q)[0].sum()) - 1
    assert 8000 in set(srv.range_ids(q, max_hits=64)[0][0].tolist())


@pytest.mark.parametrize("h,g,chunk,p,s", [
    (64, 1, 128, 64, 128),      # Mamba2-1.3B's widths
    (4, 2, 128, 32, 64), (6, 3, 64, 16, 32), (8, 1, 128, 128, 128),
    (4, 4, 8, 4, 4), (4, 2, 8, 36, 20), (2, 1, 64, 100, 124)])
@pytest.mark.parametrize("batch,l", [(1, 256), (2, 1024)])
def test_ssd_intra_chunk_kernel_matches_plain_version(h, g, chunk, p, s,
                                                      batch, l):
    """Grouped heads, every chunk width and run split the wrapper picks
    (1,024 chunks keep whole groups a block; 2 chunks split them), widths
    that are not multiples of the tensor-core tiles (chunk 8, P 36 and
    100, S 20 and 124), and the FFMA design beside it."""
    _need_cuda()
    rng = np.random.default_rng(h + g + chunk + p + s + l)
    x = torch.from_numpy(rng.standard_normal((batch, l, h, p)).astype(
        np.float32))
    dt = torch.from_numpy((np.logaddexp(rng.standard_normal(
        (batch, l, h)), 0) * 0.1).astype(np.float32))
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(
        np.float32)) * 0.3)
    cl = torch.cumsum((dt * a).reshape(batch, l // chunk, chunk, h),
                      2).reshape(batch, l, h)
    b, c = (torch.from_numpy((rng.standard_normal((batch, l, g, s)) * 0.3)
                             .astype(np.float32)) for _ in range(2))
    want = sref.intra_chunk_grouped(x, dt, cl, b, c, chunk)
    skernel.reset_launches()
    got = skernel.intra_chunk(*(t.cuda() for t in (x, dt, cl, b, c)), chunk)
    torch.cuda.synchronize()
    assert skernel.LAUNCHES["intra_chunk"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    got = skernel.intra_chunk_v1(*(t.cuda() for t in (x, dt, cl, b, c)),
                                 chunk)
    torch.cuda.synchronize()
    assert skernel.LAUNCHES == {"intra_chunk": 1, "intra_chunk_v1": 1}
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    y = sops.ssd_forward(*(t.cuda() for t in (x, dt, a, b, c)), chunk=chunk)
    torch.testing.assert_close(
        y.cpu(), sops.ssd_forward(x, dt, a, b, c, chunk=chunk),
        rtol=1e-5, atol=1e-5)
    assert skernel.LAUNCHES["intra_chunk"] == 2
    assert skernel.LAUNCHES["intra_chunk_v1"] == 1
    with pytest.raises(ValueError):
        skernel.intra_chunk(*(t.cuda() for t in (x, dt, cl, b, c)), 12)
    with pytest.raises(RuntimeError, match="IntraChunk"):
        skernel.intra_chunk(x.cuda().requires_grad_(True), dt.cuda(),
                            cl.cuda(), b.cuda(), c.cuda(), chunk)


@pytest.mark.parametrize("batch,l,h,g,p,s", [
    (2, 2048, 64, 1, 64, 128),     # Mamba2-1.3B's widths, a training batch
    (1, 256, 4, 2, 36, 20)])
def test_intra_chunk_function_matches_plain_forward_and_backward(
        batch, l, h, g, p, s):
    """IntraChunk launches the kernel once forward (within 2e-5 of the
    plain version) and its input gradients equal autograd's through the
    plain version on the card bit for bit: the backward recomputes that
    same graph.  ssd_forward's gradients on the card match the CPU's."""
    _need_cuda()
    rng = np.random.default_rng(l + h + p)
    x = rng.standard_normal((batch, l, h, p)) * 0.5
    dt = np.logaddexp(rng.standard_normal((batch, l, h)), 0) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.3)
    b, c = (rng.standard_normal((batch, l, g, s)) * 0.3 for _ in range(2))
    gy = rng.standard_normal((batch, l, h, p))
    x, dt, a, b, c, gy = (torch.from_numpy(t.astype(np.float32)).cuda()
                          for t in (x, dt, a, b, c, gy))
    cl = torch.cumsum((dt * a).reshape(batch, l // CHUNK, CHUNK, h),
                      2).reshape(batch, l, h)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, cl, b, c)]
        y = fn(*ins)
        return y.detach(), torch.autograd.grad(y, ins, gy)

    skernel.reset_launches()
    y, got = grads(lambda *t: sops.IntraChunk.apply(*t, CHUNK))
    assert skernel.LAUNCHES == {"intra_chunk": 1, "intra_chunk_v1": 0}
    y_plain, want = grads(lambda *t: sref.intra_chunk_grouped(*t, CHUNK))
    torch.testing.assert_close(y, y_plain, rtol=2e-5, atol=2e-5)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    (sops.ssd_forward(*ins) * gy).sum().backward()
    assert skernel.LAUNCHES["intra_chunk"] == 2
    cpu = [t.detach().cpu().requires_grad_(True) for t in (x, dt, a, b, c)]
    (sops.ssd_forward(*cpu) * gy.cpu()).sum().backward()
    for t, u in zip(ins, cpu):
        torch.testing.assert_close(t.grad.cpu(), u.grad, rtol=1e-4,
                                   atol=1e-4 * float(u.grad.abs().max()))


def test_mamba2_train_step_on_cuda_matches_cpu():
    """Two float32 train steps at the smoke config, card against CPU;
    remat "full" launches the kernel twice a layer a step."""
    _need_cuda()
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import api, convert
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(configs.smoke("mamba2_1p3b"), dtype="float32")
    opt = adamw.AdamWConfig(warmup=0)
    states, steps = {}, {}
    for d in ("cpu", "cuda"):
        model = api.build(cfg, d)
        states[d] = api.init_train_state(model, torch.Generator().manual_seed(
            0), opt) if d == "cpu" else None
        steps[d] = api.make_train_step(model, opt)
    tree = convert.params_to_numpy(states["cpu"].params, cfg)
    states["cuda"] = api.TrainState(
        params=convert.params_from_numpy(tree, cfg, "cuda").requires_grad_(
            True),
        opt=adamw.init_state({k: p.cuda() for k, p in
                              states["cpu"].opt.m.items()}, opt),
        step=torch.zeros((), dtype=torch.int32, device="cuda"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    skernel.reset_launches()
    for _ in range(2):
        metrics = {d: steps[d](states[d], {"tokens": toks.to(d)})[1]
                   for d in ("cpu", "cuda")}
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(metrics["cuda"][k].cpu(),
                                       metrics["cpu"][k], rtol=1e-4,
                                       atol=0)
    assert skernel.LAUNCHES["intra_chunk"] == 2 * 2 * cfg.n_layers


def test_mamba2_on_cuda_matches_cpu():
    """The smoke config in float32: prefill logits through the kernel and
    greedy tokens through the recurrence, card against CPU."""
    _need_cuda()
    import copy
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
    cfg = dataclasses.replace(configs.smoke("mamba2_1p3b"), dtype="float32")
    models = {d: api.build(cfg, d) for d in ("cpu", "cuda")}
    params = {"cpu": models["cpu"].init_params(
        torch.Generator().manual_seed(0))}
    params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 200)))
    skernel.reset_launches()
    got = api.make_prefill_step(models["cuda"])(params["cuda"],
                                                {"tokens": toks.cuda()})
    assert skernel.LAUNCHES["intra_chunk"] == cfg.n_layers
    want = api.make_prefill_step(models["cpu"])(params["cpu"],
                                                {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    gen = {d: serve.generate(models[d], params[d], toks[:, :8].to(d), 8)
           for d in ("cpu", "cuda")}
    assert torch.equal(gen["cuda"].cpu(), gen["cpu"])


@pytest.mark.parametrize("arch", ["gemma2_27b", "stablelm_12b", "qwen15_4b",
                                  "command_r_35b", "whisper_medium",
                                  "mixtral_8x22b", "arctic_480b",
                                  "internvl2_26b", "recurrentgemma_9b"])
def test_model_family_on_cuda_matches_cpu(arch):
    """Each family's smoke config in float32 (MoE at capacity factor 16):
    prefill logits and 8 decode steps' logits, card against CPU; no
    kernel launches (these paths have none)."""
    _need_cuda()
    import copy
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import api, encdec
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              capacity_factor=16.0)
    models = {d: api.build(cfg, d) for d in ("cpu", "cuda")}
    params = {"cpu": models["cpu"].init_params(
        torch.Generator().manual_seed(0))}
    params["cuda"] = copy.deepcopy(params["cpu"]).to("cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
    if cfg.family == "vlm":
        batch["img"] = torch.randn(2, cfg.vis_tokens, cfg.vis_dim)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.src_len, cfg.d_model)
    skernel.reset_launches()
    kernel.reset_launches()
    got = api.make_prefill_step(models["cuda"])(
        params["cuda"], {k: v.cuda() for k, v in batch.items()})
    want = api.make_prefill_step(models["cpu"])(params["cpu"], batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = {}
    for d in ("cpu", "cuda"):
        if cfg.family == "encdec":
            caches[d] = encdec.init_cache(params[d], batch["frames"].to(d),
                                          cfg, 8)
        else:
            caches[d] = models[d].init_cache(2, 8)
    with torch.no_grad():
        for pos in range(8):
            logits = {}
            for d in ("cpu", "cuda"):
                logits[d], caches[d] = models[d].decode_step(
                    params[d], caches[d], batch["tokens"][:, pos].to(d), pos)
            torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                       rtol=1e-4, atol=1e-4)
    assert not any(skernel.LAUNCHES.values())
    assert not any(kernel.LAUNCHES.values())


@pytest.mark.parametrize("arch", ["gemma2_27b", "stablelm_12b", "qwen15_4b",
                                  "command_r_35b", "whisper_medium",
                                  "mixtral_8x22b", "arctic_480b",
                                  "internvl2_26b", "recurrentgemma_9b"])
def test_family_train_step_on_cuda_matches_cpu(arch):
    """Each family's smoke config in float32, TF32 off: the loss within
    1e-5 relative and every gradient within 1e-5 of its largest, then a
    train step's loss, grad_norm and lr, and the parameters within 2 lr
    (Adam's first step is sign-like), card against CPU; no kernel
    launches."""
    _need_cuda()
    import copy
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import api, lm
    from repro_torch.optim import adamw
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        opt = adamw.AdamWConfig(warmup=0)
        models = {d: api.build(cfg, d) for d in ("cpu", "cuda")}
        states = {"cpu": api.init_train_state(
            models["cpu"], torch.Generator().manual_seed(0), opt)}
        states["cuda"] = copy.deepcopy(states["cpu"])
        states["cuda"].params.to("cuda")
        states["cuda"].opt = adamw.init_state(
            lm.named_leaves(states["cuda"].params, cfg), opt)
        states["cuda"].step = states["cuda"].step.cuda()
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32))}
        if cfg.family == "vlm":
            batch["img"] = torch.randn(2, cfg.vis_tokens, cfg.vis_dim)
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(2, cfg.src_len, cfg.d_model)
        skernel.reset_launches()
        kernel.reset_launches()
        out = {}
        for d in ("cpu", "cuda"):
            b = {k: v.to(d) for k, v in batch.items()}
            loss, _ = models[d].loss_fn(states[d].params, b)
            named = lm.named_leaves(states[d].params, cfg)
            grads = torch.autograd.grad(loss, list(named.values()))
            out[d] = (float(loss.detach()), dict(zip(named, grads)))
        assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(
            out["cpu"][0])
        for k, g in out["cpu"][1].items():
            assert float((out["cuda"][1][k].cpu() - g).abs().max()) <= \
                1e-5 * float(g.abs().max()), k
        metrics = {}
        for d in ("cpu", "cuda"):
            states[d], metrics[d] = api.make_train_step(models[d], opt)(
                states[d], {k: v.to(d) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k])) \
                <= 1e-5 * abs(float(metrics["cpu"][k])), k
        assert abs(float(metrics["cuda"]["lr"]) - float(
            metrics["cpu"]["lr"])) <= 1e-6 * float(metrics["cpu"]["lr"])
        lr = float(metrics["cpu"]["lr"])
        for (k, a), (_, c) in zip(
                states["cpu"].params.named_parameters(),
                states["cuda"].params.named_parameters()):
            assert float((c.detach().cpu() - a.detach()).abs().max()) <= \
                2 * lr + 1e-7, k
        assert not any(skernel.LAUNCHES.values())
        assert not any(kernel.LAUNCHES.values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# -- the sharded placement (owners simulated on the card) ---------------------

SHARD_FIELDS = ("canon_shards", "id_shards", "alive_shards", "chunk_shards",
                "probe_boxes", "chunk_boxes", "uni")


def _assert_same_shards(a, b):
    """Server ``a`` (the card) holds server ``b``'s (the CPU's) shards,
    owner maps, extent and stats."""
    for name in SHARD_FIELDS:
        w, g = getattr(b.slayout, name), getattr(a.slayout, name)
        assert (w is None and g is None) or torch.equal(g.cpu(), w), name
    assert (a.slayout.owner == b.slayout.owner).all()
    assert (a.slayout.local == b.slayout.local).all()
    assert torch.equal(a.tiles.extent.cpu(), b.tiles.extent)
    assert a.stats == b.stats


def _sharded_pair(local_index, n=6000, shards=3, **cfg):
    mbrs = spatial_gen.osm_like(n, seed=3, device="cpu")
    parts = papi.partition("bsp", mbrs, 256)
    config = ServeConfig(placement="sharded", shards=shards,
                         local_index=local_index, **cfg)
    return parts, mbrs, {d: SpatialServer(parts, mbrs, config, device=d)
                         for d in ("cpu", "cuda")}


def _answers_equal(srv, qb, pts, pruned=None):
    out = {}
    for d, s in srv.items():
        out[d] = [s.range_counts(qb.to(d), pruned=pruned),
                  s.range_ids(qb.to(d), max_hits=64, pruned=pruned),
                  s.knn(pts.to(d), 5, pruned=pruned)]
    for got, want in zip(out["cuda"], out["cpu"]):
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert g == w
            else:
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("local_index", ["x", "hilbert", "off"])
def test_sharded_batches_on_cuda_match_cpu(local_index):
    """Three owners on the card: shards, maps, extent and stats equal
    the CPU's; routed and dense counts, ids and kNN (ids, d2, flags,
    stats) equal the plain versions' answers, and a counts batch
    launches the routed count kernel once."""
    _need_cuda()
    _, _, srv = _sharded_pair(local_index)
    _assert_same_shards(srv["cuda"], srv["cpu"])
    qb = _boxes(np.random.default_rng(5), 96, 0.03)
    pts = torch.from_numpy(
        np.random.default_rng(6).random((40, 2)).astype(np.float32))
    for pruned in (None, False):
        _answers_equal(srv, qb, pts, pruned)
    kernel.reset_launches()
    srv["cuda"].range_counts(qb.cuda())
    name = "gather_count" if local_index == "off" else "gather_count_skip"
    assert kernel.LAUNCHES[name] == 1 and sum(kernel.LAUNCHES.values()) == 1


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_folded_launch_equals_a_loop_over_owners_on_the_kernels(local_index):
    """Every owner's received messages probed in one launch over the flat
    (D·T_rows) shards equal one launch an owner on its own shard:
    counts, hit lists and the kNN refinement, on the kernels."""
    _need_cuda()
    from repro_torch.serve import exchange, layout
    _, _, srv = _sharded_pair(local_index, shards=4)
    s = srv["cuda"]
    qb = _boxes(np.random.default_rng(7), 128, 0.04).cuda()
    cand, costs, _ = s._route_batch(qb)
    slots, ss, sc, _ = s.tiles._exchange_plan(cand, costs)
    comm, sh = exchange._Comm(None), s.tiles._shards()
    qp = layout._pack_rows(qb, slots, layout._SENTINEL)
    qr = comm.exchange(exchange._gather_send(
        qp, ss, torch.from_numpy(layout._SENTINEL).cuda()))
    cr = comm.exchange(sc)
    flat = comm.fold(cr, sh.t_rows)
    q = qr.reshape(-1, 4)
    lay = s.slayout
    own = [dict(tiles=lay.canon_shards[o], ids=lay.id_shards[o],
                cb=None if lay.chunk_shards is None else lay.chunk_shards[o],
                alive=lay.alive_shards[o], extent=s.tiles.extent[o],
                q=qr[o].reshape(-1, 4), cand=cr[o].reshape(-1, cr.shape[-1]))
           for o in range(4)]
    kernel.reset_launches()
    folded = range_mod.pruned_range_counts(q, sh.tiles, flat,
                                           chunk_boxes=sh.cboxes,
                                           alive=sh.alive, extent=sh.extent)
    assert sum(kernel.LAUNCHES.values()) == 1
    loop = [range_mod.pruned_range_counts(o["q"], o["tiles"], o["cand"],
                                          chunk_boxes=o["cb"],
                                          alive=o["alive"],
                                          extent=o["extent"]) for o in own]
    assert torch.equal(folded, torch.cat(loop))
    folded = range_mod.pruned_range_ids(q, sh.tiles, sh.ids, flat, 32,
                                        chunk_boxes=sh.cboxes, alive=sh.alive,
                                        extent=sh.extent)
    loop = [range_mod.pruned_range_ids(o["q"], o["tiles"], o["ids"],
                                       o["cand"], 32, chunk_boxes=o["cb"],
                                       alive=o["alive"], extent=o["extent"])
            for o in own]
    for j in range(3):
        assert torch.equal(folded[j], torch.cat([x[j] for x in loop]))
    pts = (q[:, :2] + q[:, 2:]) * 0.5
    re = (torch.arange(q.shape[0], device="cuda") % 5).float() * 0.01
    folded = knn_mod.knn_partial(pts, sh.tiles, sh.ids, flat, re, 5,
                                 chunk_boxes=sh.cboxes, alive=sh.alive,
                                 extent=sh.extent)
    m = q.shape[0] // 4
    loop = [knn_mod.knn_partial(pts[i * m:(i + 1) * m], o["tiles"], o["ids"],
                                o["cand"], re[i * m:(i + 1) * m], 5,
                                chunk_boxes=o["cb"], alive=o["alive"],
                                extent=o["extent"])
            for i, o in enumerate(own)]
    for j in range(3):
        assert torch.equal(folded[j], torch.cat([x[j] for x in loop]))


def _stream(srv, parts, stream, rng, live):
    """Run ``stream`` on the CPU and the card server alike; after each
    command the shards, extent, report and stats agree and every shard
    row's extent covers its alive slots."""
    for op in stream:
        if op[0] == "append":
            nb = _boxes(rng, op[1], 0.004).numpy()
            call = lambda s: s.append(nb)  # noqa: E731
        elif op[0] in ("delete", "update"):
            ids = rng.choice(live, size=op[1], replace=False)
            if op[0] == "delete":
                live = np.setdiff1d(live, ids)
                call = lambda s: s.delete(ids)  # noqa: E731
            else:
                nb = _boxes(rng, op[1], 0.004).numpy()
                call = lambda s: s.update(ids, nb)  # noqa: E731
        elif op[0] == "compact":
            call = lambda s: s.compact()  # noqa: E731
        else:
            nb = _centre_burst(parts, srv["cpu"].stats["cap"] + 1)
            call = lambda s: s.append(nb)  # noqa: E731
        want, got = call(srv["cpu"]), call(srv["cuda"])
        assert {k: v for k, v in got.items() if k != "bytes_transferred"} \
            == {k: v for k, v in want.items() if k != "bytes_transferred"}
        _assert_same_shards(srv["cuda"], srv["cpu"])
        ext = srv["cuda"].tiles.extent
        tight = ops.live_extent(
            srv["cuda"].slayout.alive_shards.flatten(0, 1)).view(ext.shape)
        assert bool((ext >= tight).all())
        if op[0] == "compact" or got["restaged"]:
            assert torch.equal(ext, tight)
        if op[0] == "append":
            live = np.concatenate([live, np.arange(got["n_total"] - len(nb),
                                                   got["n_total"])])
    return live


@pytest.mark.parametrize("local_index", ["x", "off"])
def test_sharded_ingest_stream_on_cuda_matches_cpu(local_index):
    """Appends, deletes, an update, a forced compaction, an overflow
    re-stage that re-balances the owners and churn after it, four owners
    on the card against the CPU; then the answers."""
    _need_cuda()
    parts, _, srv = _sharded_pair(local_index, shards=4, slack=128)
    stream = [("append", 500), ("delete", 800), ("update", 300),
              ("append", 400), ("compact",), ("burst",), ("delete", 500),
              ("update", 100)]
    _stream(srv, parts, stream, np.random.default_rng(4), np.arange(6000))
    assert "moved_tiles" in srv["cuda"].stats
    qb = _boxes(np.random.default_rng(5), 64, 0.03)
    pts = torch.from_numpy(
        np.random.default_rng(6).random((32, 2)).astype(np.float32))
    for pruned in (None, False):
        _answers_equal(srv, qb, pts, pruned)


def test_sharded_delete_heavy_stream_stays_exact_past_a_stale_extent():
    """Appends, then deletes of 70% of the ids with compaction off: most
    shard rows keep a stale-large extent, and the card's pruned and
    dense answers equal the CPU's and the brute force on the live set."""
    _need_cuda()
    parts, mbrs, srv = _sharded_pair("x", n=12_000, shards=4, slack=2048,
                                     compact_dead_frac=None)
    rng = np.random.default_rng(8)
    live = _stream(srv, parts, [("append", 3000), ("delete", 10_500)], rng,
                   np.arange(12_000))
    ext = srv["cuda"].tiles.extent
    tight = ops.live_extent(
        srv["cuda"].slayout.alive_shards.flatten(0, 1)).view(ext.shape)
    assert int((ext > tight).sum()) > ext.numel() // 4
    qb = _boxes(np.random.default_rng(9), 128, 0.05)
    pts = torch.from_numpy(
        np.random.default_rng(10).random((48, 2)).astype(np.float32))
    for pruned in (None, False):
        _answers_equal(srv, qb, pts, pruned)
    srv["cpu"].tiles._ensure_mirror()
    boxes = torch.from_numpy(srv["cpu"].tiles._canon_np[
        srv["cpu"].tiles._alive_np])
    ids = torch.from_numpy(srv["cpu"].tiles._ids_np[
        srv["cpu"].tiles._alive_np])
    hit = ((qb[:, None, 0] <= boxes[None, :, 2])
           & (boxes[None, :, 0] <= qb[:, None, 2])
           & (qb[:, None, 1] <= boxes[None, :, 3])
           & (boxes[None, :, 1] <= qb[:, None, 3]))
    assert torch.equal(srv["cuda"].range_counts(qb.cuda())[0].cpu(),
                       hit.sum(1, dtype=torch.int32))
    assert set(ids.tolist()) == set(live.tolist())


@pytest.mark.parametrize("method", ["bsp", "hc"])
def test_multi_device_plan_on_cuda_counts_as_one_device(method):
    """A 4-device plan's tiles run in one batched launch on the card and
    count what the one-device plan counts (rp or MASJ pairs)."""
    _need_cuda()
    rng = np.random.default_rng(11)
    r, s = _boxes(rng, 5000, 0.01), _boxes(rng, 4000, 0.01)
    counts = []
    for d in (1, 4):
        plan = join_engine.plan_join(method, r, s, 300, d, device="cuda")
        mkernel.reset_launches()
        counts.append(join_engine.spatial_join_count(
            plan, max_pairs_per_tile=1 << 14))
        assert mkernel.LAUNCHES["rp_counts" if method == "bsp"
                                else "pair_list"] == 1
        counts.append(join_engine.run_join_count(plan, dedup="none"))
    assert counts[0] == counts[2] and counts[1] == counts[3]
    plan = join_engine.plan_join(method, r, s, 300, 1, device="cpu")
    assert counts[0] == join_engine.spatial_join_count(
        plan, max_pairs_per_tile=1 << 14)


# -- the heat placement and the request plane on the card ----------------------

def _assert_replicas_equal_primaries(srv):
    """Every replica row is its primary's row on the card: boxes, ids,
    alive, chunk boxes and the live extent."""
    s = srv.slayout
    reps = np.flatnonzero(s.rep_owner >= 0)
    assert reps.size
    ro, rl = torch.from_numpy(s.rep_owner[reps]), torch.from_numpy(
        s.rep_local[reps])
    po, pl = torch.from_numpy(s.owner[reps]), torch.from_numpy(s.local[reps])
    for a in (s.canon_shards, s.id_shards, s.alive_shards, s.chunk_shards,
              srv.tiles.extent):
        if a is not None:
            assert torch.equal(a[ro, rl], a[po, pl])


def test_heat_server_on_cuda_matches_cpu():
    """A heat server (4 owners, 8 replicas an owner) on the card against
    the same server on the CPU: cold, through a rebalance on hot
    traffic, then an ingest stream through the replicas (appends,
    deletes, an update, a forced compaction, an overflow re-stage);
    after every step the maps, replica maps, shards, extent, stats and
    answers agree and every replica row equals its primary."""
    _need_cuda()
    from repro_torch.serve import PlacementPolicy
    mbrs = spatial_gen.osm_like(6000, seed=3, device="cpu")
    parts = papi.partition("bsp", mbrs, 256)
    config = ServeConfig(placement="heat", shards=4, slack=128,
                         policy=PlacementPolicy(heat_decay=0.85,
                                                replicate_top=8))
    srv = {d: SpatialServer(parts, mbrs, config, device=d)
           for d in ("cpu", "cuda")}
    rng = np.random.default_rng(12)
    c = 0.4 + rng.random((96, 2)) * 0.2
    s = rng.random((96, 2)) * 0.05
    qb = torch.from_numpy(np.concatenate([c - s, c + s], -1).astype(
        np.float32))
    pts = torch.from_numpy(rng.random((32, 2)).astype(np.float32))
    for step in ("cold", "rebalanced"):
        _assert_same_shards(srv["cuda"], srv["cpu"])
        for name in ("rep_owner", "rep_local"):
            assert (getattr(srv["cuda"].slayout, name)
                    == getattr(srv["cpu"].slayout, name)).all()
        _assert_replicas_equal_primaries(srv["cuda"])
        for pruned in (None, False):
            _answers_equal(srv, qb, pts, pruned)
        if step == "cold":
            reports = [srv[d].rebalance() for d in ("cpu", "cuda")]
            assert reports[0] == reports[1]
    stream = [("append", 500), ("delete", 800), ("update", 300),
              ("compact",), ("burst",), ("delete", 300)]
    _stream(srv, parts, stream, np.random.default_rng(4), np.arange(6000))
    assert srv["cuda"].stats["restages"] == 1
    _assert_replicas_equal_primaries(srv["cuda"])
    for pruned in (None, False):
        _answers_equal(srv, qb, pts, pruned)


@pytest.mark.parametrize("placement", ["replicated", "heat"])
def test_frontend_padded_batches_on_cuda_equal_direct_calls(placement):
    """The request plane's padded batches on the card: every kind, at
    two ladder widths, equals a direct unpadded call on the card and the
    CPU server's answers; the responses hold host numpy only."""
    _need_cuda()
    from repro_torch.serve import PlacementPolicy, frontend
    mbrs = spatial_gen.osm_like(6000, seed=3, device="cpu")
    parts = papi.partition("bsp", mbrs, 256)
    config = (ServeConfig() if placement == "replicated" else ServeConfig(
        placement="heat", shards=4, policy=PlacementPolicy(replicate_top=8)))
    srv = {d: SpatialServer(parts, mbrs, config, device=d)
           for d in ("cpu", "cuda")}
    rng = np.random.default_rng(13)
    qb = _boxes(rng, 40, 0.03).numpy()
    pts = rng.random((40, 2)).astype(np.float32)
    for kind, q, params in (("range_counts", qb, ()),
                            ("range_ids", qb, (64,)),
                            ("knn", pts, (5, 256))):
        reqs = [frontend.Request(kind, q[i], params) for i in range(40)]
        for width in (64, 128):
            got = {d: frontend.execute_batch(
                s, frontend.Batch(kind, params, reqs, width, 0.0))
                for d, s in srv.items()}
            if kind == "range_counts":
                want = srv["cuda"].range_counts(torch.from_numpy(q).cuda())[0]
                assert got["cuda"] == got["cpu"] == want.cpu().tolist()
                continue
            if kind == "range_ids":
                want = srv["cuda"].range_ids(torch.from_numpy(q).cuda(),
                                             max_hits=params[0])[:3]
            else:
                want = srv["cuda"].knn(torch.from_numpy(q).cuda(), params[0],
                                       max_cand=params[1])[:3]
            for i in range(40):
                for a, b, w in zip(got["cuda"][i], got["cpu"][i],
                                   (x[i] for x in want)):
                    assert not isinstance(a, torch.Tensor)
                    np.testing.assert_array_equal(np.asarray(a),
                                                  w.cpu().numpy())
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))


def test_two_gloo_ranks_on_the_card_match_the_simulation(tmp_path):
    """The mesh mode on the one card: two spawned CUDA ranks over gloo
    (NCCL refuses two ranks on one device) serve sharded counts, ids
    and kNN equal to the in-process simulation of two owners, each rank
    holding one shard."""
    _need_cuda()
    import pickle

    import torch_mesh_ranks as tm
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.spawn(tm.cuda_main, (2, str(tmp_path)), 2, 300.0)
    want = tm.cuda_answers(None, 2)
    assert want["rows"] == 2
    for r in range(2):
        with open(tmp_path / f"cuda{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["rows"] == 1 and got["timers"]["calls"] > 0
        np.testing.assert_array_equal(got["counts"], want["counts"])
        for a, b in zip(got["ids"] + got["knn"], want["ids"] + want["knn"]):
            np.testing.assert_array_equal(a, b)
