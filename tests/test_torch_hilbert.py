"""repro_torch's Hilbert encode against repro's on the same numpy
inputs: ``xy2d``, ``quantize``, ``hilbert_keys`` (core) and the kernel
package's ``ops.encode`` / ``ops.hilbert_keys`` (repro's Pallas kernel
in interpret mode), for orders 4, 8 and 16; the order-4 grid is a
bijection; points on the universe's edges.  ``_encode_model`` repeats
the CUDA kernel's arithmetic for orders 1-16 word for word (every bit
plane at once, ``csrc/hilbert.cu`` ``encode_two``) and is held to
repro on every point of the grid for orders 1-10 and on 2^20 seeded
order-16 points with the extreme values on each axis.  Tolerance:
exact equality (the port's int64 keys hold repro's uint32 values)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hilbert as jh
from repro.kernels.hilbert import ops as jops
from repro_torch.core import hilbert as th
from repro_torch.kernels.hilbert import kernel as tkernel
from repro_torch.kernels.hilbert import ops as tops

torch.set_num_threads(1)


def _pts(n, seed):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 2)) * 3 - 1).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    return pts, np.concatenate([lo, hi]).astype(np.float32)


M32 = 0xFFFFFFFF


def _gf4_mul(a0, a1, b0, b1):
    return (a0 & b0) ^ (a1 & b1), (a0 & b1) ^ (a1 & (b0 ^ b1))


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte i of the result is byte
    ``(sel >> 4i) & 7`` of x's four bytes then y's."""
    out = torch.zeros_like(x)
    for i in range(4):
        j = (sel >> (4 * i)) & 7
        out |= (((x if j < 4 else y) >> (8 * (j & 3))) & 0xFF) << (8 * i)
    return out


def _interleave(w):
    for shift, mask in ((4, 0x00F000F0), (2, 0x0C0C0C0C), (1, 0x22222222)):
        t = (w ^ (w >> shift)) & mask
        w = w ^ t ^ (t << shift)
    return w


def _encode_model(gx, gy, order):
    """The encode kernel's arithmetic for orders 1-16, on int64 tensors
    holding its uint32 words: points in pairs, the first of a pair in
    each word's low half (an odd last point paired with 0, as the
    kernel's tail), an inclusive GF(4) scan over the bit planes in four
    rounds, then the digits' bits interleaved."""
    assert 1 <= order <= 16
    n = gx.shape[0]
    x, y = gx.long() & M32, gy.long() & M32
    if n % 2:
        x, y = (torch.cat([v, v.new_zeros(1)]) for v in (x, y))
    plane = (1 << order) - 1
    lo = plane | (plane << 16)
    x = _byte_perm(x[0::2], x[1::2], 0x5410) & lo
    y = _byte_perm(y[0::2], y[1::2], 0x5410) & lo
    a = x ^ y
    m0, m1 = ~a & lo, a
    k0, k1 = ~y & lo, a & x
    for r in range(4):
        s = 1 << r
        keep = ~(((1 << s) - 1) << (16 - s)) & M32
        a0, a1 = m0 & keep, m1 & keep
        c0, c1 = k0 >> s, k1 >> s
        if r == 0:
            c0 = c0 ^ c1
        n0, n1 = _gf4_mul(a0, a1, c0, c1)
        k0, k1 = k0 ^ n0, k1 ^ n1
        if r < 3:
            b0, b1 = m0 >> s, m1 >> s
            if r == 0:
                b0 = b0 ^ b1
            m0, m1 = _gf4_mul(a0, a1, b0, b1)
    keep1 = ~(1 << 15) & M32
    sigma, kappa = (k0 >> 1) & keep1, (k1 >> 1) & keep1
    h = x ^ (sigma & a) ^ kappa
    d = torch.stack([_interleave(_byte_perm(a, h, 0x5140)),
                     _interleave(_byte_perm(a, h, 0x7362))], 1)
    return d.reshape(-1)[:n]


def _grid(n, order, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**order, (2, n)).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 100, 1024, 4097])
@pytest.mark.parametrize("order", [4, 8, 16])
def test_xy2d_and_encode_match_repro(order, n):
    gx, gy = _grid(n, order, order * 7 + n)
    want = np.asarray(jh.xy2d(jnp.asarray(gx), jnp.asarray(gy), order))
    want_k = np.asarray(jops.encode(jnp.asarray(gx), jnp.asarray(gy), order))
    np.testing.assert_array_equal(want_k, want)
    tx, ty = torch.from_numpy(gx.astype(np.int32)), torch.from_numpy(
        gy.astype(np.int32))
    for got in (th.xy2d(tx, ty, order), tops.encode(tx, ty, order)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 100, 1024, 4097])
@pytest.mark.parametrize("order", [4, 8, 16])
def test_quantize_and_keys_match_repro(order, n):
    pts, bounds = _pts(n, order + n)
    jp, jb = jnp.asarray(pts), jnp.asarray(bounds)
    tp, tb = torch.from_numpy(pts), torch.from_numpy(bounds)
    for want, got in zip(jh.quantize(jp, jb, order),
                         th.quantize(tp, tb, order)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(jh.hilbert_keys(jp, jb, order)).astype(np.int64)
    np.testing.assert_array_equal(
        np.asarray(jops.hilbert_keys(jp, jb, order)).astype(np.int64), want)
    for got in (th.hilbert_keys(tp, tb, order),
                tops.hilbert_keys(tp, tb, order)):
        np.testing.assert_array_equal(got.numpy(), want)


def _model_matches_repro(gx, gy, order):
    want = np.asarray(jops.encode(jnp.asarray(gx), jnp.asarray(gy), order))
    np.testing.assert_array_equal(
        np.asarray(jh.xy2d(jnp.asarray(gx), jnp.asarray(gy), order)), want)
    tx, ty = (torch.from_numpy(v.astype(np.int32)) for v in (gx, gy))
    got = _encode_model(tx, ty, order)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(th.xy2d(tx, ty, order).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("order", range(1, 11))
def test_encode_model_matches_repro_on_every_grid_point(order):
    side = np.arange(2**order, dtype=np.uint32)
    gx, gy = (g.ravel() for g in np.meshgrid(side, side))
    _model_matches_repro(gx, gy, order)
    _model_matches_repro(gx[:-1], gy[:-1], order)      # an odd tail


def test_encode_model_matches_repro_at_order_16():
    """2^20 seeded points, then 0 and 2^16 - 1 on each axis against
    random, extreme and each other's values (the odd count leaves a
    tail)."""
    gx, gy = _grid(1 << 20, 16, 16)
    ends = np.array([0, 2**16 - 1], np.uint32)
    rnd = _grid(8, 16, 17)[0]
    ex = np.concatenate([np.repeat(ends, 10), np.tile(rnd, 2), ends, ends])
    ey = np.concatenate([np.tile(np.concatenate([rnd, ends]), 2),
                         np.repeat(ends, 8), ends, ends[::-1]])
    _model_matches_repro(np.concatenate([gx, ex, [2**16 - 1]]),
                         np.concatenate([gy, ey, [0]]), 16)


def test_order4_grid_is_a_bijection_and_matches_repro():
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(-1, 2)
    got = th.xy2d(torch.from_numpy(g[:, 0]), torch.from_numpy(g[:, 1]), 4)
    assert sorted(got.tolist()) == list(range(256))
    want = jh.xy2d(jnp.asarray(g[:, 0]), jnp.asarray(g[:, 1]), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_points_on_the_universe_edges():
    """Corners, edge midpoints, points outside the box (clamped; a
    negative grid value saturates to 0 as XLA's conversion does) and
    the sentinel centre (0, 0) of a universe that excludes it."""
    bounds = np.array([0.25, -1.0, 2.0, 3.5], np.float32)
    pts = np.array([[0.25, -1.0], [2.0, 3.5], [0.25, 3.5], [2.0, -1.0],
                    [1.125, -1.0], [0.25, 1.25], [0.0, 0.0], [5.0, 9.0],
                    [np.nextafter(np.float32(2.0), np.float32(0)), 3.5]],
                   np.float32)
    for order in (4, 16):
        want = np.asarray(jops.hilbert_keys(jnp.asarray(pts),
                                            jnp.asarray(bounds), order))
        got = tops.hilbert_keys(torch.from_numpy(pts),
                                torch.from_numpy(bounds), order)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        gx, gy = th.quantize(torch.from_numpy(pts), torch.from_numpy(bounds),
                             order)
        assert int(gx.max()) == 2**order - 1 and int(gx.min()) == 0


def test_keys_sort_as_unsigned():
    """Keys at and above 2**31 (uint32 values past int32) stay positive
    int64, so a torch sort orders them as the reference's uint32."""
    gx = torch.tensor([65535, 0, 65535, 32768], dtype=torch.int32)
    gy = torch.tensor([0, 65535, 65535, 0], dtype=torch.int32)
    keys = th.xy2d(gx, gy, 16)
    want = np.asarray(jh.xy2d(jnp.asarray(gx.numpy()),
                              jnp.asarray(gy.numpy()), 16))
    np.testing.assert_array_equal(keys.numpy(), want.astype(np.int64))
    assert int(keys.max()) >= 2**31
    np.testing.assert_array_equal(torch.sort(keys).indices.numpy(),
                                  np.argsort(want, kind="stable"))


def test_kernel_wrapper_needs_cuda_tensors():
    """On a CPU tensor the wrapper refuses; ``ops`` is what dispatches."""
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        tkernel.encode(x, x, 16)
