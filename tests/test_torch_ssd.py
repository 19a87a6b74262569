"""repro_torch's SSD block against repro's on the same numpy inputs: the
flat intra-chunk contract (repro's Pallas kernel in interpret mode),
the kernel's grouped plain version, ``ssd_forward`` (repro's kernel and
einsum paths, and the sequential oracle), and the Mamba2 mixer's
``forward`` and ``decode_step``.

Tolerances are the reference's own (``tests/test_kernels_ssd.py``):
2e-5 for the intra-chunk block against its oracle, 1e-5 between the
kernel and einsum paths, 2e-4 against the sequential scan; float32 sums
run in another order in torch than in XLA.  The mixer is held at 1e-4
in float32 (the model tests' tolerance); its softplus is torch's, which
returns x above 20 where jax's ``logaddexp(x, 0)`` adds exp(-x), a
relative difference below 2.1e-9, far inside it."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd import kernel as jkernel
from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels.ssd import kernel, ops, ref
from repro_torch.models import ssm

torch.set_num_threads(1)


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _inputs(seed, b, l, h, p, g, s):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)) * 0.5
    dt = _softplus(rng.standard_normal((b, l, h))) * 0.1
    a_log = -np.exp(rng.standard_normal(h) * 0.3)
    bm = rng.standard_normal((b, l, g, s)) * 0.3
    cm = rng.standard_normal((b, l, g, s)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, a_log, bm, cm)]


def _flat_inputs(seed, inst, q, p, s):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((inst, q, p))
    dt = _softplus(rng.standard_normal((inst, q))) * 0.1
    cl = np.cumsum(-dt * 0.5, axis=1)
    b = rng.standard_normal((inst, q, s)) * 0.3
    c = rng.standard_normal((inst, q, s)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, cl, b, c)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("q,p,s", [(128, 64, 128), (128, 32, 64),
                                   (64, 16, 32)])
def test_intra_chunk_ref_matches_repro_kernel(q, p, s):
    args = _flat_inputs(q + p, 6, q, p, s)
    want = np.asarray(jkernel.intra_chunk_pallas(*_j(*args), interpret=True))
    np.testing.assert_allclose(np.asarray(jref.intra_chunk_ref(*_j(*args))),
                               want, rtol=2e-5, atol=2e-5)
    got = ref.intra_chunk_ref(*_t(*args))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,g", [(4, 1), (4, 2), (6, 3)])
@pytest.mark.parametrize("chunk,l", [(128, 256), (64, 192)])
def test_grouped_plain_version_equals_flat_contract(h, g, chunk, l):
    """The kernel's grouped signature, against the flat contract after
    the reference's repeat and moveaxis (ops.py:72-101)."""
    b, p, s = 2, 16, 32
    x, dt, a_log, bm, cm = _t(*_inputs(h * g + l, b, l, h, p, g, s))
    nc = l // chunk
    cl = torch.cumsum((dt * a_log).reshape(b, nc, chunk, h), 2)
    got = ref.intra_chunk_grouped(x, dt, cl.reshape(b, l, h), bm, cm, chunk)

    def flat(t, feat):
        return t.reshape(b, nc, chunk, h, *feat).movedim(3, 1).reshape(
            b * h * nc, chunk, *feat)

    rep = h // g
    want = ref.intra_chunk_ref(
        flat(x, (p,)), flat(dt, ()), flat(cl, ()),
        flat(bm.repeat_interleave(rep, 2), (s,)),
        flat(cm.repeat_interleave(rep, 2), (s,)))
    want = want.reshape(b, h, nc, chunk, p).movedim(1, 3).reshape(b, l, h, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("l,chunk", [(256, 128), (384, 128), (128, 64)])
def test_ssd_forward_matches_repro_and_the_scan(l, chunk):
    b, h, p, g, s = 2, 4, 32, 2, 64
    args = _inputs(0, b, l, h, p, g, s)
    got = ops.ssd_forward(*_t(*args), chunk=chunk).numpy()
    for jk in (True, False):
        want = np.asarray(jops.ssd_forward(*_j(*args), chunk=chunk,
                                           use_kernel=jk))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x, dt, a_log, bm, cm = _t(*args)
    rep = h // g
    for bi in range(b):
        for hi in range(h):
            yo, _ = ref.ssd_scan_ref(x[bi, :, hi], dt[bi, :, hi], a_log[hi],
                                     bm[bi, :, hi // rep],
                                     cm[bi, :, hi // rep])
            np.testing.assert_allclose(got[bi, :, hi], yo.numpy(),
                                       rtol=2e-4, atol=2e-4)


def test_ssd_scan_ref_matches_repro():
    x, dt, a_log, bm, cm = _inputs(3, 1, 64, 1, 16, 1, 32)
    args = (x[0, :, 0], dt[0, :, 0], a_log[0], bm[0, :, 0], cm[0, :, 0])
    want_y, want_h = jref.ssd_scan_ref(*_j(*args))
    got_y, got_h = ref.ssd_scan_ref(*_t(*args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)


def test_ssd_forward_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    """``ssd_forward`` picks its route by the tensors' device alone: CPU
    tensors reach ``ref.intra_chunk_grouped`` and never the kernel."""
    args = _t(*_inputs(2, 1, 256, 2, 16, 1, 32))
    want = ops.ssd_forward(*args)
    calls = []
    grouped = ref.intra_chunk_grouped

    def kernel_called(*a, **k):
        raise AssertionError("the kernel route took CPU tensors")

    def plain(*a, **k):
        calls.append(1)
        return grouped(*a, **k)

    monkeypatch.setattr(kernel, "intra_chunk", kernel_called)
    monkeypatch.setattr(ref, "intra_chunk_grouped", plain)
    np.testing.assert_array_equal(ops.ssd_forward(*args).numpy(),
                                  want.numpy())
    assert calls == [1]


def test_kernel_route_refuses_cpu_tensors_and_gradients():
    """The CUDA kernel's wrapper refuses a CPU tensor rather than send it
    to the plain version; a direct launch with inputs that require grad
    raises, because the launch is invisible to autograd, and names the
    differentiable route."""
    args = _t(*_inputs(1, 1, 128, 2, 16, 1, 32))
    x, dt, a_log, bm, cm = args
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ops.ssd_forward.*IntraChunk"):
        kernel.intra_chunk(x, dt, dt, bm, cm, 128)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda"):
        kernel.intra_chunk(x, dt, dt, bm, cm, 128)
    with pytest.raises(ValueError, match="chunk-padded"):
        ops.ssd_forward(x[:, :100], dt[:, :100], a_log, bm[:, :100],
                        cm[:, :100])


def test_heads_per_block_keeps_the_grid_full():
    # 132 resident blocks: one a block an SM of an H100 SXM at Q = S = 128
    # (the FFMA design); the tensor-core design holds two an SM, 264
    assert kernel.heads_per_block(1024, 64, 132) == 64  # Mamba2 prefill
    assert kernel.heads_per_block(1024, 64, 264) == 64
    assert kernel.heads_per_block(4, 64, 132) == 1
    assert kernel.heads_per_block(16, 64, 132) == 4     # 16 x 16 >= 132
    assert kernel.heads_per_block(16, 64, 264) == 2     # 16 x 32 >= 264
    assert kernel.heads_per_block(2, 3, 132) == 3       # odd: not split


def _tf32(v):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from
    zero, on the float32 bit pattern."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b):
    """The kernel's tensor-core product a @ b: each factor split as hi =
    tf32(v), lo = tf32(v - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi
    summed in float32 (a product of two TF32 values is exact in float32);
    ``terms=1`` would be a_hi b_hi, plain TF32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _intra_chunk_tf32(x, dt, cl, b, c, three=True):
    """The intra-chunk block with both products as the kernel forms them
    (flat (I, Q, .) contract): G = C . B^T and Y = M . X in three TF32
    terms, or in one (plain TF32) if not ``three``."""
    mm = _mm_tf32x3 if three else (lambda u, v: _tf32(u) @ _tf32(v))
    g = mm(c, b.transpose(1, 2))
    return mm(ref._masked(g, cl, dt), x)


def _layer0_scale(seed, inst, q, p, s):
    """Magnitudes of Mamba2-1.3B's layer-0 SSD inputs at prefill on the
    card (random weights, bf16 activations; chip_smoke.py's lm_check
    reports them): x, B and C of standard deviation about 0.018, dt about
    0.47 (up to 4.4), cl down to about -126 within a chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((inst, q, p)) * 0.018
    dt = _softplus(rng.standard_normal((inst, q))) * 0.5
    cl = np.cumsum(-dt * np.exp(rng.standard_normal((inst, 1)) * 0.7),
                   axis=1)
    b = rng.standard_normal((inst, q, s)) * 0.018
    c = rng.standard_normal((inst, q, s)) * 0.018
    return [a.astype(np.float32) for a in (x, dt, cl, b, c)]


@pytest.mark.parametrize("scale", ["reference", "layer0"])
@pytest.mark.parametrize("q,p,s", [(128, 64, 128), (64, 16, 32)])
def test_three_term_tf32_product_holds_the_kernel_tolerance(scale, q, p, s):
    """The tensor-core kernel's arithmetic, modelled in plain torch: both
    products in three TF32 terms stay within the reference's 2e-5 of the
    float32 plain version, on tests/test_kernels_ssd.py's distributions
    and at layer-0 magnitudes (where the error is also held relative to
    the output's own scale); one term (plain TF32) is not within 2e-5
    on the reference's distributions."""
    draw = _flat_inputs if scale == "reference" else _layer0_scale
    x, dt, cl, b, c = _t(*draw(q + s, 8, q, p, s))
    want = ref.intra_chunk_ref(x, dt, cl, b, c)
    got = _intra_chunk_tf32(x, dt, cl, b, c)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 2e-5
    if scale == "reference":
        one = _intra_chunk_tf32(x, dt, cl, b, c, three=False)
        assert not torch.allclose(one, want, rtol=2e-5, atol=2e-5)


def test_tf32_rounding_is_round_to_nearest_away():
    v = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11,
                      -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 1.0 - 2.0**-24],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9,
                         -(1.0 + 2.0**-10), 1.0, 1.0], dtype=torch.float32)
    assert torch.equal(_tf32(v), want)


def _mixer_params(cfg, seed):
    p = jssm.init_params(jax.random.PRNGKey(seed), cfg, 1)
    rng = np.random.default_rng(seed)
    # non-trivial a_log, dt_bias, d_skip and gnorm (repro inits constants)
    p = dict(p, **{k: jnp.asarray(rng.standard_normal(p[k].shape)
                                  .astype(np.float32) * 0.3)
                   for k in ("a_log", "dt_bias", "d_skip", "gnorm")})
    one = {k: np.asarray(v[0]) for k, v in p.items()}
    return one, ssm.Mixer({k: torch.from_numpy(v.copy())
                           for k, v in one.items()})


@pytest.mark.parametrize("l", [40, 128, 200])
def test_ssm_forward_and_decode_match_repro(l):
    """float32: the chunked prefill (L = 40 and 200 run the pad to a
    multiple of 128) and up to 48 decode steps through the recurrence,
    against repro's; the port updates the decode state in place."""
    cfg = dataclasses.replace(jconfigs.smoke("mamba2_1p3b"), dtype="float32")
    tcfg = dataclasses.replace(configs.smoke("mamba2_1p3b"), dtype="float32")
    jp, tp = _mixer_params(cfg, l)
    x = (np.random.default_rng(l).standard_normal((2, l, cfg.d_model))
         * 0.5).astype(np.float32)
    want = np.asarray(jssm.forward(jnp.asarray(x), jp, cfg))
    got = ssm.forward(torch.from_numpy(x), tp, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    jcache = jssm.init_cache(cfg, 2, jnp.float32)
    tcache = ssm.init_cache(tcfg, 2, torch.float32, "cpu")
    state = tcache["state"]
    jstep = jax.jit(lambda xx, c: jssm.decode_step(xx, c, jp, cfg))
    for t in range(min(l, 48)):
        jy, jcache = jstep(jnp.asarray(x[:, t:t + 1]), jcache)
        ty, tcache = ssm.decode_step(torch.from_numpy(x[:, t:t + 1]),
                                     tcache, tp, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ty.numpy()[:, 0], got[:, t],
                                   rtol=1e-4, atol=1e-4)
    assert tcache["state"] is state
    np.testing.assert_allclose(state.numpy(), np.asarray(jcache["state"]),
                               rtol=1e-4, atol=1e-4)
