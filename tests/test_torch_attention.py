"""repro_torch's attention layers against repro's on shared numpy inputs:
``rope``, ``chunked_attention`` (causal and bidirectional, window,
softcap, ``q_offset``, GQA, key counts that are not a multiple of the
chunk), ``decode_attention`` past a ring wrap, ``gated_mlp``; and the
reference's windowed-attention fault.

The fault: repro's ``chunked_attention`` carries ``m = -inf`` into a
query's first key chunk, and when that whole chunk lies outside the
query's window (``q_pos >= window + chunk - 1``), ``exp(m - m_new)`` is
``exp(-inf - -inf)``: NaN, which the next layer's ``p @ v`` spreads to
every query.  The port stands 0 in for a ``-inf`` running max, so a
chunk outside the window adds exactly 0: its output is finite, equals a
float64 dense masked softmax within 1e-5, and equals repro's wherever
repro's is finite.

Tolerances: float32 within 1e-5 at the layer (float32 sums in another
order; measured below 1e-6), 1e-4 on logits
(``tests/test_models_smoke.py``'s); bf16 within one bf16 ulp of the
output's scale (both sides round the same float32 values once), two for
``gated_mlp`` (repro rounds its silu's steps, torch the silu once)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import convert, layers, lm

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(a, dtype):
    """numpy float32 -> (jax array, torch tensor) of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(got, want, dtype, tol=F32, ulps=1):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":     # ``ulps`` bf16 ulps at the output's scale
        tol = dict(rtol=0, atol=ulps * 2 ** -7 * max(
            1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (17, 500.0)])
def test_rope_matches_repro(dtype, hd, theta):
    jx, tx = _pair(_np((2, 30, 3, hd), 0), dtype)
    pos = np.random.default_rng(1).integers(0, 5000, (2, 30))
    want = jlayers.rope(jx, jnp.asarray(pos), theta)
    got = layers.rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    # an odd head's last lane passes unrotated
    if hd % 2:
        assert torch.equal(got[..., -1], tx[..., -1])


# name -> (sq, sk, h, kv, kwargs).  Every case is finite in repro: a
# windowed case keeps q_pos <= window + chunk - 2, so each query's first
# chunk holds a key of its window (past that, repro is NaN: below)
CASES = {
    "causal": (40, 40, 4, 4, dict()),
    "causal_gqa_chunks": (70, 70, 4, 2, dict(chunk=16)),
    "bidirectional_pad": (33, 45, 4, 1, dict(causal=False, chunk=16)),
    "window": (50, 50, 4, 2, dict(window=20, chunk=32, q_block=16)),
    "softcap": (40, 40, 4, 4, dict(softcap=3.0)),
    "window_softcap_gqa": (64, 64, 8, 2, dict(window=40, softcap=5.0,
                                              chunk=32, q_block=24)),
    "q_offset": (9, 41, 4, 2, dict(q_offset=32, chunk=16)),
    "q_offset_window": (9, 41, 4, 2, dict(q_offset=32, window=30,
                                          chunk=16)),
    "keys_past_chunk": (700, 700, 2, 1, dict()),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attention_matches_repro(case, dtype, monkeypatch):
    sq, sk, h, kv, kw = CASES[case]
    kw = dict(kw)
    monkeypatch.setattr(layers, "Q_BLOCK", kw.pop("q_block", layers.Q_BLOCK))
    jq, tq = _pair(_np((2, sq, h, 16), 0), dtype)
    jk, tk = _pair(_np((2, sk, kv, 16), 1), dtype)
    jv, tv = _pair(_np((2, sk, kv, 16), 2), dtype)
    want = jlayers.chunked_attention(jq, jk, jv, **kw)
    assert bool(jnp.isfinite(want.astype(jnp.float32)).all())
    got = layers.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("kw", [dict(window=9), dict(causal=False),
                                dict(window=30, q_offset=5), dict()])
def test_query_blocks_skip_only_masked_chunks(kw, monkeypatch):
    """Blocking the queries and skipping the chunks a block cannot see
    gives the same output as one block over every chunk."""
    q = torch.from_numpy(_np((1, 100, 4, 8), 3))
    k = torch.from_numpy(_np((1, 105, 2, 8), 4))
    v = torch.from_numpy(_np((1, 105, 2, 8), 5))
    monkeypatch.setattr(layers, "Q_BLOCK", 1000)
    whole = layers.chunked_attention(q, k, v, chunk=8, **kw)
    for qb in (1, 7, 16, 33):
        monkeypatch.setattr(layers, "Q_BLOCK", qb)
        got = layers.chunked_attention(q, k, v, chunk=8, **kw)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [5, 8, 13, 21])
def test_decode_attention_past_a_ring_wrap_matches_repro(length, dtype):
    """A ring of W = 8 slots after ``length`` writes: the slots below
    min(length, W) are valid, whatever order the wrap left them in."""
    jq, tq = _pair(_np((3, 1, 4, 16), 6), dtype)
    jk, tk = _pair(_np((3, 8, 2, 16), 7), dtype)
    jv, tv = _pair(_np((3, 8, 2, 16), 8), dtype)
    for softcap in (None, 4.0):
        want = jlayers.decode_attention(jq, jk, jv, length, softcap=softcap)
        got = layers.decode_attention(tq, tk, tv, length, softcap=softcap)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches_repro(act, dtype):
    jx, tx = _pair(_np((2, 9, 32), 9), dtype)
    ws = [_pair(_np(s, 10 + i) * 0.2, dtype)
          for i, s in enumerate([(32, 48), (32, 48), (48, 32)])]
    want = jlayers.gated_mlp(jx, *[w[0] for w in ws], act)
    got = layers.gated_mlp(tx, *[w[1] for w in ws], act)
    assert got.dtype == tx.dtype
    # bf16: repro's compiled silu rounds each of its steps to bf16, torch's
    # rounds once, so the product of the gates may differ by an ulp before
    # the last product (measured: 2 ulps at the output's scale)
    _close(got, want, dtype, tol=dict(rtol=1e-5, atol=1e-6), ulps=2)


def _dense64(q, k, v, *, causal=True, window=None, softcap=None,
             q_offset=0):
    """float64 masked softmax over all keys at once (GQA by repeat)."""
    q, k, v = (a.double() for a in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_offset + torch.arange(q.shape[1])[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    valid = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        valid &= qp >= kp
    if window is not None:
        valid &= qp - kp < window
    s = torch.where(valid, s, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("kw", [dict(window=32), dict(window=32, softcap=20.0),
                                dict(window=100, q_offset=9)])
def test_reference_windowed_attention_is_nan_past_window_plus_chunk(kw):
    """L = 600 at the smoke window 32 and the reference's 512-key chunk:
    repro is NaN from q_pos = window + 511 on; the port is finite, equals
    float64 dense attention within 1e-5 and repro where repro is
    finite."""
    L = 600
    q, k, v = (_np((1, L, 4, 16), 20 + i) if i == 0 else
               _np((1, L, 2, 16), 20 + i) for i in range(3))
    jkw = dict(kw)
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    first_nan = kw["window"] + 511 - kw.get("q_offset", 0)
    nan_rows = np.isnan(want).any(axis=(0, 2, 3))
    assert nan_rows[first_nan:].all() and not nan_rows[:first_nan].any()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = layers.chunked_attention(tq, tk, tv, **kw)
    assert bool(torch.isfinite(got).all())
    dense = _dense64(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32)
    np.testing.assert_allclose(got.numpy()[:, :first_nan],
                               want[:, :first_nan], **F32)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "gemma2_27b",
                                  "mixtral_8x22b"])
def test_reference_lm_is_nan_at_600_tokens_and_the_port_is_not(arch):
    """repro's float32 forward at the smoke config (window 32) is NaN at
    every position of a 600-token prompt (one NaN query row spreads
    through the next layer's attention); at 500 tokens it is finite and
    the port equals it within 1e-4; at 600 the port is finite."""
    cfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    p = jlm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 600)
                                             ).astype(np.int32)
    fwd = jax.jit(lambda pp, t: jlm.forward(pp, t, cfg, remat="none")[0])
    want = fwd(p, jnp.asarray(toks))
    assert bool(jnp.isnan(want).all())
    got, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
    assert bool(torch.isfinite(got).all())
    short = toks[:, :500]
    want = fwd(p, jnp.asarray(short))
    got, _ = lm.forward(tp, torch.from_numpy(short), tcfg)
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                               np.asarray(want)[..., :cfg.vocab],
                               rtol=1e-4, atol=1e-4)
