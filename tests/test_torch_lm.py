"""repro_torch's Mamba2 LM against repro's, at the smoke config (2
layers, d_model 64, state 32), with the same weights: repro's
``lm.init_params(PRNGKey(0))`` carried across by
``convert.params_from_numpy``, tokens drawn with numpy.

Tolerances: float32 logits within 1e-4 (``tests/test_models_smoke.py``'s
decode-vs-teacher-forcing tolerance).  bf16 logits within 3e-2 absolute:
both sides round every elementwise op to bf16, but not at the same
places (repro's compiled silu rounds each of its steps and leaves ``y *
silu(z)`` unrounded into the norm; torch's rounds once), and float32
sums in other orders put a few values on the other side of a bf16
rounding boundary, so single logits of magnitude 1-2 differ by one bf16
ulp (7.8e-3); greedy tokens must agree wherever the top-two margin
exceeds that tolerance.  Configs and parameter counts are compared
exactly."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, convert, lm

torch.set_num_threads(1)
ARCH = "mamba2_1p3b"
BF16_ATOL = 3e-2


def _cfgs(dtype):
    return (dataclasses.replace(jconfigs.smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.smoke(ARCH), dtype=dtype))


def _params(cfg, tcfg):
    p = jlm.init_params(jax.random.PRNGKey(0), cfg)
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg,
                                        "cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_repro(arch):
    for fn in ("get", "smoke"):
        want = getattr(jconfigs, fn)(arch)
        got = getattr(configs, fn)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.hd, got.vocab_padded, got.pattern, got.ssm_heads,
                got.n_params(), got.n_active_params()) == (
            want.hd, want.vocab_padded, want.pattern, want.ssm_heads,
            want.n_params(), want.n_active_params())
    assert configs.ALIASES == jconfigs.ALIASES
    assert configs.ARCHS == jconfigs.ARCHS


def test_mamba2_published_size():
    cfg = configs.get("mamba2-1.3b")
    assert cfg.n_params() == 1_342_390_272
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_state,
            cfg.vocab_padded) == (48, 2048, 64, 128, 50_432)


def test_params_from_numpy_names_every_tensor_after_repro():
    cfg, tcfg = _cfgs("float32")
    p, tp = _params(cfg, tcfg)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        keys = [k.key for k in path]
        if keys[0] == "blocks":        # stacked over layers
            for i in range(leaf.shape[0]):
                want[".".join(["blocks", str(i)] + keys[2:])] = leaf[i]
        else:
            want[".".join(keys)] = leaf
    got = dict(tp.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert not got[k].requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,s", [("all", 40), ("last", 40),
                                    ("all", 130)])
def test_forward_matches_repro(dtype, mode, s):
    cfg, tcfg = _cfgs(dtype)
    p, tp = _params(cfg, tcfg)
    toks = _tokens(cfg, 2, s)
    want, _ = jlm.forward(p, jnp.asarray(toks), cfg, remat="none",
                          logits_mode=mode)
    got, aux = lm.forward(tp, torch.from_numpy(toks), tcfg, logits_mode=mode)
    assert aux == {}
    assert got.dtype == torch.float32
    assert got.shape == (2, s if mode == "all" else 1, cfg.vocab_padded)
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(got[..., cfg.vocab:], -1e9)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(
        rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(got[..., :cfg.vocab], want[..., :cfg.vocab],
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_teacher_forcing_and_repro(dtype):
    """As tests/test_models_smoke.py: 40 decode steps through the
    recurrence equal the teacher-forced forward through the chunked SSD,
    and repro's decode step."""
    cfg, tcfg = _cfgs(dtype)
    p, tp = _params(cfg, tcfg)
    b, s = 2, 40
    toks = _tokens(cfg, b, s)
    tf, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
    jcache = jlm.init_cache(cfg, b, s)
    cache = lm.init_cache(tcfg, b, s, "cpu")
    jstep = jax.jit(lambda pp, c, t, pos: jlm.decode_step(pp, c, t, pos, cfg))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(
        rtol=0, atol=BF16_ATOL)
    for pos in range(s):
        jl, jcache = jstep(p, jcache, jnp.asarray(toks[:, pos]), pos)
        logits, cache = lm.decode_step(tp, cache, torch.from_numpy(
            toks[:, pos]), pos, tcfg)
        np.testing.assert_allclose(logits.numpy(), tf[:, pos].numpy(), **tol)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)


def _agree_where_decided(got, want, logits):
    """Greedy tokens equal wherever the reference's top-two margin
    exceeds the bf16 tolerance."""
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * BF16_ATOL
    np.testing.assert_array_equal(np.asarray(got)[decided],
                                  np.asarray(want)[decided])
    return int(decided.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_serve_steps_give_repro_tokens(dtype):
    cfg, tcfg = _cfgs(dtype)
    p, tp = _params(cfg, tcfg)
    model, jmodel = api.build(tcfg, "cpu"), japi.build(cfg)
    toks = _tokens(cfg, 4, 24, seed=5)
    want = japi.make_prefill_step(jmodel)(p, {"tokens": jnp.asarray(toks)})
    got = api.make_prefill_step(model)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (4, cfg.vocab_padded)
    assert _agree_where_decided(got.argmax(-1).numpy(),
                                np.asarray(want).argmax(-1), want) >= 3

    jserve = jax.jit(japi.make_serve_step(jmodel))
    jcache = jmodel.init_cache(4, 24)
    jtok = jnp.asarray(toks[:, 0])
    jout = []
    for pos in range(23):
        nxt, jcache = jserve(p, jcache, jtok, pos)
        jtok = jnp.where(pos + 1 < 8, jnp.asarray(toks[:, pos + 1]), nxt)
        if pos + 1 >= 8:
            jout.append(np.asarray(nxt))
    got = serve.generate(model, tp, torch.from_numpy(toks[:, :8]), 16)
    assert got.dtype == torch.int32 and got.shape == (4, 16)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.stack(jout, 1))
    else:   # a flipped near-tie changes every later token: first 4 only
        np.testing.assert_array_equal(got.numpy()[:, :4],
                                      np.stack(jout, 1)[:, :4])


def test_unported_features_raise_naming_their_item():
    for arch in ("gemma2_27b", "whisper_medium", "recurrentgemma_9b",
                 "mixtral_8x22b", "internvl2_26b"):
        with pytest.raises(NotImplementedError, match="14c"):
            api.build(configs.smoke(arch), "cpu")
    cfg, tcfg = _cfgs("float32")
    _, tp = _params(cfg, tcfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 8))
    for remat in ("full", "dots"):
        with pytest.raises(NotImplementedError, match="14b"):
            lm.forward(tp, toks, tcfg, remat=remat)
    with pytest.raises(NotImplementedError, match="14c"):
        lm.forward(tp, toks, tcfg, img=torch.zeros(1, 2, 3))
    model = api.build(tcfg, "cpu")
    for fn in (lambda: api.init_train_state(model, None, None),
               lambda: api.make_train_step(model, None),
               lambda: model.loss_fn(tp, {"tokens": toks})):
        with pytest.raises(NotImplementedError, match="14b"):
            fn()
    from repro_torch.models import blocks
    with pytest.raises(NotImplementedError, match="14c"):
        blocks.block_init(torch.Generator().manual_seed(0), tcfg, "full")


def test_random_init_is_seeded_and_shaped():
    _, tcfg = _cfgs("float32")
    model = api.build(tcfg, "cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.named_parameters(), b.named_parameters()):
        assert ka == kb and torch.equal(va, vb)
    assert a.embed.shape == (tcfg.vocab_padded, tcfg.d_model)
    assert abs(float(a.embed.std()) - 0.02) < 1e-3
    assert len(a.blocks) == tcfg.n_layers


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "device=cpu" in out
